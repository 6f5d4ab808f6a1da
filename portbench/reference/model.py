"""The paper's IPN autoencoder in plain PyTorch: the forward, the losses and
the DEC head, over a dict of tensors under the reference torch model's
state-dict names (Shukla & Marlin's interpolation-prediction network as
Prisma-pResearch/Deep_Interpolation_Clustering writes it:
interpolation_layer.py, pretrain_interp.py, rbf.py, clustering_interp.py).

It is the benchmark's frozen yardstick: it imports nothing of the program
under test, uses no hand kernel, and computes every quantity from the
weights and batches it is given. `precision="tf32"` runs every matrix
product in TF32 (on the card through PyTorch's switch, on the CPU by
rounding the operands to TF32's 10-bit mantissa): the lower-precision
control that the comparison must fail.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F

TRANSIENT_KAPPA = 10.0  # interpolation_layer.py: the transient channel's sharpening
RBF_NORM_EPS = 1e-10  # rbf.py: the push's normaliser
BN_EPS = 1e-5
KEY_BITS = 30  # the fake sample's random key bits above the slot position
INVALID_KEY = 0x7FFFFFFF


class Numerics:
    """How the reference multiplies: float32 throughout, or TF32 products."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision {precision!r}: float32 or tf32")
        self.tf32 = precision == "tf32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32 and a.device.type == "cpu":
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)

    @contextlib.contextmanager
    def active(self) -> Iterator[None]:
        """The card's TF32 switches as this precision wants them, restored
        after."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits), to
    nearest, as the tensor cores read a float32 operand. Autograd passes
    through unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.log(1.0 + torch.exp(x))


def logsumexp(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    m = torch.amax(x, dim=dim, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    out = m + torch.log(torch.sum(torch.exp(x - m), dim=dim, keepdim=True))
    return out if keepdim else out.squeeze(dim)


def ref_times(r: int, hours: float, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(0.0, float(hours), r, dtype=like.dtype, device=like.device)


# ------------------------------------------------------------ the fake sample
def fake_select(bits: torch.Tensor, n_valid: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exactly k of the first n_valid slots of each row: those whose 30-bit
    random key (the draw's top bits above the slot position) is smallest.
    `bits` (rows, T) int32 holding uint32 patterns."""
    rows, t_len = bits.shape
    low = (1 << max(1, (t_len - 1).bit_length())) - 1
    pos = torch.arange(t_len, dtype=torch.int32, device=bits.device).expand(rows, t_len)
    rand = (bits >> (32 - KEY_BITS)) & ((1 << KEY_BITS) - 1)
    key = (rand & ~low) | pos
    key = torch.where(pos < n_valid[:, None], key, torch.full_like(key, INVALID_KEY))
    kth = torch.gather(torch.sort(key, dim=-1).values, 1,
                       torch.clamp(k - 1, min=0)[:, None].long())
    return (key <= kth) & (k[:, None] > 0)


def fake_ob(ob_raw: torch.Tensor, mask: torch.Tensor, bits: torch.Tensor,
            noise: torch.Tensor, scale: float) -> torch.Tensor:
    """Half of each channel's observations (at least one) replaced by
    uniform noise over the scaled input range (dataloader.py)."""
    b, c, t = ob_raw.shape
    n_valid = torch.sum(mask, dim=2).to(torch.int32)
    k = torch.where(n_valid > 0, torch.clamp(n_valid // 2, min=1), torch.zeros_like(n_valid))
    sel = fake_select(bits.reshape(b * c, t), n_valid.reshape(-1), k.reshape(-1))
    return torch.where(sel.reshape(b, c, t), noise * scale - scale / 2, ob_raw)


# -------------------------------------------------------------- the encoder
def sci(kernel, ob, mask, ts, r: int, hours: float) -> torch.Tensor:
    """SingleChannelInterp -> (B, R, 3C): [smooth | intensity | transient]."""
    diff = ts[..., None] - ref_times(r, hours, ts)
    norm = diff * diff
    alpha = softplus(kernel)[None, :, None, None]
    log_mask = torch.log(mask)[..., None]
    logits = -alpha * norm + log_mask
    w = logsumexp(logits, dim=2)
    y = torch.sum(torch.exp(logits - w[:, :, None, :]) * ob[..., None], dim=2)
    logits_t = TRANSIENT_KAPPA * (-alpha * norm) + log_mask
    w_t = logsumexp(logits_t, dim=2)
    y_t = torch.sum(torch.exp(logits_t - w_t[:, :, None, :]) * ob[..., None], dim=2)
    return torch.cat([y, w, y_t], dim=1).permute(0, 2, 1)


def cci(kernel, rep, num: Numerics) -> torch.Tensor:
    """CrossChannelInterp over (B, R, 3C)."""
    c = kernel.shape[0]
    y, w, y_t = rep[..., :c], rep[..., c:2 * c], rep[..., 2 * c:]
    w_sm = torch.exp(w - logsumexp(w, dim=2, keepdim=True))
    mean = torch.mean(y, dim=1, keepdim=True)
    smooth = num.mm(w_sm * (y - mean), kernel) + mean
    return torch.cat([smooth, torch.exp(w), y_t - smooth], dim=-1)


def bilstm(P: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, num: Numerics,
           h0: Optional[torch.Tensor] = None, c0: Optional[torch.Tensor] = None):
    """One-layer bidirectional LSTM over time-major x (T, B, F), torch's
    gate order [i|f|g|o] -> (out (T, B, 2H), h_n (2, B, H), c_n (2, B, H))."""
    t_len, b = x.shape[0], x.shape[1]
    hidden = P[f"{prefix}.weight_hh_l0"].shape[1]
    outs, hs, cs = [], [], []
    for d, s in enumerate(("", "_reverse")):
        w_ih, w_hh = P[f"{prefix}.weight_ih_l0{s}"], P[f"{prefix}.weight_hh_l0{s}"]
        b_ih, b_hh = P[f"{prefix}.bias_ih_l0{s}"], P[f"{prefix}.bias_hh_l0{s}"]
        xg = num.mm(x, w_ih.T) + b_ih
        h = x.new_zeros((b, hidden)) if h0 is None else h0[d]
        c = x.new_zeros((b, hidden)) if c0 is None else c0[d]
        ys: List[Optional[torch.Tensor]] = [None] * t_len
        for t in (range(t_len - 1, -1, -1) if d else range(t_len)):
            i, f, g, o = torch.chunk(xg[t] + num.mm(h, w_hh.T) + b_hh, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys[t] = h
        outs.append(torch.stack(ys))
        hs.append(h)
        cs.append(c)
    return torch.cat(outs, dim=-1), torch.stack(hs), torch.stack(cs)


# ------------------------------------------------------------------ heads
def head(P, B, prefix: str, x, num: Numerics, train: bool, relu: bool, rate: float,
         generator: Optional[torch.Generator], row_mask=None) -> torch.Tensor:
    """Linear -> BatchNorm -> [ReLU] -> Dropout -> Linear. Train mode:
    batch moments (weighted by `row_mask`), the dropout mask drawn from
    `generator`; eval: the running moments in `B`."""
    last = 4 if relu else 3
    h = num.mm(x, P[f"{prefix}.model.0.weight"].T) + P[f"{prefix}.model.0.bias"]
    if train:
        if row_mask is None:
            mean = torch.mean(h, dim=0)
            var = torch.mean(torch.square(h - mean), dim=0)
        else:
            m = row_mask[:, None]
            n = torch.sum(row_mask)
            mean = torch.sum(h * m, dim=0) / n
            var = torch.sum(torch.square(h - mean) * m, dim=0) / n
    else:
        mean, var = B[f"{prefix}.model.1.running_mean"], B[f"{prefix}.model.1.running_var"]
    h = ((h - mean) * torch.rsqrt(var + BN_EPS) * P[f"{prefix}.model.1.weight"]
         + P[f"{prefix}.model.1.bias"])
    if relu:
        h = torch.relu(h)
    if train and rate > 0.0:
        keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - rate
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    return num.mm(h, P[f"{prefix}.model.{last}.weight"].T) + P[f"{prefix}.model.{last}.bias"]


def initial_buffers(P: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each head's BatchNorm moments before any training step: mean 0,
    variance 1."""
    out = {}
    for k, w in P.items():
        if k.endswith(".model.1.weight"):
            prefix = k[:-len("weight")]
            out[prefix + "running_mean"] = torch.zeros_like(w)
            out[prefix + "running_var"] = torch.ones_like(w)
    return out


def rbf_push(kernel, proj, mask, ts, r: int, hours: float) -> torch.Tensor:
    """Gaussian RBF push of (B, C, R) values onto the observed timestamps."""
    dist = torch.abs(ts[..., None] - ref_times(r, hours, ts))
    phi = torch.exp(-softplus(kernel)[None, :, None, None] * torch.square(dist)) * mask[..., None]
    y = torch.sum(phi * proj[:, :, None, :], dim=-1)
    return y / (torch.sum(phi, dim=-1) + RBF_NORM_EPS) * mask


def soft_assignment(centers, z, alpha: float = 1.0) -> torch.Tensor:
    d2 = torch.sum(torch.square(z[:, None, :] - centers[None]), dim=2)
    q = (1.0 + d2 / alpha) ** (-(alpha + 1.0) / 2.0)
    return q / torch.sum(q, dim=1, keepdim=True)


def target_distribution(q: torch.Tensor) -> torch.Tensor:
    weight = torch.square(q) / torch.sum(q, dim=0)
    return weight / torch.sum(weight, dim=1, keepdim=True)


# ---------------------------------------------------------------- forward
def encode(P, cfg: dict, streams, num: Numerics):
    """SCI -> CCI -> the encoder biLSTM over every stream at once ->
    (outputs, h_n, c_n, the latents: each row's final states, forward then
    backward)."""
    r, hours = cfg["ref_points"], cfg["hours_from_admission"]
    rep = torch.cat([sci(P["sci.kernel"], *s, r, hours) for s in streams], dim=0)
    rep = cci(P["cci.kernel"], rep, num).permute(1, 0, 2)
    enc_out, h_n, c_n = bilstm(P, "encoder.lstm", rep, num)
    return enc_out, h_n, c_n, torch.cat([h_n[0], h_n[1]], dim=-1)


def forward(P, B, cfg: dict, streams, num: Numerics, train: bool,
            perm: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None, sample_mask=None) -> dict:
    """The network over `streams`, a list of (ob, mask, ts) planes: the real
    batch first, then the fake and the triplet positive when given. Returns
    the latent, the reconstruction and the head outputs."""
    r, hours, rate = cfg["ref_points"], cfg["hours_from_admission"], cfg["dropout"]
    b = streams[0][0].shape[0]
    enc_out, h_n, c_n, z_all = encode(P, cfg, streams, num)
    z = z_all[:b]
    dec_out, _, _ = bilstm(P, "decoder.lstm", torch.relu(enc_out[:, :b]), num,
                           h_n[:, :b], c_n[:, :b])
    mask_rows = sample_mask if train else None
    dec = dec_out.permute(1, 0, 2).reshape(b * r, -1)
    proj = head(P, B, "rbf.compress_fc.module", dec, num, train, True, rate, generator,
                None if mask_rows is None else torch.repeat_interleave(mask_rows, r))
    proj = proj.reshape(b, r, -1).permute(0, 2, 1)
    ob, mask, ts = streams[0]
    out = {"hidden": z, "rec": rbf_push(P["rbf.kernel"], proj, mask, ts, r, hours)}
    out["future_vital"] = torch.sigmoid(head(P, B, "predict_future", z, num, train, False,
                                             rate, generator, mask_rows))
    if perm is not None:
        pos_neg = torch.cat([z, z_all[b:2 * b]])[perm]
        fmask = None if mask_rows is None else torch.cat([mask_rows, mask_rows])[perm]
        out["fake_det"] = torch.log_softmax(
            head(P, B, "fake_det_head", pos_neg, num, train, False, rate, generator, fmask),
            dim=1)
        if len(streams) > 2:
            out["positive"], out["negative"] = z_all[2 * b:], z_all[b:2 * b]
    if "cluster_assignment.cluster_centers" in P:
        q = soft_assignment(P["cluster_assignment.cluster_centers"], z, cfg["dec_alpha"])
        out["cluster_pred"] = q
        out["cluster_label"] = target_distribution(q).detach()
    return out


def _masked_mse(pred, target, mask) -> torch.Tensor:
    obs = mask == 1.0
    diff = torch.where(obs, pred - target, torch.zeros_like(pred))
    return torch.sum(torch.square(diff)) / torch.sum(obs)


def losses(cfg: dict, out: dict, ob, mask, fv, fv_mask, fake_label=None,
           sample_mask=None) -> Dict[str, torch.Tensor]:
    """The multi-task loss: ae_mse + the weighted future-vital, fake-detection,
    triplet and KL terms that the loss mode names (pretrain_interp.py,
    clustering_interp.py)."""
    sm = sample_mask
    out_l = {"ae_mse": _masked_mse(out["rec"], ob, mask if sm is None else mask * sm[:, None, None])}
    weights = {}
    name = cfg["loss"]
    if "_sup" in name:
        out_l["future_vital"] = _masked_mse(out["future_vital"], fv,
                                            fv_mask if sm is None else fv_mask * sm[:, None])
        weights.update(cfg["aux_tasks"])
    if "fake_detect" in name:
        picked = torch.gather(out["fake_det"], 1, fake_label[:, None])[:, 0]
        out_l["fake_detection"] = -torch.mean(picked)
        weights.update(cfg["unsup_aux_tasks"])
    if "triplet" in name:
        out_l["triplet"] = torch.mean(F.triplet_margin_loss(
            out["hidden"], out["positive"], out["negative"], margin=cfg["triple_margin"],
            reduction="none"))
        weights.update(cfg["unsup_aux_tasks"])
    if name.endswith("_kl") or "_kl_" in name:
        p, q = out["cluster_label"], out["cluster_pred"]
        out_l["kl"] = torch.sum(torch.xlogy(p, p) - p * torch.log(q)) / p.shape[0]
        weights.update(cfg["unsup_aux_tasks"])
    total = out_l["ae_mse"]
    for k, v in out_l.items():
        if k != "ae_mse":
            total = total + weights[k] * v
    out_l["loss"] = total
    return out_l

