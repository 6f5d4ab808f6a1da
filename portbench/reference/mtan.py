"""mTAN in plain PyTorch, as its authors wrote it: Shukla & Marlin,
"Multi-Time Attention Networks for Irregularly Sampled Time Series", ICLR
2021, github.com/reml-lab/mTAN (`models.py`: `multiTimeAttention`,
`enc_mtan_rnn`, `dec_mtan_rnn`, `create_classifier`; `utils.py`:
`log_normal_pdf`, `normal_kl`; the PhysioNet classification script's loss
with `--norm --kl --learn-emb`, `k_iwae 1`), in its mTAND-Full form with a
classifier head, the benchmark's frozen yardstick for the `mtan_*` cells.

It imports nothing of the program under test and no hand kernel. Float32,
TF32 off on the card (`Numerics.active`). The attention is mTAN's own
form: the scores repeated over the value columns (`repeat_interleave`),
each copy masked by its column's mask with -1e9 and softmaxed over the
keys; the recurrences are `nn.GRU`. Batches are taken in blocks of
`BLOCK` encounters, each block's loss differentiated on its own and the
gradients summed (no term of the loss couples two encounters, and every
mean's denominator is the whole batch's), so that the repeated tensors fit
on the card.

Departures from the published code, which the program makes too:
  * the input is the system's planes: (B, C, T) values, mask and times, a
    channel's observations at its own times. They are laid out as mTAN's
    union time axis (`union`): C * T keys an encounter, key (c, t) at time
    ts[c, t] / hours with the value and the mask of channel c in column c
    (and C + c: mTAN's `cat((mask, mask))`), every other column 0;
  * the classifier's N = C outputs go through a sigmoid and a masked MSE
    against the system's future-vital targets (the system's `sup` loss),
    weighted by alpha, in place of mTAN's cross-entropy over labels;
  * log p(x|z) and the KL are divided by the encounter's observed count, at
    least 1 (`--norm`; mTAN divides by 0 for an empty encounter);
  * an eval pass decodes the posterior mean (mTAN samples);
  * the reconstruction's MSE over the observed points (`ae_mse`, the
    system's) is reported beside the ELBO's terms and weighs nothing.
`precision="tf32"` runs the products in TF32: on the card through
PyTorch's switches (cuBLAS and cuDNN), on the CPU by rounding the weights
and the attention's operands to TF32. It is the control that the
comparison must fail.

The starting weights (`init_weights`) are torch's default inits, drawn from
the seed in one flat draw: a Linear's weight and bias U(-1/sqrt(in),
1/sqrt(in)), a GRU's every tensor U(-1/sqrt(H), 1/sqrt(H)).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import model as M
from .train import AmsgradAdam, clip_global_norm, epoch_order, prepare

BLOCK = 16  # encounters a block: the repeated decoder scores, (16, C*T, R, 2*H_gen)
Z_HIDDEN = 50  # models.py: hiddens_to_z0's and z0_to_obs's hidden layer
CLASSIFIER_HIDDEN = 300  # models.py: create_classifier's MLP
MASKED = -1e9  # models.py: masked_fill of a masked score
LOSS_KEYS = ("loss", "ae_mse", "nll", "kl", "future_vital")
# the leaves that only the encoder attention's scores reach (the program's
# M1 backward, its dQ and dK): W_q, b_q, W_k and the encoder's time
# embedding; b_k's gradient is nought in exact arithmetic (a softmax does
# not see a shift of its scores) and is left out
SCORE_LEAVES = ("rec.att.linears.0.weight", "rec.att.linears.0.bias",
                "rec.att.linears.1.weight", "rec.linear.weight", "rec.linear.bias",
                "rec.periodic.weight", "rec.periodic.bias")
KL_WAIT = 10  # the script's wait_until_kl_inc (`--kl`)
OBS_STD = 0.01  # the noise sigma of log p(x|z)


# --------------------------------------------------------------- the modules
class multiTimeAttention(nn.Module):  # noqa: N801 (mTAN's name)
    def __init__(self, input_dim, nhidden=16, embed_time=16, num_heads=1):
        super().__init__()
        assert embed_time % num_heads == 0
        self.embed_time = embed_time
        self.embed_time_k = embed_time // num_heads
        self.h = num_heads
        self.dim = input_dim
        self.nhidden = nhidden
        self.linears = nn.ModuleList([nn.Linear(embed_time, embed_time),
                                      nn.Linear(embed_time, embed_time),
                                      nn.Linear(input_dim * num_heads, nhidden)])

    def attention(self, query, key, value, mask=None):
        dim = value.size(-1)
        d_k = query.size(-1)
        scores = torch.matmul(query, key.transpose(-2, -1)) / math.sqrt(d_k)
        scores = scores.unsqueeze(-1).repeat_interleave(dim, dim=-1)
        if mask is not None:
            scores = scores.masked_fill(mask.unsqueeze(-3) == 0, MASKED)
        p_attn = torch.softmax(scores, dim=-2)
        return torch.sum(p_attn * value.unsqueeze(-3), -2)

    def forward(self, query, key, value, mask=None):
        batch, _, dim = value.size()
        if mask is not None:
            mask = mask.unsqueeze(1)
        value = value.unsqueeze(1)
        query, key = [lin(x).view(x.size(0), -1, self.h, self.embed_time_k).transpose(1, 2)
                      for lin, x in zip(self.linears, (query, key))]
        x = self.attention(query, key, value, mask)
        x = x.transpose(1, 2).contiguous().view(batch, -1, self.h * dim)
        return self.linears[-1](x)


class _Embedded(nn.Module):
    def __init__(self, embed_time):
        super().__init__()
        self.periodic = nn.Linear(1, embed_time - 1)
        self.linear = nn.Linear(1, 1)

    def learn_time_embedding(self, tt):
        tt = tt.unsqueeze(-1)
        return torch.cat([self.linear(tt), torch.sin(self.periodic(tt))], -1)


class enc_mtan_rnn(_Embedded):  # noqa: N801
    def __init__(self, input_dim, query, latent_dim, nhidden, embed_time):
        super().__init__(embed_time)
        self.dim = input_dim
        self.query = query
        self.att = multiTimeAttention(2 * input_dim, nhidden, embed_time, 1)
        self.gru_rnn = nn.GRU(nhidden, nhidden, bidirectional=True, batch_first=True)
        self.hiddens_to_z0 = nn.Sequential(nn.Linear(2 * nhidden, Z_HIDDEN), nn.ReLU(),
                                           nn.Linear(Z_HIDDEN, latent_dim * 2))

    def forward(self, x, time_steps):
        mask = x[:, :, self.dim:]
        mask = torch.cat((mask, mask), 2)
        key = self.learn_time_embedding(time_steps)
        query = self.learn_time_embedding(self.query.unsqueeze(0))
        out = self.att(query, key, x, mask)
        out, _ = self.gru_rnn(out)
        return self.hiddens_to_z0(out)


class dec_mtan_rnn(_Embedded):  # noqa: N801
    def __init__(self, input_dim, query, latent_dim, nhidden, embed_time):
        super().__init__(embed_time)
        self.query = query
        self.att = multiTimeAttention(2 * nhidden, 2 * nhidden, embed_time, 1)
        self.gru_rnn = nn.GRU(latent_dim, nhidden, bidirectional=True, batch_first=True)
        self.z0_to_obs = nn.Sequential(nn.Linear(2 * nhidden, Z_HIDDEN), nn.ReLU(),
                                       nn.Linear(Z_HIDDEN, input_dim))

    def forward(self, z, time_steps):
        out, _ = self.gru_rnn(z)
        query = self.learn_time_embedding(time_steps)
        key = self.learn_time_embedding(self.query.unsqueeze(0))
        out = self.att(query, key, out)
        return self.z0_to_obs(out)


class create_classifier(nn.Module):  # noqa: N801
    def __init__(self, latent_dim, nhidden, N):
        super().__init__()
        self.gru_rnn = nn.GRU(latent_dim, nhidden, batch_first=True)
        self.classifier = nn.Sequential(
            nn.Linear(nhidden, CLASSIFIER_HIDDEN), nn.ReLU(),
            nn.Linear(CLASSIFIER_HIDDEN, CLASSIFIER_HIDDEN), nn.ReLU(),
            nn.Linear(CLASSIFIER_HIDDEN, N))

    def forward(self, z):
        _, out = self.gru_rnn(z)
        return self.classifier(out.squeeze(0)), out.squeeze(0)


class Model(nn.Module):
    """The three models of mTAN's script under one module: `rec`, `dec`,
    `classifier` (their state-dict names are the program's)."""

    def __init__(self, cfg: dict, device):
        super().__init__()
        query = torch.linspace(0, 1.0, cfg["mtan_ref_points"], device=device)
        c, e = cfg["num_variables"], cfg["mtan_embed_time"]
        self.rec = enc_mtan_rnn(c, query, cfg["mtan_latent_dim"], cfg["mtan_rec_hidden"], e)
        self.dec = dec_mtan_rnn(c, query, cfg["mtan_latent_dim"], cfg["mtan_gen_hidden"], e)
        self.classifier = create_classifier(cfg["mtan_latent_dim"], cfg["mtan_rec_hidden"], c)
        self.to(device)


def shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape under its name."""
    with torch.device("meta"):
        model = Model(cfg, "meta")
    return {k: tuple(v.shape) for k, v in model.named_parameters()}


def init_weights(names: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights for the `names` and shapes: torch's default inits of
    nn.Linear and nn.GRU, from one flat uniform draw seeded by `seed`, in
    sorted-name order."""
    total = sum(math.prod(s) for s in names.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in sorted(names.items()):
        n = math.prod(shape)
        layer = name.rsplit(".", 1)[0]
        if ".gru_rnn." in name:
            bound = 1.0 / math.sqrt(names[f"{layer}.weight_hh_l0"][1])
        else:
            bound = 1.0 / math.sqrt(names[f"{layer}.weight"][1])
        out[name] = ((flat[at:at + n] * 2.0 - 1.0) * bound).reshape(shape)
        at += n
    return out


# ----------------------------------------------------------------- the loss
def union(batch: Dict[str, torch.Tensor], hours: float):
    """The system's (B, C, T) planes as mTAN's union axis: (values and mask
    (B, C*T, 2C), times (B, C*T), the observed values and mask (B, C*T, C))."""
    ob, mask, ts = batch["ob"] * batch["mask"], batch["mask"], batch["ts"]
    b, c, t = ob.shape
    eye = torch.eye(c, dtype=ob.dtype, device=ob.device)
    spread = lambda p: (p[..., None] * eye[None, :, None, :]).reshape(b, c * t, c)  # noqa: E731
    data, obs = spread(ob), spread(mask)
    return torch.cat([data, obs], dim=2), ts.reshape(b, c * t) / hours, data, obs


def log_normal_pdf(x, mean, logvar, mask):
    const = torch.log(torch.tensor([2.0 * np.pi], dtype=x.dtype, device=x.device))
    return -0.5 * (const + logvar + (x - mean) ** 2.0 / torch.exp(logvar)) * mask


def normal_kl(mu1, lv1, mu2, lv2):
    v1, v2 = torch.exp(lv1), torch.exp(lv2)
    return lv2 / 2.0 - lv1 / 2.0 + (v1 + (mu1 - mu2) ** 2.0) / (2.0 * v2) - 0.5


def kl_weight(epoch: int) -> float:
    """The script's `--kl` schedule."""
    return 0.0 if epoch < KL_WAIT else 1.0 - 0.99 ** (epoch - KL_WAIT)


def block_terms(model: nn.Module, cfg: dict, batch: Dict[str, torch.Tensor],
                eps: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The block's sums: -log p(x|z) / n_obs and KL / n_obs over its
    encounters, the squared errors of the future vitals and of the
    reconstruction, and the latents."""
    x, tt, data, obs = union(batch, cfg["hours_from_admission"])
    out = model.rec(x, tt)
    latent = cfg["mtan_latent_dim"]
    qz0_mean, qz0_logvar = out[:, :, :latent], out[:, :, latent:]
    z0 = qz0_mean if eps is None else eps * torch.exp(0.5 * qz0_logvar) + qz0_mean
    logits, hidden = model.classifier(z0)
    pred_x = model.dec(z0, tt)
    noise_logvar = 2.0 * torch.log(torch.full_like(pred_x, OBS_STD))
    logpx = log_normal_pdf(data, pred_x, noise_logvar, obs).sum(-1).sum(-1)
    zeros = torch.zeros_like(qz0_mean)
    kl = normal_kl(qz0_mean, qz0_logvar, zeros, zeros).sum(-1).sum(-1)
    n_obs = torch.clamp(obs.sum(-1).sum(-1), min=1.0)
    fv_err = (torch.sigmoid(logits) - batch["fv"]) ** 2 * batch["fv_mask"]
    return {"nll": -torch.sum(logpx / n_obs), "kl": torch.sum(kl / n_obs),
            "fv_sq": torch.sum(fv_err), "rec_sq": torch.sum((pred_x - data) ** 2 * obs),
            "hidden": hidden}


def _blocks(n: int):
    return [(s, min(s + BLOCK, n)) for s in range(0, n, BLOCK)]


def _cut(batch: Dict[str, torch.Tensor], s: int, e: int) -> Dict[str, torch.Tensor]:
    return {k: v[s:e] for k, v in batch.items()}


def batch_losses(model, cfg: dict, batch, eps, kappa: float, grads: bool = False
                 ) -> Tuple[Dict[str, float], Optional[List[torch.Tensor]]]:
    """The batch's losses ({LOSS_KEYS}: the means over its encounters and
    the observed future vitals and points) and, with `grads`, the loss's
    gradients over `model.parameters()`, block by block."""
    b = batch["ob"].shape[0]
    n_fv = float(torch.sum(batch["fv_mask"]))
    n_pts = float(torch.sum(batch["mask"]))
    sums = {"nll": 0.0, "kl": 0.0, "fv_sq": 0.0, "rec_sq": 0.0}
    params = list(model.parameters())
    total = [torch.zeros_like(p) for p in params] if grads else None
    for s, e in _blocks(b):
        terms = block_terms(model, cfg, _cut(batch, s, e), None if eps is None else eps[s:e])
        if grads:
            loss = (terms["nll"] + kappa * terms["kl"]) / b \
                + cfg["mtan_alpha"] * terms["fv_sq"] / n_fv
            for acc, g in zip(total, torch.autograd.grad(loss, params, allow_unused=True)):
                if g is not None:
                    acc.add_(g)
        for k in sums:
            sums[k] += float(terms[k].detach().double())
    out = {"nll": sums["nll"] / b, "kl": sums["kl"] / b, "future_vital": sums["fv_sq"] / n_fv,
           "ae_mse": sums["rec_sq"] / n_pts}
    out["loss"] = out["nll"] + kappa * out["kl"] + cfg["mtan_alpha"] * out["future_vital"]
    return out, total


# ------------------------------------------------------------ steps and eval
class _Precision:
    """The reference's products: float32 with TF32 off, or TF32 (the
    control); on the CPU the control rounds the weights and the attention's
    operands to TF32."""

    def __init__(self, precision: str):
        self.num = M.Numerics(precision)

    def model(self, cfg: dict, weights: Dict[str, torch.Tensor], device) -> nn.Module:
        model = Model(cfg, device)
        with torch.no_grad():
            for k, p in model.named_parameters():
                w = weights[k].to(device)
                p.copy_(M.round_tf32(w) if self.num.tf32 and p.device.type == "cpu" else w)
        if self.num.tf32 and torch.device(device).type == "cpu":
            for att in (model.rec.att, model.dec.att):
                inner = att.attention

                def rounded(q, k, v, mask=None, inner=inner):
                    return inner(M.round_tf32(q), M.round_tf32(k), v, mask)
                att.attention = rounded
        return model


def train_steps(cfg: dict, weights: Dict[str, torch.Tensor], raw: Dict[str, np.ndarray],
                eps: List[torch.Tensor], precision: str = "float32",
                device: Optional[torch.device] = None) -> dict:
    """The run's first `len(eps)` train steps from `weights` with the
    program's draws `eps`, on the reference's own trajectory: each step's
    losses, the first step's gradients as the optimizer takes them (`grad`)
    and before the weight decay (`raw_grad`), and the parameters after the
    last step. amsgrad Adam, L2 decay folded into the gradient, the clip
    only where `grad_clip` is set; the KL weight of epoch 1."""
    device = device or next(iter(weights.values())).device
    prec = _Precision(precision)
    model = prec.model(cfg, weights, device)
    names = [k for k, _ in model.named_parameters()]
    params = {k: p for k, p in model.named_parameters()}
    opt = AmsgradAdam({k: p.detach() for k, p in params.items()}, cfg["init_lr"],
                      cfg["weight_decay_rate"])
    order = epoch_order(len(raw["feat"]), cfg["seed"], 1)
    bsz, kappa = cfg["batch_size"], kl_weight(1)
    out: dict = {"losses": []}
    with prec.num.active():
        for i, e in enumerate(eps):
            batch = prepare(raw, order[i * bsz:(i + 1) * bsz], cfg, device)
            losses, grads = batch_losses(model, cfg, batch, e.to(device), kappa, grads=True)
            grads = dict(zip(names, grads))
            if cfg.get("grad_clip"):
                clip_global_norm(grads, cfg["grad_clip"])
            raw_grad = {k: g.clone() for k, g in grads.items()} if i == 0 else None
            with torch.no_grad():
                update, taken = opt.step(grads, {k: p.detach() for k, p in params.items()})
                for k, u in update.items():
                    params[k].add_(u)
            out["losses"].append(losses)
            if i == 0:
                out["grad"] = {k: v.clone() for k, v in taken.items()}
                out["raw_grad"] = raw_grad
    out["params"] = {k: p.detach().clone() for k, p in params.items()}
    return out


@torch.no_grad()
def eval_losses(cfg: dict, weights: Dict[str, torch.Tensor], raw: Dict[str, np.ndarray],
                precision: str = "float32", device: Optional[torch.device] = None,
                epoch: int = 1) -> Dict[str, float]:
    """The eval pass at the posterior mean: each loss of `LOSS_KEYS` a batch
    of the batch size in cohort order, their means over the batches."""
    device = device or next(iter(weights.values())).device
    prec = _Precision(precision)
    model = prec.model(cfg, weights, device)
    n, bsz = len(raw["feat"]), cfg["batch_size"]
    per: Dict[str, List[float]] = {k: [] for k in LOSS_KEYS}
    with prec.num.active():
        for start in range(0, n, bsz):
            batch = prepare(raw, np.arange(start, min(start + bsz, n)), cfg, device)
            losses, _ = batch_losses(model, cfg, batch, None, kl_weight(epoch))
            for k in LOSS_KEYS:
                per[k].append(losses[k])
    return {k: float(np.mean(v, dtype=np.float64)) for k, v in per.items()}


def train_numbers(prog: dict, ref: dict, init: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """`compare.train_numbers`, with `loss1_gap` and `loss_gap` the worst
    over every loss component (the KL term is compared while its weight is
    0 and the total does not show it), and two more numbers for faults
    that reach few leaves, which the medians pass: `grad_worst` and
    `change_worst`, the worst counted leaf's gaps; `attn_grad_gap`, the
    first gradient of `SCORE_LEAVES` taken as one vector, the norm of the
    difference over the reference's norm. The encoder attention's backward
    reaches only those, and at mTAN's widths their gradients lie under
    1e-3 of the median leaf's, so that `compare` leaves them out as quiet.
    One vector, not the worst leaf: `rec.linear`'s two leaves are scalars,
    sums with much cancellation, whose own relative gap can be any size."""
    from .compare import rel_gap, train_numbers as ipn_numbers

    out = ipn_numbers(prog, ref, init)
    gaps = [max(rel_gap(p[k], r[k]) for k in LOSS_KEYS)
            for p, r in zip(prog["losses"], ref["losses"])]
    want = torch.cat([ref["grad"][k].double().flatten() for k in SCORE_LEAVES])
    got = torch.cat([prog["grad"][k].double().flatten().to(want.device) for k in SCORE_LEAVES])
    out.update(loss1_gap=gaps[0], loss_gap=max(gaps), _loss_gaps=gaps,
               grad_worst=out["_grad_worst"], change_worst=out["_change_worst"],
               attn_grad_gap=float(torch.linalg.vector_norm(got - want)
                                   / torch.linalg.vector_norm(want)))
    return out


def eval_numbers(prog: Dict[str, float], ref: Dict[str, float]) -> Dict[str, float]:
    """eval_gap: the worst of the eval pass's losses."""
    from .compare import rel_gap

    return {"eval_gap": max(rel_gap(prog[k], ref[k]) for k in LOSS_KEYS)}
