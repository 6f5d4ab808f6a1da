"""mTAN, the multi-time attention network (Shukla & Marlin, "Multi-Time
Attention Networks for Irregularly Sampled Time Series", ICLR 2021;
github.com/reml-lab/mTAN `models.py`), in its mTAND-Full form with a
classifier head, as p1's second network (`Config.model = "mtan"`).

  time embedding   phi(t) = [w0 t + a0, sin(w t + a)] in R^E (`learn_emb`),
                   one for the encoder and one for the decoder
  attention        q = W_q phi(t_q) + b_q, k = W_k phi(t_k) + b_k, one head,
                   s = q . k / sqrt(E), a softmax over the keys (per value
                   column, over the keys its mask marks), then W_o
  encoder (rec)    queries at R reference times linspace(0, 1, R), values
                   [x ; m] (2C columns, both halves under the channel's
                   mask) -> W_o 2C -> H_rec -> biGRU H_rec -> H_rec over the R
                   points -> Linear 2H_rec -> 50, ReLU, Linear 50 -> 2L:
                   the mean and log-variance of z at each reference point
  sample           z = mu + exp(logvar / 2) * eps (one sample, `k_iwae 1`)
  decoder (dec)    biGRU L -> H_gen over the R points, attention with the
                   queries at the target times and the keys at the
                   reference times (no mask) over its 2H_gen-wide outputs,
                   W_o, Linear 2H_gen -> 50, ReLU, Linear 50 -> C
  classifier       GRU L -> H_rec over z; its last state through 300, ReLU,
                   300, ReLU, N

Parameter names are mTAN's: `rec.*` (enc_mtan_rnn), `dec.*` (dec_mtan_rnn),
`classifier.*` (create_classifier), with `att.linears.{0,1,2}` = W_q, W_k,
W_o.

How it meets this system (departures from the published code):
  * the planes: each channel keeps its own times ((B, C, T) `ob`, `mask`,
    `ts`), which is mTAN's union time axis with per-channel masks: channel
    c's softmax runs over its own observed times. Times are divided by
    `hours_from_admission` (mTAN scales them to [0, 1]). The encoder's
    attention is the hand kernel pair of `ops/cuda_mtan.py` (its plain
    version on the CPU); the decoder's, which has no mask, is softmax(S) V;
  * the reconstruction is decoded at every slot and taken at channel c's
    own slots, masked like the IPN's (the loss reads the observed ones);
  * the classifier predicts the system's future-vital targets through a
    sigmoid, under the system's `sup` loss (`models/losses.mtan_losses`);
  * the latent that p2-p4 read (`hidden`) is the classifier GRU's last
    state, H_rec = 256 wide, the IPN's latent width;
  * an eval forward decodes the posterior mean, with no draw (mTAN samples).
The parameters are drawn from `generator` by torch's default inits
(nn.Linear and nn.GRU). The `nn.GRU` modules hold the GRUs' parameters (their
names, order and draws); the recurrences run as the hand kernel pair G1 of
`ops/cuda_gru.py` (its plain version on the CPU), which a CUDA graph
captures.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from ..config import Config
from ..ops.cuda_gru import gru
from ..ops.cuda_mtan import encoder_attention
from ..ops.interpolation import Planes
from ..ops.nn import uniform_

# widths mTAN's code fixes (models.py): the z-heads' and the decoder's
# output MLP's hidden layer, the classifier's MLP
Z_HIDDEN = 50
CLASSIFIER_HIDDEN = 300
# the KL weight is 0 before this epoch (mTAN's script, `--kl`)
KL_WAIT = 10


class MTANOutput(NamedTuple):
    hidden: torch.Tensor  # (B, H_rec) the classifier GRU's last state
    rec: torch.Tensor  # (B, C, T) the reconstruction at each channel's slots, masked
    aux: Dict[str, torch.Tensor]  # {"future_vital": (B, C)}
    qz_mean: torch.Tensor  # (B, R, L)
    qz_logvar: torch.Tensor  # (B, R, L)


class MultiTimeAttention(nn.Module):
    """mTAN's `multiTimeAttention`'s weights at one head: `linears` =
    [W_q (E, E), W_k (E, E), W_o (values -> out)]."""

    def __init__(self, values: int, out: int, embed_time: int):
        super().__init__()
        self.linears = nn.ModuleList([nn.Linear(embed_time, embed_time),
                                      nn.Linear(embed_time, embed_time), nn.Linear(values, out)])


class _TimeEmbedded(nn.Module):
    """A module with mTAN's learned time embedding (`linear`, `periodic`)."""

    def __init__(self, embed_time: int):
        super().__init__()
        self.linear = nn.Linear(1, 1)
        self.periodic = nn.Linear(1, embed_time - 1)

    def embed(self, t: torch.Tensor) -> torch.Tensor:
        """(...,) times -> (..., E)."""
        t = t[..., None]
        return torch.cat([self.linear(t), torch.sin(self.periodic(t))], dim=-1)


class Encoder(_TimeEmbedded):
    """mTAN's `enc_mtan_rnn`."""

    def __init__(self, channels: int, hidden: int, latent: int, embed_time: int):
        super().__init__(embed_time)
        self.att = MultiTimeAttention(2 * channels, hidden, embed_time)
        self.gru_rnn = nn.GRU(hidden, hidden, bidirectional=True, batch_first=True)
        self.hiddens_to_z0 = nn.Sequential(nn.Linear(2 * hidden, Z_HIDDEN), nn.ReLU(),
                                           nn.Linear(Z_HIDDEN, 2 * latent))


class Decoder(_TimeEmbedded):
    """mTAN's `dec_mtan_rnn`."""

    def __init__(self, channels: int, hidden: int, latent: int, embed_time: int):
        super().__init__(embed_time)
        self.att = MultiTimeAttention(2 * hidden, 2 * hidden, embed_time)
        self.gru_rnn = nn.GRU(latent, hidden, bidirectional=True, batch_first=True)
        self.z0_to_obs = nn.Sequential(nn.Linear(2 * hidden, Z_HIDDEN), nn.ReLU(),
                                       nn.Linear(Z_HIDDEN, channels))


class Classifier(nn.Module):
    """mTAN's `create_classifier`."""

    def __init__(self, latent: int, hidden: int, n_out: int):
        super().__init__()
        self.gru_rnn = nn.GRU(latent, hidden, batch_first=True)
        self.classifier = nn.Sequential(
            nn.Linear(hidden, CLASSIFIER_HIDDEN), nn.ReLU(),
            nn.Linear(CLASSIFIER_HIDDEN, CLASSIFIER_HIDDEN), nn.ReLU(),
            nn.Linear(CLASSIFIER_HIDDEN, n_out))


def _gru(module: nn.GRU, x: torch.Tensor, use_kernels: bool):
    with torch.profiler.record_function("mtan_gru"):
        return gru(module, x, use_kernels)


class MTAN(nn.Module):
    """p1's mTAN network (module docstring). `kl_weight` is the KL term's
    weight, a 0-d tensor that `set_epoch` writes in place (a captured step
    reads it); not saved with the weights."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        extra = sorted(set(cfg.aux_tasks) - {"future_vital"})
        if "future_vital" not in cfg.aux_tasks or extra:
            raise ValueError(f"model='mtan' predicts the future vitals alone: aux_tasks "
                             f"{dict(cfg.aux_tasks)} is not supported")
        self.cfg = cfg
        c, e = cfg.num_variables, cfg.mtan_embed_time
        self.rec = Encoder(c, cfg.mtan_rec_hidden, cfg.mtan_latent_dim, e)
        self.dec = Decoder(c, cfg.mtan_gen_hidden, cfg.mtan_latent_dim, e)
        self.classifier = Classifier(cfg.mtan_latent_dim, cfg.mtan_rec_hidden, c)
        self.register_buffer("kl_weight", torch.zeros(()), persistent=False)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """torch's default inits, drawn from `generator` in the order of
        `named_parameters`: a Linear's weight and bias U(-1/sqrt(in),
        1/sqrt(in)), a GRU's every tensor U(-1/sqrt(H), 1/sqrt(H))."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                bound = 1.0 / math.sqrt(module.in_features)
            elif isinstance(module, nn.GRU):
                bound = 1.0 / math.sqrt(module.hidden_size)
            else:
                continue
            for p in module.parameters(recurse=False):
                uniform_(p, -bound, bound, generator)

    def set_epoch(self, epoch: int) -> None:
        """The KL weight of `epoch` (1-based), mTAN's `--kl` schedule: 0
        before `KL_WAIT`, then 1 - 0.99^(epoch - KL_WAIT)."""
        self.kl_weight.fill_(0.0 if epoch < KL_WAIT else 1.0 - 0.99 ** (epoch - KL_WAIT))

    def reference_times(self, like: torch.Tensor) -> torch.Tensor:
        return torch.linspace(0.0, 1.0, self.cfg.mtan_ref_points, dtype=like.dtype,
                              device=like.device)

    def encode(self, x: Planes, use_kernels: bool = True):
        """The posterior's mean and log-variance at the reference points,
        each (B, R, L)."""
        cfg, rec = self.cfg, self.rec
        ob, mask = x.ob, x.mask
        w_q, w_k, w_o = rec.att.linears
        with torch.profiler.record_function("mtan_encoder_attention"):
            q = w_q(rec.embed(self.reference_times(ob)))  # (R, E)
            k = w_k(rec.embed(x.ts / cfg.hours_from_admission))  # (B, C, T, E)
            h_ob, h_m = encoder_attention(q, k, ob, mask, use_kernels)
            # mTAN's value columns: the C channels' values, then their masks
            h = torch.cat([h_ob, h_m], dim=1).permute(0, 2, 1)  # (B, R, 2C)
            h = w_o(h)
        out, _ = _gru(rec.gru_rnn, h, use_kernels)
        out = rec.hiddens_to_z0(out)
        latent = cfg.mtan_latent_dim
        return out[..., :latent], out[..., latent:]

    def decode(self, z: torch.Tensor, x: Planes, use_kernels: bool = True) -> torch.Tensor:
        """The reconstruction (B, C, T) at each channel's own slots, masked."""
        dec = self.dec
        b, c, t_len = x.ob.shape
        w_q, w_k, w_o = dec.att.linears
        values, _ = _gru(dec.gru_rnn, z, use_kernels)  # (B, R, 2H_gen)
        with torch.profiler.record_function("mtan_decoder_attention"):
            q = w_q(dec.embed(x.ts.reshape(b, c * t_len) / self.cfg.hours_from_admission))
            k = w_k(dec.embed(self.reference_times(z)))  # (R, E)
            scores = torch.matmul(q, k.T) / math.sqrt(k.shape[-1])  # (B, C*T, R)
            h = w_o(torch.matmul(torch.softmax(scores, dim=-1), values))
        out = dec.z0_to_obs(h).reshape(b, c, t_len, c)  # every channel at every slot
        rec = torch.diagonal(out, dim1=1, dim2=3)  # (B, T, C): channel c at its own slots
        return rec.permute(0, 2, 1) * x.mask

    def forward(self, x: Planes, eps: Optional[torch.Tensor] = None,
                use_kernels: bool = True) -> MTANOutput:
        """The network over the real stream `x`; `eps` (B, R, L), the
        standard normal draw of the train step, samples z; without it z is
        the posterior mean (eval). `use_kernels=False` runs the encoder's
        attention and the GRUs in their plain versions on any device."""
        mean, logvar = self.encode(x, use_kernels)
        z = mean if eps is None else mean + torch.exp(0.5 * logvar) * eps
        rec = self.decode(z, x, use_kernels)
        _, last = _gru(self.classifier.gru_rnn, z, use_kernels)
        hidden = last[0]
        future = torch.sigmoid(self.classifier.classifier(hidden))
        return MTANOutput(hidden, rec, {"future_vital": future}, mean, logvar)
