"""The interpolation-prediction autoencoder network (counterpart of the JAX
`models/net.py`).

  SCI -> CCI -> biLSTM encoder -> latent = concat(fwd/bwd final hidden)
             biLSTM decoder (ReLU'd encoder outputs, seeded with enc state)
          -> CompressFC -> RBF push back onto the observed timestamps
  + FuturePredFc (sigmoid), AuxFc (binary outcome logits),
    FakeDetFc (log-softmax real/fake over the permuted real+fake latents)
  + with `clustering=True` the DEC head: Student-t soft assignments of the
    latent to the cluster centres, and their target distribution

The real, fake and triplet-positive streams go through one batched encode.
With `fused_heads` the CompressFC trunk and the heads run as one batched
chain (`ops.nn.heads_apply_fused`).
`Net`'s `state_dict()` keys are the reference torch model's names
(pretrain_interp.py:90-167, clustering_interp.py:134-189).

Data-parallel, `x` and the streams are this rank's rows of the global batch
and `fake_perm_idx` permutes the global 2B real and fake latents: they are
gathered over ranks (with autograd) and the rank runs the fake-detection
head on its share of the permuted rows (`parallel.permuted_share`).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Union

import torch
from torch import nn

from .. import parallel
from ..config import Config
from ..ops import cuda_interp
from ..ops.dec import centers_init, soft_assignment, target_distribution
from ..ops.interpolation import (
    Planes,
    cci_forward,
    sci_forward,
    sci_forward_multi,
    to_planes,
)
from ..ops.lstm import LSTMWeights, bilstm_forward
from ..ops.nn import Head, heads_apply_fused, uniform_
from ..ops.rbf import RBFDecoder, rbf_push


class NetOutput(NamedTuple):
    hidden: torch.Tensor  # (B, 2H) latent
    rec: torch.Tensor  # (B, C, T) reconstruction at observed timestamps
    aux: Dict[str, torch.Tensor]  # head predictions keyed by task
    # (the JAX NetOutput's `state` has no field here: BatchNorm running
    # stats update in place on the module's buffers in train mode)


class _KernelLayer(nn.Module):
    """A layer whose one parameter is named `kernel` (SCI, CCI)."""

    def __init__(self, shape):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape))


class _RNN(nn.Module):
    """EncoderRNN / DecoderRNN: the biLSTM weights under `.lstm`."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.lstm = LSTMWeights(input_size, hidden)


class _ClusterAssignment(nn.Module):
    """The DEC head: the (K, 2H) cluster centres."""

    def __init__(self, cluster_number: int, dim: int):
        super().__init__()
        self.cluster_centers = nn.Parameter(torch.empty((cluster_number, dim)))


class Net(nn.Module):
    """The network of p1 and, with `clustering=True`, of p3. Parameters are
    drawn from `generator` (torch's default inits; the SCI and RBF kernels
    ~ U[0,1), CCI = identity, the centres Xavier-uniform)."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None,
                 clustering: bool = False):
        super().__init__()
        self.cfg = cfg
        c, h, latent = cfg.num_variables, cfg.lstm_hidden, cfg.dim_enc_hidden
        self.sci = _KernelLayer((c,))
        self.cci = _KernelLayer((c, c))
        self.encoder = _RNN(3 * c, h)
        self.decoder = _RNN(2 * h, h)
        self.rbf = RBFDecoder(latent, c, cfg.head_hidden)
        self.aux_task_names: List[str] = [t for t in cfg.aux_tasks if t != "future_vital"]
        if "future_vital" in cfg.aux_tasks:
            self.predict_future = Head(latent, cfg.head_hidden, c)
        if self.aux_task_names:
            self.aux_head = Head(latent, cfg.head_hidden, len(self.aux_task_names))
        if cfg.fake_detection:
            self.fake_det_head = Head(latent, cfg.head_hidden, 2)
        if clustering:
            self.cluster_assignment = _ClusterAssignment(cfg.cluster_number, latent)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        uniform_(self.sci.kernel, 0.0, 1.0, generator)
        with torch.no_grad():
            self.cci.kernel.copy_(torch.eye(self.cfg.num_variables))
        self.encoder.lstm.reset_parameters(generator)
        self.decoder.lstm.reset_parameters(generator)
        self.rbf.reset_parameters(generator)
        for head in self._heads():
            head.reset_parameters(generator)
        if hasattr(self, "cluster_assignment"):
            with torch.no_grad():
                self.cluster_assignment.cluster_centers.copy_(centers_init(
                    self.cfg.cluster_number, self.cfg.dim_enc_hidden, generator))

    def _heads(self) -> List[Head]:
        return [getattr(self, n) for n in ("predict_future", "aux_head", "fake_det_head")
                if hasattr(self, n)]

    # ---------------------------------------------------------------- encode
    def _sci_streams(self, streams: List[Planes], use_kernels: bool) -> List[torch.Tensor]:
        cfg = self.cfg
        r, hours = cfg.ref_points, cfg.hours_from_admission
        kernel = self.sci.kernel
        if use_kernels:
            # one K2 launch per stream (no dedup), as the JAX Pallas path
            return [cuda_interp.sci(kernel, p.ob, p.mask, p.ts, r, hours) for p in streams]
        # plain path: streams sharing (mask, ts) share the SCI weights (the
        # JAX default `sci_share_weights`): the real and fake streams do,
        # the triplet positive (jittered timestamps) does not
        groups: List[List[int]] = []
        for i, p in enumerate(streams):
            for g in groups:
                if p.mask is streams[g[0]].mask and p.ts is streams[g[0]].ts:
                    g.append(i)
                    break
            else:
                groups.append([i])
        reps: List[torch.Tensor] = [None] * len(streams)
        for g in groups:
            if len(g) == 1:
                reps[g[0]] = sci_forward(kernel, streams[g[0]], r, hours)
            else:
                for i, rep in zip(g, sci_forward_multi(kernel, [streams[i] for i in g],
                                                       r, hours)):
                    reps[i] = rep
        return reps

    def _encode_rep(self, rep: torch.Tensor, use_kernels: bool):
        rep = cci_forward(self.cci.kernel, rep)
        rep = rep.permute(1, 0, 2)  # time-major (R, B, 3C)
        enc_out, hidden, cell = bilstm_forward(self.encoder.lstm, rep, use_kernel=use_kernels)
        cat_hidden = torch.cat([hidden[0], hidden[1]], dim=-1)
        return enc_out, hidden, cell, cat_hidden

    # --------------------------------------------------------------- forward
    def forward(
        self,
        x: Union[torch.Tensor, Planes],
        fake_x: Optional[Union[torch.Tensor, Planes]] = None,
        fake_perm_idx: Optional[torch.Tensor] = None,
        positive_x=None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        sample_mask: Optional[torch.Tensor] = None,
        use_kernels: bool = True,
    ) -> NetOutput:
        """Full forward (reference pretrain_interp.py:130-167,
        clustering_interp.py:134-189). `positive_x`, the triplet positive,
        is encoded when `triple_margin` is not 0 and the fake stream is on.
        `generator` draws the dropout masks in train mode.
        `use_kernels=False` runs the plain PyTorch versions of the kernels
        on any device."""
        cfg = self.cfg
        c, r = cfg.num_variables, cfg.ref_points
        x = to_planes(x, c)
        b = x.ob.shape[0]
        use_fake = cfg.fake_detection and fake_x is not None and fake_perm_idx is not None
        use_triplet = use_fake and cfg.triple_margin != 0.0 and positive_x is not None
        streams = [x] + ([to_planes(fake_x, c)] if use_fake else [])
        if use_triplet:
            streams.append(to_planes(positive_x, c))

        # every stream through ONE encode: each encode op is per sample, so
        # this equals separate passes (net.py:212-244)
        enc_out, hidden, cell, cat_all = self._encode_rep(
            torch.cat(self._sci_streams(streams, use_kernels), dim=0), use_kernels
        )
        enc_out, hidden, cell = enc_out[:, :b], hidden[:, :b], cell[:, :b]
        cat_hidden = cat_all[:b]

        dec_in = torch.relu(enc_out)  # DecoderRNN ReLUs its input
        dec_out, _, _ = bilstm_forward(self.decoder.lstm, dec_in, hidden, cell,
                                       use_kernel=use_kernels)
        interp_data = dec_out.permute(1, 0, 2)  # (B, R, 2H)

        masked = train and sample_mask is not None
        row_mask = sample_mask if masked else None
        rate = cfg.dropout
        # the CompressFC trunk (TimeDistributed: BatchNorm sees B*R rows,
        # reference rbf.py:111-125) and the heads, in the order they draw
        # their dropout
        b_sz, _, in_dim = interp_data.shape
        heads = [("rbf", self.rbf.compress_fc.module, interp_data.reshape(b_sz * r, in_dim),
                  torch.repeat_interleave(sample_mask, r) if masked else None)]
        for name in ("predict_future", "aux_head"):
            if hasattr(self, name):
                heads.append((name, getattr(self, name), cat_hidden, row_mask))
        if use_fake:
            pos_neg = parallel.permuted_share(cat_hidden, cat_all[b : 2 * b], fake_perm_idx)
            fake_mask = None
            if masked:
                fake_mask = parallel.permuted_share(sample_mask, sample_mask, fake_perm_idx)
            heads.append(("fake_det_head", self.fake_det_head, pos_neg, fake_mask))
        if cfg.fused_heads and len(heads) > 1:
            ys = heads_apply_fused([h[1:] for h in heads], rate, train, generator)
        else:
            ys = [head(xh, rate, train, generator, mh) for _, head, xh, mh in heads]
        out = {name: y for (name, *_), y in zip(heads, ys)}

        proj = out["rbf"].reshape(b_sz, r, -1).permute(0, 2, 1)  # (B, C, R)
        rec = rbf_push(self.rbf.kernel, proj, x, r, cfg.hours_from_admission, cfg.rbf_basis,
                       use_kernels)

        aux: Dict[str, torch.Tensor] = {}
        if "predict_future" in out:
            aux["future_vital"] = torch.sigmoid(out["predict_future"])
        if "aux_head" in out:
            for i, task in enumerate(self.aux_task_names):
                aux[task] = out["aux_head"][:, i]
        if use_fake:
            aux["fake_det"] = torch.log_softmax(out["fake_det_head"], dim=1)
            if use_triplet:
                aux["positive"] = cat_all[2 * b:]
                aux["negative"] = cat_all[b: 2 * b]
        if hasattr(self, "cluster_assignment"):
            q = soft_assignment(self.cluster_assignment.cluster_centers, cat_hidden,
                                cfg.dec_alpha)
            aux["cluster_pred"] = q
            aux["cluster_label"] = target_distribution(q, sample_mask).detach()
        return NetOutput(cat_hidden, rec, aux)
