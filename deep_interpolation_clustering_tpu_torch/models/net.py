"""The interpolation-prediction autoencoder network (counterpart of the JAX
`models/net.py`).

  SCI -> CCI -> biLSTM encoder -> latent = concat(fwd/bwd final hidden)
             biLSTM decoder (ReLU'd encoder outputs, seeded with enc state)
          -> CompressFC -> RBF push back onto the observed timestamps
  + FuturePredFc (sigmoid), AuxFc (binary outcome logits),
    FakeDetFc (log-softmax real/fake over the permuted real+fake latents)

`Net`'s `state_dict()` keys are the reference torch model's names
(pretrain_interp.py:90-167). The DEC head and the triplet stream come with
the p3 slice.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Union

import torch
from torch import nn

from ..config import Config
from ..ops import cuda_interp
from ..ops.interpolation import (
    Planes,
    cci_forward,
    sci_forward,
    sci_forward_multi,
    to_planes,
)
from ..ops.lstm import LSTMWeights, bilstm_forward
from ..ops.nn import Head, uniform_
from ..ops.rbf import RBFDecoder, rbf_decode


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


class Net(nn.Module):
    """Pretraining network. Parameters are drawn from `generator` (torch's
    default inits; the SCI and RBF kernels ~ U[0,1), CCI = identity)."""

    def __init__(self, cfg: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.triple_margin != 0.0:
            raise NotImplementedError("the triplet stream comes with the p3 slice")
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
        # plain path: streams sharing (mask, ts) share the SCI weights
        # (the JAX default `sci_share_weights`)
        if len(streams) > 1 and all(
            p.mask is streams[0].mask and p.ts is streams[0].ts for p in streams
        ):
            return sci_forward_multi(kernel, streams, r, hours)
        return [sci_forward(kernel, p, r, hours) for p in streams]

    def _encode_rep(self, rep: torch.Tensor):
        rep = cci_forward(self.cci.kernel, rep)
        rep = rep.permute(1, 0, 2)  # time-major (R, B, 3C)
        enc_out, hidden, cell = bilstm_forward(self.encoder.lstm, rep)
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
        """Full forward (reference pretrain_interp.py:130-167). `generator`
        draws the dropout masks in train mode. `use_kernels=False` runs the
        plain PyTorch versions of the kernels on any device."""
        if positive_x is not None:
            raise NotImplementedError("the triplet stream comes with the p3 slice")
        cfg = self.cfg
        c, r = cfg.num_variables, cfg.ref_points
        x = to_planes(x, c)
        b = x.ob.shape[0]
        use_fake = cfg.fake_detection and fake_x is not None and fake_perm_idx is not None
        streams = [x] + ([to_planes(fake_x, c)] if use_fake else [])

        # every stream through ONE encode: each encode op is per sample, so
        # this equals separate passes (net.py:212-244)
        enc_out, hidden, cell, cat_all = self._encode_rep(
            torch.cat(self._sci_streams(streams, use_kernels), dim=0)
        )
        enc_out, hidden, cell = enc_out[:, :b], hidden[:, :b], cell[:, :b]
        cat_hidden = cat_all[:b]

        dec_in = torch.relu(enc_out)  # DecoderRNN ReLUs its input
        dec_out, _, _ = bilstm_forward(self.decoder.lstm, dec_in, hidden, cell)
        interp_data = dec_out.permute(1, 0, 2)  # (B, R, 2H)

        masked = train and sample_mask is not None
        row_mask = sample_mask if masked else None
        rate = cfg.dropout
        # CompressFC draws its dropout before the heads draw theirs
        rec = rbf_decode(
            self.rbf, interp_data, x, r, cfg.hours_from_admission, rate, train,
            generator, cfg.rbf_basis, use_kernels,
            torch.repeat_interleave(sample_mask, r) if masked else None,
        )

        aux: Dict[str, torch.Tensor] = {}
        if hasattr(self, "predict_future"):
            aux["future_vital"] = torch.sigmoid(
                self.predict_future(cat_hidden, rate, train, generator, row_mask)
            )
        if hasattr(self, "aux_head"):
            y = self.aux_head(cat_hidden, rate, train, generator, row_mask)
            for i, task in enumerate(self.aux_task_names):
                aux[task] = y[:, i]
        if use_fake:
            pos_neg = torch.cat([cat_hidden, cat_all[b : 2 * b]], dim=0)[fake_perm_idx]
            fake_mask = None
            if masked:
                fake_mask = torch.cat([sample_mask, sample_mask])[fake_perm_idx]
            logits = self.fake_det_head(pos_neg, rate, train, generator, fake_mask)
            aux["fake_det"] = torch.log_softmax(logits, dim=1)
        return NetOutput(cat_hidden, rec, aux)
