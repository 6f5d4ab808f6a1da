"""Bidirectional one-layer LSTM (counterpart of the JAX
`ops/lstm.py::bilstm_forward`).

The input projections `x W_ih^T + b_ih` are one product each, hoisted out
of the recurrence as the JAX package hoists them (in the operands' common
type, `numerics.matmul`). The recurrence itself, both
directions over the R=6 reference points, is `ops/cuda_lstm.py`: on the card
the hand-written kernels B6 (forward) and B7 (backward) whenever the step's
`use_kernels` is on, as for the other kernels. The JAX config's
`use_pallas_lstm` switch is ignored (config.py): on the TPU the Pallas pair
is opt-in, on the card the kernels are the path. `use_kernel=False` runs
the plain step loop of `torch.matmul` on any device. cuDNN's `nn.LSTM` is
not used. Weights keep torch's names and its [i|f|g|o] gate packing so
reference checkpoints load unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from . import cuda_lstm
from .nn import uniform_
from .numerics import matmul


class LSTMWeights(nn.Module):
    """The parameters of a one-layer bidirectional `nn.LSTM`, under its
    names (`weight_ih_l0`, ..., `bias_hh_l0_reverse`)."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for suffix in ("", "_reverse"):
            self.register_parameter(
                f"weight_ih_l0{suffix}", nn.Parameter(torch.empty(4 * hidden, input_size))
            )
            self.register_parameter(
                f"weight_hh_l0{suffix}", nn.Parameter(torch.empty(4 * hidden, hidden))
            )
            self.register_parameter(f"bias_ih_l0{suffix}", nn.Parameter(torch.empty(4 * hidden)))
            self.register_parameter(f"bias_hh_l0{suffix}", nn.Parameter(torch.empty(4 * hidden)))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """torch nn.LSTM default init: every tensor U(-1/sqrt(H), 1/sqrt(H))."""
        bound = 1.0 / math.sqrt(self.hidden)
        for p in self.parameters():
            uniform_(p, -bound, bound, generator)

    def direction(self, reverse: bool):
        s = "_reverse" if reverse else ""
        return (getattr(self, f"weight_ih_l0{s}"), getattr(self, f"weight_hh_l0{s}"),
                getattr(self, f"bias_ih_l0{s}"), getattr(self, f"bias_hh_l0{s}"))


def bilstm_forward(
    weights: LSTMWeights,
    x: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the biLSTM over time-major `x: (T, B, F)`.

    Returns `(output (T, B, 2H), hidden (2, B, H), cell (2, B, H))` in
    torch's layout: output concatenates [fwd, bwd] per step, time-aligned;
    hidden/cell stack the final state of each direction (fwd first), all in
    `x`'s type (the recurrence computes in float32, JAX `ops/lstm.py:84-99`).
    `(h0, c0)`, each `(2, B, H)`, seed the two directions.
    `use_kernel=False` takes the plain recurrence on any device.
    """
    w_ih_f, w_hh_f, b_ih_f, b_hh_f = weights.direction(reverse=False)
    w_ih_b, w_hh_b, b_ih_b, b_hh_b = weights.direction(reverse=True)
    # input projections hoisted out of the recurrence
    xg_f = matmul(x, w_ih_f.T) + b_ih_f  # (T, B, 4H)
    xg_b = matmul(x, w_ih_b.T) + b_ih_b
    w_hhT = torch.stack([w_hh_f.T, w_hh_b.T])  # (2, H, 4H)
    b_hh = torch.stack([b_hh_f, b_hh_b])
    zeros = x.new_zeros((2, x.shape[1], weights.hidden))
    ys_f, ys_b, cs_f, cs_b = cuda_lstm.bilstm_recurrence(
        xg_f, xg_b, w_hhT, b_hh, zeros if h0 is None else h0, zeros if c0 is None else c0,
        out_dtype=x.dtype, use_kernel=use_kernel)
    output = torch.cat([ys_f, ys_b], dim=-1)
    # final states: the fwd stream ends at T-1, the bwd stream at 0
    return output, torch.stack([ys_f[-1], ys_b[0]]), torch.stack([cs_f[-1], cs_b[0]])
