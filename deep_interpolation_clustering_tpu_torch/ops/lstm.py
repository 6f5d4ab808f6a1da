"""Bidirectional one-layer LSTM in plain PyTorch (counterpart of the JAX
`ops/lstm.py::bilstm_forward`).

The recurrence is a Python loop of `torch.matmul` steps over the R=6
reference points, as the JAX default (`use_pallas_lstm=False`) leaves it to
XLA. cuDNN's `nn.LSTM` is not used. Weights keep torch's names and its
[i|f|g|o] gate packing so reference checkpoints load unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .nn import uniform_


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


def _run_direction(xg, w_hh, b_hh, h, c, reverse: bool):
    """Step one direction over pre-projected gates `xg: (T, B, 4H)`;
    returns the time-aligned outputs and the final (h, c)."""
    t_len = xg.shape[0]
    outs = [None] * t_len
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        # (x W_ih^T + b_ih) + h W_hh^T, then + b_hh: the JAX addition order
        gates = xg[t] + torch.matmul(h, w_hh.T) + b_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f)
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        outs[t] = h
    return torch.stack(outs), h, c


def bilstm_forward(
    weights: LSTMWeights,
    x: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the biLSTM over time-major `x: (T, B, F)`.

    Returns `(output (T, B, 2H), hidden (2, B, H), cell (2, B, H))` in
    torch's layout: output concatenates [fwd, bwd] per step, time-aligned;
    hidden/cell stack the final state of each direction (fwd first).
    `(h0, c0)`, each `(2, B, H)`, seed the two directions.
    """
    _, b_sz, _ = x.shape
    zeros = x.new_zeros((b_sz, weights.hidden))
    h0_f, h0_b = (zeros, zeros) if h0 is None else (h0[0], h0[1])
    c0_f, c0_b = (zeros, zeros) if c0 is None else (c0[0], c0[1])

    w_ih_f, w_hh_f, b_ih_f, b_hh_f = weights.direction(reverse=False)
    w_ih_b, w_hh_b, b_ih_b, b_hh_b = weights.direction(reverse=True)
    # input projections hoisted out of the recurrence
    xg_f = torch.matmul(x, w_ih_f.T) + b_ih_f  # (T, B, 4H)
    xg_b = torch.matmul(x, w_ih_b.T) + b_ih_b

    out_f, h_f, c_f = _run_direction(xg_f, w_hh_f, b_hh_f, h0_f, c0_f, reverse=False)
    out_b, h_b, c_b = _run_direction(xg_b, w_hh_b, b_hh_b, h0_b, c0_b, reverse=True)
    output = torch.cat([out_f, out_b], dim=-1)
    return output, torch.stack([h_f, h_b]), torch.stack([c_f, c_b])
