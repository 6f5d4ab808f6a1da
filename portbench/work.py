"""Work counts: the least time of each hand kernel's work at a cell's shapes
(its roofline bound) and the model's floating-point operations a step.

The bound counts the kernel's inputs read once and its outputs written once
at the HBM rate, or its float32 operations and `expf` at their peak rates,
whichever is longer. Rates: the H100 SXM data sheet (HBM3 3.35 TB/s,
float32 outside the tensor cores 67 TFLOP/s); the SFU's `expf` rate is 16
results a clock an SM on compute capability 9.0 x 132 SMs x the 1.98 GHz
boost clock.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
EXPF_PER_S = 16 * 132 * 1.98e9
F32 = 4


def bound(n_bytes: float, n_flop: float, n_expf: float) -> Tuple[float, str]:
    """Least time in ms: the bytes at the HBM rate, or the float32
    operations and the expf at their peak rates, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_flop / FP32_FLOP_PER_S, n_expf / EXPF_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def lstm_work(t_len: int, b: int, hidden: int, backward: bool):
    """(bytes, flop, transcendentals) of one B6 or B7 call on both
    directions: each input read once and each output written once; the
    recurrent products (one per step forward; gate recompute, dh and dW
    backward) at 2 flop per FMA plus ~14 (forward) or ~30 (backward)
    operations and 5 or 6 expf/tanhf per (direction, t, row, unit)."""
    units = 2 * t_len * b * hidden
    gates, seqs = 2 * t_len * b * 4 * hidden, t_len * b * hidden
    weights = 2 * hidden * 4 * hidden + 2 * 4 * hidden
    states = 2 * 2 * b * hidden
    fma = units * 4 * hidden
    if not backward:  # xg in; ys, cs out
        return F32 * (gates + weights + states + 4 * seqs), 2 * fma + 14 * units, 5 * units
    # xg, w, h0/c0, ys/cs and their cotangents in; dxg, dW, db, dh0/dc0 out
    n_bytes = F32 * (gates + weights + states + 4 * seqs + 4 * seqs + gates + weights + states)
    return n_bytes, 3 * 2 * fma + 30 * units, 6 * units


def select_work(rows: int, t_len: int):
    """The fake-sample select: the bits in, n_valid and k in, the mask out;
    integer work only."""
    return rows * t_len * (4 + 1) + rows * 8, 0, 0


def sci_forward_work(b: int, c: int, t_len: int, r: int, n_obs: float):
    """The SCI forward over one stream of b encounters: ob, t and mask in,
    the (b, R, 3C) grid out; ~12 operations and 2 expf per observed slot and
    reference point."""
    return 3 * b * c * t_len * F32 + b * r * 3 * c * F32, 12 * r * n_obs, 2 * r * n_obs


def sci_backward_work(b: int, c: int, t_len: int, r: int, n_obs: float):
    """The SCI backward as the step calls it (dalpha only): the forward's
    reads and the cotangent in, a partial dalpha a row out; ~23 operations
    and 2 expf per observed slot and reference point."""
    return (3 * b * c * t_len * F32 + b * r * 3 * c * F32 + b * c * F32,
            23 * r * n_obs, 2 * r * n_obs)


def rbf_work(b: int, c: int, t_len: int, r: int, n_obs: float):
    """The gaussian RBF push: t, mask and the (b, C, R) values in, (b, C, T)
    out; ~7 operations and 1 expf per observed slot and reference point."""
    return 3 * b * c * t_len * F32 + b * c * r * F32, 7 * r * n_obs, r * n_obs


@dataclass
class Shapes:
    """A step's shapes: the batch, channels, slots, reference points, the
    LSTM and head widths, the streams through the encoder (real, fake and
    the triplet positive) and the mean observed slots of an encounter."""
    b: int
    c: int
    t: int
    r: int
    hidden: int
    head_hidden: int
    streams: int
    obs_per_encounter: float
    clusters: int = 0


def _sum(*works):
    return tuple(sum(w[i] for w in works) for i in range(3))


def hand_forward_work(s: Shapes):
    """The hand kernels' work of one forward (the eval pass's batch): the
    select, one SCI forward a stream, the RBF push, B6 on the encoder's rows
    and on the decoder's."""
    n_obs = s.b * s.obs_per_encounter
    return _sum(select_work(s.b * s.c, s.t),
                *[sci_forward_work(s.b, s.c, s.t, s.r, n_obs)] * s.streams,
                rbf_work(s.b, s.c, s.t, s.r, n_obs),
                lstm_work(s.r, s.streams * s.b, s.hidden, False),
                lstm_work(s.r, s.b, s.hidden, False))


def hand_step_work(s: Shapes):
    """The hand kernels' work of one train step: the forward's, one SCI
    backward a stream, and B7 on the encoder's and the decoder's rows."""
    n_obs = s.b * s.obs_per_encounter
    return _sum(hand_forward_work(s),
                *[sci_backward_work(s.b, s.c, s.t, s.r, n_obs)] * s.streams,
                lstm_work(s.r, s.streams * s.b, s.hidden, True),
                lstm_work(s.r, s.b, s.hidden, True))


def bound_ms(work) -> float:
    return bound(*work)[0]


def model_flops(s: Shapes, train: bool = True) -> float:
    """The model's floating-point operations for one batch, counted from the
    shapes: the biLSTMs (input projections, recurrent products, ~14 gate
    operations a unit), the heads' products, CCI's mixing, SCI's ~12 and
    the RBF push's ~7 operations per observed slot and reference point.
    A train step adds the backward: twice each product, ~30 gate operations
    a unit in place of 14, 23 for SCI's and 14 for the push's. No
    recompute is counted; the losses and the optimizer are left out (under
    0.1% at the paper's widths)."""
    h, r, c, hh = s.hidden, s.r, s.c, s.head_hidden
    enc_rows, dec_rows = s.streams * s.b, s.b
    n_obs = s.b * s.obs_per_encounter

    def lstm(rows, feat):  # (products, gate operations) forward, both directions
        return 2 * r * rows * 2 * (feat + h) * 4 * h, 2 * r * rows * h

    enc_mm, enc_units = lstm(enc_rows, 3 * c)
    dec_mm, dec_units = lstm(dec_rows, 2 * h)
    heads = (2 * s.b * r * (2 * h * hh + hh * c)  # CompressFC, a row a reference point
             + 2 * s.b * (2 * h * hh + hh * c)  # future vitals
             + 2 * 2 * s.b * (2 * h * hh + hh * 2))  # fake detection over real and fake
    cci_mm = 2 * enc_rows * r * c * c
    dec_head = 3 * 2 * s.b * s.clusters * 2 * h if s.clusters else 0
    products = enc_mm + dec_mm + heads + cci_mm + dec_head
    units = enc_units + dec_units
    pointwise_f = 12 * r * n_obs * s.streams + 7 * r * n_obs
    if not train:
        return products + 14 * units + pointwise_f
    pointwise_b = 23 * r * n_obs * s.streams + 14 * r * n_obs
    return 3 * products + 44 * units + pointwise_f + pointwise_b
