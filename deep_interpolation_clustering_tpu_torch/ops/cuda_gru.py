"""mTAN's GRUs (`nn.GRU`, one layer, `batch_first`, h0 zero, one or two
directions) as a hand-written kernel pair G1 and its plain PyTorch version.

  G1 `mtan_gru_fwd` (csrc/gru.cu)  the forward walk over every step and
                                   direction, W_hh held on chip throughout
  G1 `mtan_gru_bwd` (csrc/gru.cu)  the reverse walk: the gates' gradients

No Pallas kernel stands behind them: the JAX package has no GRU. They
replace cuDNN, which `nn.GRU` is on the card. The math is `nn.GRU`'s, gate
order [r|z|n]:

    xg = x W_ih^T + b_ih                      (every step at once, here)
    r  = sigmoid(xg_r + (h W_hr^T + b_hr))    z likewise
    n  = tanh(xg_n + r * (h W_hn^T + b_hn))
    h' = n + z * (h - n)

with direction 1 walking the steps in reverse and the outputs time-aligned.
The walks take the input projections `xg` (B, T, D, 3H), W_hh (D, 3H, H)
and b_hh (D, 3H). The forward returns h at every step (B, T, D, H) and what
the backward takes (`saved`, (B, T, D, SAVED, H): r, z, n, h W_hn^T + b_hn
and the step's h_prev; none where no gradient is wanted). The backward
takes the outputs' cotangent and returns the gates' pre-activation
gradients twice, (B, T, D, 3H) each: the input side's [dr|dz|dn] (which is
dxg) and the recurrent side's [dr|dz|dn * r]. Everything else is a large
product outside the kernels: x W_ih^T here, dx and dW_ih by autograd
through it, and dW_hh = dgh^T h_prev and db_hh in `GRURecurrence.backward`.

`gru(module, x)` is the entry the model calls; the `nn.GRU` module only
holds the parameters. The kernels take H <= MAX_HIDDEN, float32. Each call
of either kernel adds one to the tracer's counter `mtan.gru_launches`, also
while a CUDA graph captures it and on each replay of one
(`_cuda_build.KernelWrapper`).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from . import _cuda_build as cb

# csrc/gru.cu's constants
MAX_HIDDEN = 256  # kMaxHidden
SMALL_HIDDEN = 64  # kSmallHidden: up to it one block holds every unit
CLUSTER_UNITS = 32  # kClusterUnits: the units of a cluster's block above it
SAVED = 5  # kSaved: r, z, n, h W_hn^T + b_hn, h_prev
COUNTER = "mtan.gru_launches"


def geometry(hidden: int) -> Tuple[int, int]:
    """(blocks a cluster, units a block) of the walks at width `hidden`, as
    csrc/gru.cu has them: one block of SMALL_HIDDEN units up to
    SMALL_HIDDEN, a cluster of CLUSTER_UNITS-unit blocks above (H a multiple
    of 4 there)."""
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"mtan_gru: takes 1 <= H <= {MAX_HIDDEN}, got {hidden}")
    if hidden <= SMALL_HIDDEN:
        return 1, SMALL_HIDDEN
    if hidden % 4:
        raise ValueError(f"mtan_gru: takes H > {SMALL_HIDDEN} in multiples of 4, got {hidden}")
    return -(-hidden // CLUSTER_UNITS), CLUSTER_UNITS


# ------------------------------------------------------------ plain versions
def _fwd_plain(xg, w_hh, b_hh, save: bool = True):
    """A step loop of matmuls; differentiable by autograd, which is how
    `use_kernel=False` runs it."""
    b, t_len, dirs, g3 = xg.shape
    hidden = g3 // 3
    outs, saves = [], []
    for d in range(dirs):
        h = xg.new_zeros((b, hidden))
        steps = [None] * t_len
        kept = [None] * t_len
        for s in range(t_len):
            t = s if d == 0 else t_len - 1 - s
            gh = torch.matmul(h, w_hh[d].T) + b_hh[d]
            x = xg[:, t, d]
            r = torch.sigmoid(x[:, :hidden] + gh[:, :hidden])
            z = torch.sigmoid(x[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
            hn = gh[:, 2 * hidden:]
            n = torch.tanh(x[:, 2 * hidden:] + r * hn)
            h_prev, h = h, n + z * (h - n)
            steps[t] = h
            if save:
                kept[t] = torch.stack([r, z, n, hn, h_prev], dim=1)
        outs.append(torch.stack(steps, dim=1))
        if save:
            saves.append(torch.stack(kept, dim=1))
    out = torch.stack(outs, dim=2)
    return out, (torch.stack(saves, dim=2) if save else None)


def _bwd_plain(dout, saved, w_hh):
    b, t_len, dirs, hidden = dout.shape
    dxg = dout.new_empty((b, t_len, dirs, 3 * hidden))
    dgh = torch.empty_like(dxg)
    for d in range(dirs):
        dh = dout.new_zeros((b, hidden))
        for s in reversed(range(t_len)):
            t = s if d == 0 else t_len - 1 - s
            r, z, n, hn, h_prev = saved[:, t, d].unbind(1)
            dh = dh + dout[:, t, d]
            dn = dh * (1.0 - z)
            dz = dh * (h_prev - n)
            dn_pre = dn * (1.0 - n * n)
            dz_pre = dz * (z * (1.0 - z))
            dr_pre = (dn_pre * hn) * (r * (1.0 - r))
            rec = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=1)
            dxg[:, t, d] = torch.cat([dr_pre, dz_pre, dn_pre], dim=1)
            dgh[:, t, d] = rec
            dh = dh * z + torch.matmul(rec, w_hh[d])
    return dxg, dgh


# ------------------------------------------------------------------ launches
_rows: Dict[tuple, Tuple[int, int]] = {}


def rows_per_cluster(hidden: int, batch: int, dirs: int, backward: bool) -> Tuple[int, int]:
    """The batch rows a cluster walks and the clusters the card holds at
    once at them (csrc/gru.cu `dicl_gru_rows`: of the multiples of 8 up to
    48 whose shared memory fits, the fewest waves of clusters times the rows
    a step), once for each shape and device."""
    key = (torch.cuda.current_device(), hidden, batch, dirs, backward)
    if key not in _rows:
        got = (ctypes.c_int * 2)()
        fn = cb.c_function("gru", "dicl_gru_rows", 1, 4)
        cb.raise_on_error("mtan_gru rows", fn(ctypes.addressof(got), hidden, batch, dirs,
                                              int(backward), None))
        _rows[key] = (got[0], got[1])
    return _rows[key]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it where it does not start on 16 bytes (the
    clusters move four floats at once)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _shape(name: str, t: torch.Tensor):
    b, t_len, dirs, width = t.shape
    if not 1 <= dirs <= 2:
        raise ValueError(f"{name}: one or two directions, got {dirs}")
    return b, t_len, dirs, width


def _fwd_launch(xg, w_hh, b_hh, save: bool = True):
    b, t_len, dirs, g3 = _shape("mtan_gru_fwd", xg)
    hidden = g3 // 3
    cluster, units = geometry(hidden)
    cb.check("mtan_gru_fwd xg", xg, torch.float32, (b, t_len, dirs, 3 * hidden))
    cb.check("mtan_gru_fwd w_hh", w_hh, torch.float32, (dirs, 3 * hidden, hidden))
    cb.check("mtan_gru_fwd b_hh", b_hh, torch.float32, (dirs, 3 * hidden))
    out = torch.empty((b, t_len, dirs, hidden), dtype=torch.float32, device=xg.device)
    saved = (torch.empty((b, t_len, dirs, SAVED, hidden), dtype=torch.float32,
                         device=xg.device) if save else None)
    rows, _ = rows_per_cluster(hidden, b, dirs, False)
    xg = _aligned(xg)
    fn = cb.c_function("gru", "dicl_gru_forward", 5, 7)
    cb.raise_on_error("mtan_gru_fwd", fn(
        cb.ptr(xg), cb.ptr(w_hh), cb.ptr(b_hh), cb.ptr(out), cb.ptr(saved), b, t_len, dirs,
        hidden, cluster, units, rows, cb.stream_of(xg)))
    return out, saved


def _bwd_launch(dout, saved, w_hh):
    b, t_len, dirs, hidden = _shape("mtan_gru_bwd", dout)
    cluster, units = geometry(hidden)
    cb.check("mtan_gru_bwd dout", dout, torch.float32, (b, t_len, dirs, hidden))
    cb.check("mtan_gru_bwd saved", saved, torch.float32, (b, t_len, dirs, SAVED, hidden))
    cb.check("mtan_gru_bwd w_hh", w_hh, torch.float32, (dirs, 3 * hidden, hidden))
    dxg = torch.empty((b, t_len, dirs, 3 * hidden), dtype=torch.float32, device=dout.device)
    dgh = torch.empty_like(dxg)
    rows, _ = rows_per_cluster(hidden, b, dirs, True)
    dout, saved = _aligned(dout), _aligned(saved)
    fn = cb.c_function("gru", "dicl_gru_backward", 5, 7)
    cb.raise_on_error("mtan_gru_bwd", fn(
        cb.ptr(dout), cb.ptr(saved), cb.ptr(w_hh), cb.ptr(dxg), cb.ptr(dgh), b, t_len, dirs,
        hidden, cluster, units, rows, cb.stream_of(dout)))
    return dxg, dgh


_SOURCE = "deep_interpolation_clustering_tpu_torch/csrc/gru.cu"
# no Pallas kernel: the JAX package has no GRU
_REPLACES = "none; nn.GRU (cuDNN) of mTAN's models.py (github.com/reml-lab/mTAN)"

gru_fwd = cb.register(cb.KernelWrapper("mtan_gru_fwd", _SOURCE, _REPLACES, _fwd_plain,
                                       _fwd_launch, COUNTER))
gru_bwd = cb.register(cb.KernelWrapper("mtan_gru_bwd", _SOURCE, _REPLACES, _bwd_plain,
                                       _bwd_launch, COUNTER))


# --------------------------------------------------------- autograd function
class GRURecurrence(torch.autograd.Function):
    """G1's pair: xg (B, T, D, 3H), w_hh (D, 3H, H), b_hh (D, 3H) -> h at
    every step (B, T, D, H). Gradients go to all three. `save=False` (no
    gradient wanted: the eval forward) writes nothing for the backward."""

    @staticmethod
    def forward(ctx, xg, w_hh, b_hh, save: bool):
        out, saved = gru_fwd(xg, w_hh, b_hh, save)
        ctx.save_for_backward(saved, w_hh)
        return out

    @staticmethod
    def backward(ctx, g):
        saved, w_hh = ctx.saved_tensors
        dxg, dgh = gru_bwd(g.contiguous(), saved, w_hh)
        dirs = w_hh.shape[0]
        # dW_hh and db_hh: products and sums over every (b, t) row, in the
        # libraries' fixed orders; each direction's rows are strided views
        rows_g = dgh.flatten(0, 1)  # (B T, D, 3H)
        rows_h = saved[:, :, :, SAVED - 1].flatten(0, 1)  # (B T, D, H): h_prev
        dw = torch.stack([torch.matmul(rows_g[:, d].T, rows_h[:, d]) for d in range(dirs)])
        db = rows_g.sum(dim=0)
        return dxg, dw, db, None


def _parameters(module: nn.GRU):
    if module.num_layers != 1 or not module.batch_first or not module.bias \
            or module.proj_size:
        raise ValueError("mtan_gru: takes a one-layer batch_first nn.GRU with biases")
    sfx = ("", "_reverse")[:2 if module.bidirectional else 1]
    get = lambda name: [getattr(module, f"{name}_l0{s}") for s in sfx]  # noqa: E731
    return (torch.cat(get("weight_ih")), torch.cat(get("bias_ih")),
            torch.stack(get("weight_hh")), torch.stack(get("bias_hh")))


def gru(module: nn.GRU, x: torch.Tensor, use_kernel: bool = True
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`module(x)` with h0 zero: the outputs (B, T, D H) and the last states
    (D, B, H), through G1 on the card and its plain version on the CPU.
    `use_kernel=False`: the plain forward on any device, differentiated by
    autograd."""
    w_ih, b_ih, w_hh, b_hh = _parameters(module)
    b, t_len, _ = x.shape
    dirs, hidden = w_hh.shape[0], w_hh.shape[2]
    xg = F.linear(x, w_ih, b_ih).reshape(b, t_len, dirs, 3 * hidden)
    if use_kernel:
        save = torch.is_grad_enabled() and any(t.requires_grad for t in (xg, w_hh, b_hh))
        out = GRURecurrence.apply(xg, w_hh, b_hh, save)
    else:
        out, _ = _fwd_plain(xg, w_hh, b_hh, False)
    last = [out[:, t_len - 1, 0]] + ([out[:, 0, 1]] if dirs == 2 else [])
    return out.reshape(b, t_len, dirs * hidden), torch.stack(last)
