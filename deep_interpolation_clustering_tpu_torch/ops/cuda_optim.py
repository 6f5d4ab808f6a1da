"""The train step's optimizer tail in two launches (counterpart of the JAX
`_flat_params_wrapper`, train/optim.py, which runs the tail on one raveled
parameter vector).

`clip_adam_(norm, leaves, lr, hyper)` takes every parameter leaf with its
gradient and its amsgrad Adam state (`exp_avg`, `exp_avg_sq`,
`max_exp_avg_sq`, a float64 `step`) and, in place: clips the gradients by
their global norm (scaled by `max_norm / norm` when the norm is at least
`max_norm`, as `optax.clip_by_global_norm`: no `+1e-6`; no clip at
`max_norm` 0), folds the L2 weight decay into them, and takes PyTorch's
capturable amsgrad Adam step with the float64 step counts, operation by
operation (`csrc/optim.cu` says which). It writes the global norm into
`norm`, a float32 () tensor, and returns it.

On CUDA tensors it is one wrapper over the two kernels of `csrc/optim.cu`,
counted once a call as B7's four are: `optim_partials_kernel` (each block's sum
of g*g over its tile of `TILE` elements of one leaf, into its own slot, and
each leaf's step count advanced), then `optim_update_kernel` (the global
norm from every slot in one fixed order, then clip, decay, moments and
parameter). At most `MAX_LEAVES` leaves travel with one launch; more take
both kernels once for each group of them. The plain version, for CPU
tensors, does the same arithmetic with PyTorch operations over the same
tiles. No kernel symbol holds a name of the model's hand kernels
(`fake_select`, `sci_`, `rbf_`, `lstm_`), whose bound the benchmark's
roofline counts.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from . import _cuda_build as cb

# csrc/optim.cu's constants
TILE = 2048  # kTile: elements of one leaf a block
MAX_LEAVES = 48  # kMaxLeaves: leaves a launch

# (param, grad, exp_avg, exp_avg_sq, max_exp_avg_sq, step)
Leaf = Tuple[torch.Tensor, ...]
# (max_norm, weight_decay, beta1, beta2, eps); max_norm 0 for no clip
Hyper = Tuple[float, float, float, float, float]


@torch.no_grad()
def _clip_adam_plain(norm: torch.Tensor, leaves: Sequence[Leaf], lr: float,
                     hyper: Hyper) -> torch.Tensor:
    max_norm, wd, beta1, beta2, eps = hyper
    # each tile's float32 sum, then their sum in double, as the kernels
    sums = [(piece * piece).sum() for _, g, *_ in leaves for piece in g.reshape(-1).split(TILE)]
    norm.copy_(torch.stack(sums).double().sum().sqrt())
    clip = max_norm > 0 and bool(norm >= max_norm)
    for p, g, m, v, vmax, step in leaves:
        step.add_(1)
        if clip:
            g.copy_(g / norm * max_norm)
        d = torch.add(g, p, alpha=wd) if wd != 0 else g
        m.lerp_(d, 1 - beta1)
        v.mul_(beta2).addcmul_(d, d, value=1 - beta2)
        torch.maximum(vmax, v, out=vmax)
        # the bias corrections in double, rounded to float32 where they divide
        t = float(step)
        step_size = float(np.float32(1.0 / ((beta1 ** t - 1.0) / float(lr))))
        bc2_sqrt = float(np.float32(math.sqrt(-(beta2 ** t - 1.0))))
        p.add_(m / ((vmax.sqrt() / bc2_sqrt + eps) / step_size))
    return norm


def _clip_adam_launch(norm: torch.Tensor, leaves: Sequence[Leaf], lr: torch.Tensor,
                      hyper: Hyper) -> torch.Tensor:
    cb.check("clip_adam norm", norm, torch.float32, ())
    if not isinstance(lr, torch.Tensor):
        raise ValueError(f"clip_adam: the rate must be a float32 () tensor on the card, "
                         f"got {type(lr).__name__}")
    cb.check("clip_adam lr", lr, torch.float32, ())
    if not leaves:
        raise ValueError("clip_adam: no leaves")
    # the leaves' addresses and sizes, (n, 7) int64 on the host, as the C entry reads them
    rows = []
    for i, (p, *rest, step) in enumerate(leaves):
        for what, t in zip(("param", "grad", "exp_avg", "exp_avg_sq", "max_exp_avg_sq"),
                           (p, *rest)):
            cb.check(f"clip_adam leaf {i} {what}", t, torch.float32, p.shape)
        cb.check(f"clip_adam leaf {i} step", step, torch.float64, ())
        if any(t.device != norm.device for t in (p, *rest, step)):
            raise ValueError(f"clip_adam: leaf {i} is not on {norm.device}")
        rows.append([cb.ptr(t) for t in (p, *rest, step)] + [p.numel()])
    table = torch.tensor(rows, dtype=torch.int64)
    partials = torch.empty(sum(-(-p.numel() // TILE) for p, *_ in leaves),
                           dtype=torch.float32, device=norm.device)
    fn = cb.c_function("optim", "dicl_clip_adam", 4, 1, 5)
    cb.raise_on_error("clip_adam", fn(
        cb.ptr(table), cb.ptr(partials), cb.ptr(norm), cb.ptr(lr), len(leaves),
        *(float(x) for x in hyper), cb.stream_of(norm)))
    return norm


clip_adam_ = cb.register(cb.KernelWrapper(
    "clip_adam", "deep_interpolation_clustering_tpu_torch/csrc/optim.cu",
    # no Pallas kernel: the JAX package leaves its flat optimizer to XLA
    "none; deep_interpolation_clustering_tpu/train/optim.py:80 in XLA",
    _clip_adam_plain, _clip_adam_launch))
