"""Optimizer and gradient clip (counterpart of the JAX `train/optim.py`).

The JAX package emulates torch's `Adam(amsgrad=True)` with L2 weight decay
folded into the gradient (`scale_by_torch_amsgrad`, after
`clip_by_global_norm`); the port uses torch's optimizer itself. Only
'adam' is ported; the learning rate stays at `init_lr` (LR schedules come
with the full trainer).
"""

from __future__ import annotations

from typing import Iterable

import torch

from ..config import Config


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    if cfg.optimizer != "adam":
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is not ported yet")
    return torch.optim.Adam(
        params, lr=cfg.init_lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay_rate, amsgrad=True,
    )


def clip_grad_global_norm_(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale every gradient by `max_norm / norm` when the global norm is at
    least `max_norm`, exactly as `optax.clip_by_global_norm` does: no `+1e-6`
    in the denominator (torch's `clip_grad_norm_` adds one). Runs on the
    device without a host sync; returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(torch.sum(torch.stack([torch.sum(g * g) for g in grads])))
    keep = norm < max_norm
    with torch.no_grad():
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm
