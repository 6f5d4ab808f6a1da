"""Optimizer and gradient clip (counterpart of the JAX `train/optim.py`).

The JAX package emulates torch's optimizers (reference utils.py:77-99) with
optax: `clip_by_global_norm`, then L2 weight decay folded into the
gradient, then `Adam(amsgrad=True)` (`scale_by_torch_amsgrad`), SGD
(`trace(0.9, nesterov=True)`) or RMSprop (`scale_by_rms(0.99, 1e-8,
eps_in_sqrt=False)` then `trace(0.9)`). The port uses torch's optimizers
themselves, with `weight_decay` (folded into the gradient after the clip,
which `steps.update` applies first). torch's momentum buffer starts at the
first gradient where optax's trace starts at zero; with dampening 0 both
give that gradient as the first step's momentum. `LRSchedule` is the JAX
package's epoch-level rate controller; the trainer writes its rate into the
optimizer's param groups.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..config import Config


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    wd = cfg.weight_decay_rate
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.init_lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=wd, amsgrad=True)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.init_lr, momentum=0.9, nesterov=True,
                               weight_decay=wd)
    if cfg.optimizer == "rmsprop":
        return torch.optim.RMSprop(params, lr=cfg.init_lr, alpha=0.99, eps=1e-8, momentum=0.9,
                                   weight_decay=wd)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


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


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


class LRSchedule:
    """Epoch-level learning-rate controller (the JAX `LRSchedule`, equal to
    the float). `step(valid_loss)` is called once per completed epoch; `lr`
    is the rate for the next epoch, already clamped to `min_lr`.

      step     init_lr * rate^(e // step)
      warmup   a linear ramp to `warmup_multiplier` x init_lr over
               `warmup_epochs`, then back to init_lr (the measured behaviour
               of the reference's warm-up scheduler handing off to StepLR:
               the hand-off writes the stale pre-warm-up rate, and StepLR's
               epoch counter starts there), decaying at
               e = warmup_epochs + 1 + k * step
      plateau  torch's ReduceLROnPlateau defaults (mode min, relative
               threshold 1e-4): x rate once more than `patience` epochs in a
               row fail to improve; needs the validation loss
    """

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.lr = cfg.init_lr
        self.num_steps = 0
        self._best = float("inf")
        self._num_bad = 0

    def step(self, valid_loss: Optional[float] = None) -> float:
        cfg = self.cfg
        mode = cfg.lr_decay_mode
        if mode == "plateau" and valid_loss is None:
            raise ValueError("lr_decay_mode='plateau' steps on a validation loss: "
                             "pass valid_loss")
        self.num_steps += 1
        e = self.num_steps  # completed epochs
        if mode == "step":
            k = e // cfg.lr_decay_step_or_patience
            self.lr = cfg.init_lr * cfg.lr_decay_rate**k
        elif mode == "warmup":
            m, total = cfg.warmup_multiplier, cfg.warmup_epochs
            if e <= total:
                self.lr = cfg.init_lr * (1.0 + (m - 1.0) * e / total)
            else:
                k = (e - total - 1) // cfg.lr_decay_step_or_patience
                self.lr = cfg.init_lr * cfg.lr_decay_rate**k
        elif mode == "plateau":
            if valid_loss < self._best * (1.0 - 1e-4):
                self._best = valid_loss
                self._num_bad = 0
            else:
                self._num_bad += 1
            if self._num_bad > cfg.lr_decay_step_or_patience:
                self.lr = self.lr * cfg.lr_decay_rate
                self._num_bad = 0
        else:
            raise ValueError(f"unknown lr_decay_mode {mode!r}")
        if self.lr < cfg.min_lr:
            self.lr = cfg.min_lr
        return self.lr

    def state_dict(self) -> dict:
        """Checkpointable state, under the JAX package's keys: 'step' and
        'warmup' recompute the rate from `num_steps`, 'plateau' needs its
        best loss and bad-epoch count."""
        return {"lr": self.lr, "num_steps": self.num_steps, "best": self._best,
                "num_bad": self._num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.num_steps = int(d["num_steps"])
        self._best = float(d["best"])
        self._num_bad = int(d["num_bad"])
