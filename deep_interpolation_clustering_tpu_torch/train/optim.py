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

On a CUDA device the optimizer is one that a CUDA graph can step
(`train/graphs.py`): the rate is a 0-d device tensor that
`set_learning_rate` writes in place, so a captured step reads each epoch's
rate, and the step count lives on the device. Adam is torch's
`capturable=True` one, given float64 step counts (`card_adam_state`): it
then takes the bias corrections 1 - beta^t in double precision, as the
default Adam does on the host, and its state and update are the CPU's to
rounding. With its float32 step counts it takes beta^t in float32, where
0.999 is 0.99900001: 1 - beta2^t comes out 1.3e-5 too small and every
step 6.4e-6 too long, the same way for every element; torch's fused Adam
takes (1 - beta2) in float32 instead, which leaves its second moments
1.3e-5 below the CPU's. SGD is `fused=True` (the foreach one would read a
tensor rate to the host); RMSprop, which has no bias correction, is
`capturable=True`. Captured and uncaptured steps on the card use this
same optimizer. On the CPU the rate stays a float and the optimizers are
torch's defaults.

On the card `steps.update` steps the Adam with the hand-written kernel
pair of `ops/cuda_optim.py` (`clip_adam_step_`): the global-norm clip, the
decay and the amsgrad update over every leaf in two launches, in the
capturable Adam's arithmetic on its float64 step counts, on the
optimizer's own state tensors. Elsewhere (the CPU, SGD, RMSprop,
`use_kernels=False`) it runs `clip_grad_global_norm_` and `opt.step()`.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..config import Config
from ..ops.cuda_optim import clip_adam_


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    params = list(params)
    wd = cfg.weight_decay_rate
    lr, card = cfg.init_lr, {}
    on_card = bool(params) and params[0].device.type == "cuda"
    if on_card:
        lr = torch.tensor(cfg.init_lr, dtype=torch.float32, device=params[0].device)
        card = {"sgd": dict(fused=True)}.get(cfg.optimizer, dict(capturable=True))
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=wd, amsgrad=True, **card)
        if on_card:
            for p in params:
                opt.state[p] = card_adam_state(p)
        return opt
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, nesterov=True,
                               weight_decay=wd, **card)
    if cfg.optimizer == "rmsprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8, momentum=0.9,
                                   weight_decay=wd, **card)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def card_adam_state(p: torch.Tensor, step: float = 0.0) -> dict:
    """A fresh state of the card's amsgrad Adam for `p` at `step`: zero
    moments and a float64 step count on `p`'s device (the capturable Adam
    takes its bias corrections in the step count's dtype)."""
    zeros = lambda: torch.zeros_like(p, memory_format=torch.preserve_format)  # noqa: E731
    return {"step": torch.tensor(step, dtype=torch.float64, device=p.device),
            "exp_avg": zeros(), "exp_avg_sq": zeros(), "max_exp_avg_sq": zeros()}


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


def clip_adam_step_(opt: torch.optim.Optimizer, max_norm: Optional[float]) -> torch.Tensor:
    """`clip_grad_global_norm_` (when `max_norm`) then `opt.step()` for the
    one-group amsgrad Adam of `make_optimizer`, as the kernel pair of
    `ops/cuda_optim.py` over the parameters that have a gradient, on the
    optimizer's state in place. On the card it takes only the card's state
    (a float32 rate tensor, float64 step counts, float32 parameters) and
    raises on any other. Returns the global norm."""
    group = opt.param_groups[0]
    if len(opt.param_groups) != 1 or not group["amsgrad"] or group["maximize"]:
        raise ValueError("clip_adam_step_ takes the one-group amsgrad Adam of make_optimizer")
    leaves = []
    for p in group["params"]:
        if p.grad is not None:
            st = opt.state[p]
            leaves.append((p, p.grad, st["exp_avg"], st["exp_avg_sq"], st["max_exp_avg_sq"],
                           st["step"]))
    beta1, beta2 = group["betas"]
    hyper = (max_norm or 0.0, group["weight_decay"], beta1, beta2, group["eps"])
    norm = torch.empty((), dtype=torch.float32, device=leaves[0][0].device)
    return clip_adam_(norm, leaves, group["lr"], hyper)


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """Give every param group the rate: in place into a tensor rate (no host
    sync; a captured step reads it), else as the float."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
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
