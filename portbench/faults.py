"""Faults planted in the program underneath a run, to read what the
comparison makes of them (`calibrate.py --fault`, the CPU tests): each is
a function of pytest's `monkeypatch`-like `setattr(obj, name, value)`.

  state_unchanged  the step computes its losses and leaves the weights and
                   the optimizer's state as they were
  half_batch       the step's losses, moments and gradients over the first
                   half of the batch alone (a sample mask of ones there)
  altered_loss     the step's reported loss moved by one part in a
                   thousand where it is produced

A one-chip cell has no exchange between chips to leave out.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def state_unchanged(setattr: Callable) -> None:
    from deep_interpolation_clustering_tpu_torch.train import steps

    def update(net, opt, cfg, inputs, generator, use_kernels=True):
        _, losses = steps.forward_and_losses(net, cfg, inputs, True, generator, use_kernels,
                                             steps.compute_params(net, cfg))
        return {k: v.detach().to(torch.float32) for k, v in losses.items()}
    setattr(steps, "update", update)


def half_batch(setattr: Callable) -> None:
    from deep_interpolation_clustering_tpu_torch.train import trainer

    inner = trainer.train_step

    def train_step(net, opt, cfg, batch, generator, denoise=False):
        if "sample_mask" not in batch:
            b = batch["ob"].shape[0]
            mask = torch.zeros(b, device=batch["ob"].device)
            mask[:b // 2] = 1.0
            batch = dict(batch, sample_mask=mask)
        return inner(net, opt, cfg, batch, generator, denoise)
    setattr(trainer, "train_step", train_step)


def altered_loss(setattr: Callable) -> None:
    from deep_interpolation_clustering_tpu_torch.train import steps

    inner = steps.update

    def update(*args, **kwargs):
        losses = inner(*args, **kwargs)
        losses["loss"] = losses["loss"] * (1.0 + 1e-3)
        return losses
    setattr(steps, "update", update)


FAULTS: Dict[str, Callable] = {"state_unchanged": state_unchanged, "half_batch": half_batch,
                               "altered_loss": altered_loss}
