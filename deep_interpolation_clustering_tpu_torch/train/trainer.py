"""A lean p1 trainer (counterpart of the JAX `train/trainer.py`).

It keeps the training cohort on the device, gathers each batch there and
runs the shuffled batches through `steps.train_step`. Every encounter trains
once per epoch: a short final batch is padded to the full batch by
repeating its real rows and trained as one masked step (`sample_mask` 1 on
the real rows), as the JAX `_tail_train_step` does; the reference has no
`drop_last`. The learning rate follows `optim.LRSchedule`, stepped whenever
an epoch ends. Checkpoints, dumps and early stop come with the full trainer
(ROADMAP.md, queue A).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..data.loader import ArrayDataset
from ..models.net import Net
from ..utils.device import resolve_device
from .optim import LRSchedule, make_optimizer, set_learning_rate
from .steps import eval_step, gather_batch, train_step

log = logging.getLogger("dicl.torch")


class Trainer:
    """Interpolation-autoencoder pretraining on one device: the card unless
    `device="cpu"`."""

    def __init__(self, cfg: Config, datasets: Dict[str, ArrayDataset],
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.datasets = datasets
        self.device = resolve_device(device)
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.net = Net(cfg, generator=init_gen).to(self.device)
        self.opt = make_optimizer(cfg, self.net.parameters())
        self.lr_schedule = LRSchedule(cfg)
        # batch draws (fake select bits and noise, permutation, dropout)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._cohorts: Dict[str, Dict[str, torch.Tensor]] = {}
        self.cohort_data("training")  # uploaded once, kept on the device
        self.epoch = 1
        log.info("trainable params: %d; train samples: %d",
                 sum(p.numel() for p in self.net.parameters()), len(datasets["training"]))

    def cohort_data(self, cohort: str) -> Dict[str, torch.Tensor]:
        if cohort not in self._cohorts:
            self._cohorts[cohort] = {
                k: torch.as_tensor(v, device=self.device)
                for k, v in self.datasets[cohort].arrays().items()
            }
        return self._cohorts[cohort]

    def _epoch_batches(self, epoch: int) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        """The epoch's shuffled batches as (index tensor, sample mask) on the
        device. Full batches have no mask; a short final batch is padded to
        the batch size by cyclically repeating its real rows (finite values
        everywhere, as the JAX `_tail_train_step`), its mask 1 on them."""
        n, bs = len(self.datasets["training"]), self.cfg.batch_size
        order = np.arange(n)
        np.random.RandomState(self.cfg.seed + epoch).shuffle(order)
        n_full = n // bs * bs
        idx = torch.as_tensor(order[:n_full], device=self.device)
        batches = [(i, None) for i in idx.reshape(-1, bs)]
        if n_full < n:
            mask = torch.zeros(bs, dtype=torch.float32, device=self.device)
            mask[: n - n_full] = 1.0
            tail = torch.as_tensor(np.resize(order[n_full:], bs), device=self.device)
            batches.append((tail, mask))
        return batches

    def step(self, idx: torch.Tensor, sample_mask: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One train step on the encounters `idx`; `sample_mask` (B,) leaves
        the padded rows of a tail batch out of the losses and BatchNorm."""
        batch = gather_batch(self.cohort_data("training"), idx)
        if sample_mask is not None:
            batch["sample_mask"] = sample_mask
        return train_step(self.net, self.opt, self.cfg, batch, self.generator,
                          self.cfg.denoise)

    def _end_epoch(self, valid_loss: Optional[float] = None) -> None:
        """Advance the epoch and give the optimizer the schedule's next rate
        ('plateau' raises without a validation loss)."""
        set_learning_rate(self.opt, self.lr_schedule.step(valid_loss))
        self.epoch += 1

    def _stream(self) -> Iterator[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
        while True:
            yield from self._epoch_batches(self.epoch)
            self._end_epoch()

    def train_steps(self, n: int) -> List[Dict[str, torch.Tensor]]:
        """Take `n` steps over the shuffled epochs; the losses stay on the
        device."""
        stream = self._stream()
        return [self.step(*next(stream)) for _ in range(n)]

    def train_one_epoch(self, valid_loss: Optional[float] = None) -> Dict[str, float]:
        """One epoch over every training encounter; returns the mean losses
        over its batches (the masked tail counts as one, as in JAX). Then
        the learning-rate schedule steps; `valid_loss` is the validation
        loss that the 'plateau' mode steps on (the caller computes it)."""
        if self.cfg.lr_decay_mode == "plateau" and valid_loss is None:
            raise ValueError("lr_decay_mode='plateau' needs train_one_epoch(valid_loss=...)")
        losses = [self.step(*b) for b in self._epoch_batches(self.epoch)]
        self._end_epoch(valid_loss)
        return {k: float(torch.stack([l[k] for l in losses]).mean()) for k in losses[0]}

    def eval_batch(self, cohort: str = "validation",
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Eval forward of one batch (the first `batch_size` encounters
        unless `idx` is given); returns the (B, 2H) latents."""
        data = self.cohort_data(cohort)
        if idx is None:
            n = min(self.cfg.batch_size, len(self.datasets[cohort]))
            idx = torch.arange(n, device=self.device)
        _, outputs = eval_step(self.net, self.cfg, gather_batch(data, idx),
                               self.generator, self.cfg.denoise)
        return outputs["hidden"]
