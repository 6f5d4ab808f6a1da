"""A lean p1 trainer (counterpart of the JAX `train/trainer.py`).

It keeps the training cohort on the device, gathers each batch there and
runs shuffled full batches through `steps.train_step`. Checkpoints, dumps,
early stop, LR schedules and the padded-tail masked step come with the full
trainer (ROADMAP.md, queue A).
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..data.loader import ArrayDataset
from ..models.net import Net
from ..utils.device import resolve_device
from .optim import make_optimizer
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

    def _epoch_batches(self, epoch: int) -> List[torch.Tensor]:
        """The epoch's shuffled full batches (index tensors on the device)."""
        n, bs = len(self.datasets["training"]), self.cfg.batch_size
        order = np.arange(n)
        np.random.RandomState(self.cfg.seed + epoch).shuffle(order)
        idx = torch.as_tensor(order[: n // bs * bs], device=self.device)
        return list(idx.reshape(-1, bs))

    def step(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        batch = gather_batch(self.cohort_data("training"), idx)
        return train_step(self.net, self.opt, self.cfg, batch, self.generator,
                          self.cfg.denoise)

    def _stream(self) -> Iterator[torch.Tensor]:
        while True:
            for idx in self._epoch_batches(self.epoch):
                yield idx
            self.epoch += 1

    def train_steps(self, n: int) -> List[Dict[str, torch.Tensor]]:
        """Take `n` steps over the shuffled epochs; the losses stay on the
        device."""
        stream = self._stream()
        return [self.step(next(stream)) for _ in range(n)]

    def train_one_epoch(self) -> Dict[str, float]:
        """One epoch of full batches; returns the mean losses."""
        losses = [self.step(idx) for idx in self._epoch_batches(self.epoch)]
        self.epoch += 1
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
