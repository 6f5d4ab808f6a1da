"""Metric records: an `events.jsonl` stream and, when tensorboardX
imports, TensorBoard scalars and latent projector dumps (counterpart of
the JAX `train/summary.py`, reference utils.py:175-186). Scalars are
filtered to `METRICS` and `SUMMARY_ITEMS` and written with their scope and
step.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence

import numpy as np

from ..info import METRICS, SUMMARY_ITEMS
from ..utils import tracing
from ..utils.logging import logger


class Summary:
    """`enabled=False` (a data-parallel rank other than 0) writes nothing."""

    def __init__(self, log_dir: str, metric_items: Sequence[str] = METRICS,
                 summary_items: Sequence[str] = SUMMARY_ITEMS, enabled: bool = True):
        self.metric_items = set(metric_items)
        self.summary_items = set(summary_items)
        self.enabled = enabled
        self._jsonl = None
        self._tb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "events.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:  # optional, as in the JAX package
            return
        self._tb = SummaryWriter(log_dir)

    def add_summary(self, step: int, **kwargs) -> None:
        """One row of host values: the span `summary` (`utils.tracing`)."""
        if not self.enabled:
            return
        with tracing.span("summary"):
            scope = kwargs.get("scope", "")
            rec: Dict[str, float] = {}
            for k, v in kwargs.items():
                if k in self.metric_items or k in self.summary_items:
                    v = float(np.asarray(v))
                    rec[k] = v
                    if self._tb is not None:
                        self._tb.add_scalar(f"{scope}_{k}", v, global_step=step)
            if rec:
                rec.update(step=step, scope=scope)
                self._jsonl.write(json.dumps(rec) + "\n")
                self._jsonl.flush()

    def add_embedding(self, features: np.ndarray, step: int, tag: str) -> None:
        """Latent-space projector dump (reference pretrain_trainer.py:117);
        without tensorboardX only a log line, and a writer's error is
        swallowed, as in the JAX package."""
        if not self.enabled:
            return
        if self._tb is None:
            logger.info("add_embedding %s: tensorboardX is not installed, no projector "
                        "written", tag)
        else:
            try:
                self._tb.add_embedding(features, global_step=step, tag=tag)
            except Exception as e:  # the projector is optional: log and go on
                logger.warning("add_embedding %s failed: %r", tag, e)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
