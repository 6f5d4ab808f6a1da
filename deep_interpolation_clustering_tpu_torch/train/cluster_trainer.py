"""The p3 DEC fine-tuning trainer (counterpart of the JAX
`train/cluster_trainer.py`, reference clustering_trainer.py:21-545).

  * Centre init: a partial restore of the p1 checkpoint (every p1 leaf;
    the DEC head keeps its init), the training latents from one eval pass
    kept on the device, k-means there (`kmeans_n_init` restarts) and its
    centres written into the existing `cluster_centers` parameter, so the
    optimizer built over it goes on stepping it (its Adam moments start at
    zero, as the JAX package's do). `random` draws the centres uniformly in
    each latent dimension's range.
  * Epochs: the p1 step with the KL term; after each epoch the validation
    cohort's cluster labels are predicted again, and `delta`, the share of
    changed labels, is a monitored checkpoint metric and the stopping rule
    (`stopping_mode`, every `update_interval`-th epoch). The argmax and
    the changed-label count run on the device; the host reads one integer.

Data-parallel, the latents and labels come from the trainer's gathered eval
dumps (every rank holds the whole cohort's), rank 0 fits the centres and
broadcasts them, so every rank steps the same centres and counts the same
label delta.

This is the JAX loop's branch without the fused epoch (`fused_epoch=False`
there): a validation pass every epoch for the delta, and every
`eval_interval`-th epoch (and at the last) the schedule step, checkpoints
and summary row of `aly_pred`. The JAX fused epoch's deferred and pipelined
cadence (`pipeline_delta`) is not ported (ROADMAP.md A2).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import parallel
from ..cluster.kmeans import fit_kmeans_impl, kmeans_predict
from ..compat import jax_from_state_dict, state_dict_from_jax
from ..config import Config
from ..data.loader import ArrayDataset
from ..info import COHORT2SCOPE
from ..utils.logging import logger, timer
from . import checkpoint as ckpt
from .trainer import Trainer, _fmt


class ClusterTrainer(Trainer):
    """DEC fine-tuning from the p1 run at `pretrain_exp_path`, on the card
    unless `device="cpu"`."""

    clustering = True

    def __init__(self, cfg: Config, datasets: Dict[str, ArrayDataset], exp_path: str,
                 pretrain_exp_path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(cfg, datasets, exp_path, device=device)
        self.pretrain_exp_path = pretrain_exp_path

    @property
    def restore_metric(self) -> str:
        # DEC checkpoints restore on their own metric (reference p3:29)
        return self.cfg.dc_restore_metric

    # ------------------------------------------------------ centre init
    def load_pretrain_weight(self) -> None:
        """Every leaf of the p1 checkpoint whose path and shape this model
        has, copied into the live parameters and buffers (reference
        clustering_trainer.py:431-447)."""
        path = os.path.join(self.pretrain_exp_path, "weight", self.cfg.restore_metric,
                            ckpt.CKPT_NAME)
        _, p_params, p_state, _, _ = ckpt.load_checkpoint(path)
        params, state = jax_from_state_dict(self.net.state_dict())
        params, loaded = ckpt.partial_restore(params, p_params)
        state, _ = ckpt.partial_restore(state, p_state)
        # load_state_dict copies into the existing tensors: the optimizer
        # keeps stepping the parameters the net uses
        self.net.load_state_dict(state_dict_from_jax(params, state), strict=True)
        logger.info("=> loaded %d pretrain leaves from %s", len(loaded), path)

    def generate_pretrain_feat(self, cohort: str, denoise: bool = False) -> torch.Tensor:
        """The (n, 2H) latents of `cohort` in dataset order, on the device."""
        metrics, dumps = self.eval_one_epoch(COHORT2SCOPE[cohort], self.datasets[cohort],
                                             denoise, dump_keys=("hidden",), device_dumps=True)
        logger.info("%s %s", cohort, _fmt(metrics))
        return dumps["hidden"][0]

    def init_centers(self) -> Optional[torch.Tensor]:
        """Restore p1, fit the centres and write them into the net; returns
        the validation cohort's labels under them (None for `random` and
        `none`)."""
        cfg = self.cfg
        mode = cfg.init_cluster_center
        if mode == "none":
            return None
        self.load_pretrain_weight()
        hidden = self.generate_pretrain_feat("training")
        if mode not in ("kmeans", "random"):
            raise ValueError(f"unknown init_cluster_center {mode!r}")
        # rank 0 fits, every rank takes its centres
        centers = torch.empty((cfg.cluster_number, hidden.shape[-1]), dtype=torch.float32,
                              device=self.device)
        if self.main:
            if mode == "kmeans":
                if cfg.kmeans_impl == "sklearn":  # the NumPy mirror fits host arrays
                    hidden = hidden.cpu().numpy()
                fitted = fit_kmeans_impl(cfg, cfg.seed, hidden, cfg.cluster_number,
                                         n_init=cfg.kmeans_n_init).centers
            else:
                hidden = hidden.cpu().numpy()
                lo, hi = hidden.min(axis=0), hidden.max(axis=0)
                rng = np.random.RandomState(cfg.seed)
                fitted = rng.uniform(lo, hi, size=(cfg.cluster_number, hidden.shape[-1]))
            centers = torch.as_tensor(fitted, dtype=torch.float32, device=self.device)
        parallel.broadcast_([centers])
        valid_prev = None
        if mode == "kmeans":
            valid_prev = kmeans_predict(centers, self.generate_pretrain_feat("validation"))
        with torch.no_grad():
            self.net.cluster_assignment.cluster_centers.copy_(centers)
        logger.info("***** cluster initialize %s done *****", mode)
        return valid_prev

    # ----------------------------------------------------------- epochs
    def generate_pred_cluster(self, scope: str, ds: ArrayDataset,
                              prev_pred: Optional[torch.Tensor], denoise: bool = False
                              ) -> Tuple[float, Optional[int], torch.Tensor, Dict[str, float]]:
        """One eval pass over `ds`: the labels (argmax of `cluster_pred`, on
        the device), and `delta`, the share of them that changed from
        `prev_pred` (1.0 without one). Returns (delta, n_changed, labels,
        metrics); the count is the one value the host reads."""
        metrics, dumps = self.eval_one_epoch(scope, ds, denoise, dump_keys=("cluster_pred",),
                                             device_dumps=True)
        labels = torch.argmax(dumps["cluster_pred"][0], dim=1)
        if prev_pred is None:
            return 1.0, None, labels, metrics
        n_changed = int(torch.sum(labels != prev_pred))
        return n_changed / prev_pred.shape[0], n_changed, labels, metrics

    def _should_stop(self, delta: float, n_changed: Optional[int]) -> Optional[str]:
        """The stop reason under `stopping_mode`, or None: "delta" is the
        reference's fraction rule (clustering_trainer.py:118-124), "count"
        and "patience" the ones that still fire on large cohorts."""
        cfg = self.cfg
        if cfg.stopping_mode == "delta":
            if cfg.stopping_delta is not None and delta < cfg.stopping_delta:
                return f'label delta "{delta:1.5f}" < "{cfg.stopping_delta:1.5f}"'
        elif cfg.stopping_mode == "count":
            if n_changed is not None and n_changed <= cfg.stopping_count:
                return f"changed-label count {n_changed} <= {cfg.stopping_count}"
        else:  # patience on the running delta minimum
            if delta < self._best_delta:
                self._best_delta = delta
                self._since_improve = 0
            else:
                self._since_improve += 1
                if self._since_improve >= cfg.stopping_patience:
                    return (f'delta minimum "{self._best_delta:1.5f}" unimproved '
                            f"for {self._since_improve} checks")
        return None

    def train(self) -> Dict[str, float]:
        """Centre init, then the DEC epochs until `max_epochs` or a stop;
        returns the last validation metrics (with `delta`)."""
        cfg = self.cfg
        valid_ds = self.datasets["validation"]
        valid_prev = self.init_centers()
        last_valid: Dict[str, float] = {}
        self._best_delta = float("inf")
        self._since_improve = 0
        self.delta_history = []
        with timer("Duration of training"):
            while self.epoch < cfg.max_epochs:
                is_eval = (cfg.eval_interval <= 1 or self.epoch % cfg.eval_interval == 0
                           or self.epoch + 1 >= cfg.max_epochs)
                logger.info("==> Epoch %d train %s", self.epoch, _fmt(self.train_one_epoch()))
                delta, n_changed, valid_pred, valid_metrics = self.generate_pred_cluster(
                    "valid", valid_ds, valid_prev)
                logger.info("Epoch %d: valid delta of label change: %s", self.epoch, delta)
                valid_metrics["delta"] = delta
                if is_eval:
                    last_valid = valid_metrics
                    self.aly_pred("valid", valid_metrics)
                elif cfg.lr_decay_mode != "plateau":
                    # plateau steps on a validation loss, at evals only
                    self._step_schedule(None)
                self.delta_history.append(delta)
                if self.epoch % cfg.update_interval == 0:
                    stop_msg = self._should_stop(delta, n_changed)
                    if stop_msg:
                        if not is_eval:
                            # a stop between evals: the stopping epoch's
                            # row and checkpoint candidacy (aly_pred's,
                            # without stepping the schedule again)
                            valid_metrics["lr"] = self.lr_schedule.lr
                            self.summary.add_summary(self.epoch, scope="valid",
                                                     **valid_metrics)
                            last_valid = valid_metrics
                            self._ckpt_candidacy(valid_metrics)
                        logger.info("Early stopping as %s.", stop_msg)
                        break
                    valid_prev = valid_pred
                self.epoch += 1
        return last_valid
