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
label delta. NCCL ranks replay the DEC step's graphs as one card does (the
target's cluster frequencies summed over ranks inside them), with the
deferred cadence and `pipeline_delta` below; gloo ranks step.

The loop is the JAX one (clustering_trainer.py `train`): a validation pass
every epoch for the delta, and every `eval_interval`-th epoch (and at the
last) the schedule step, checkpoints and summary row of `aly_pred`. With
`eval_interval > 1` and the fused epoch, the cadence is deferred: the
epochs between evals are dispatched with no host read but the
changed-label count (counted on the device), their train and validation
losses fetched at the next eval, where their summary rows are written. With
`pipeline_delta` too, that count is read one epoch late, while the next
epoch runs; when the late count stops the run, the speculative epoch is
rolled back (`_snapshot`: the parameters, buffers, optimizer state, the
generator's state and the update count, written back in place), so the stop
epoch, the delta history and the weights are those of the unlagged loop.
A stop between evals makes the stopping epoch's weights checkpoint
candidates (`stop_candidacy`), as in JAX.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import parallel
from ..cluster.kmeans import fit_kmeans_impl, kmeans_predict
from ..compat import jax_from_state_dict, state_dict_from_jax
from ..config import Config
from ..data.loader import ArrayDataset
from ..info import COHORT2SCOPE
from ..utils import tracing
from ..utils.logging import logger, timer
from . import checkpoint as ckpt
from .graphs import restore_, snapshot
from .trainer import Trainer, _fmt


def _host_means(metrics: Dict[str, object]) -> Dict[str, float]:
    """Each metric as a host float: a float as it is, per-batch losses on
    the device (a deferred eval's) by their mean over batches, one host
    read each."""
    tracing.count("host_reads", sum(not isinstance(v, float) for v in metrics.values()))
    return {k: v if isinstance(v, float)
            else float(np.mean(torch.as_tensor(v).cpu().numpy(), dtype=np.float64))
            for k, v in metrics.items()}


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
        `none`). The span `init`: `init.restore`, the training cohort's eval
        pass, `init.kmeans`, the validation cohort's and `init.predict`."""
        cfg = self.cfg
        mode = cfg.init_cluster_center
        if mode == "none":
            return None
        with tracing.span("init"):
            with tracing.span("init.restore"):
                self.load_pretrain_weight()
            hidden = self.generate_pretrain_feat("training")
            if mode not in ("kmeans", "random"):
                raise ValueError(f"unknown init_cluster_center {mode!r}")
            # rank 0 fits, every rank takes its centres
            centers = torch.empty((cfg.cluster_number, hidden.shape[-1]), dtype=torch.float32,
                                  device=self.device)
            with tracing.span("init.kmeans"):
                if self.main:
                    if mode == "kmeans":
                        if cfg.kmeans_impl == "sklearn":  # the NumPy mirror fits host arrays
                            hidden = hidden.cpu().numpy()
                            tracing.count("host_reads")
                        fitted = fit_kmeans_impl(cfg, cfg.seed, hidden, cfg.cluster_number,
                                                 n_init=cfg.kmeans_n_init).centers
                    else:
                        hidden = hidden.cpu().numpy()
                        tracing.count("host_reads")
                        lo, hi = hidden.min(axis=0), hidden.max(axis=0)
                        rng = np.random.RandomState(cfg.seed)
                        fitted = rng.uniform(lo, hi, size=(cfg.cluster_number, hidden.shape[-1]))
                    centers = torch.as_tensor(fitted, dtype=torch.float32, device=self.device)
                parallel.broadcast_([centers])
            valid_prev = None
            if mode == "kmeans":
                hidden = self.generate_pretrain_feat("validation")
                with tracing.span("init.predict"):
                    valid_prev = kmeans_predict(centers, hidden)
            with torch.no_grad():
                self.net.cluster_assignment.cluster_centers.copy_(centers)
            logger.info("***** cluster initialize %s done *****", mode)
            return valid_prev

    # ----------------------------------------------------------- epochs
    def _dispatch_pred_cluster(self, scope: str, ds: ArrayDataset,
                               prev_pred: Optional[torch.Tensor], denoise: bool = False,
                               defer_losses: bool = False):
        """One eval pass over `ds` for the labels (argmax of `cluster_pred`)
        and the count of them that changed from `prev_pred`, both left on
        the device (JAX `_dispatch_pred_cluster`). Returns (count or None,
        labels, metrics); with `defer_losses` the metrics of a fused pass
        are its per-batch losses on the device."""
        with tracing.span("delta"):
            metrics, dumps = self.eval_one_epoch(scope, ds, denoise,
                                                 dump_keys=("cluster_pred",),
                                                 device_dumps=True, defer_losses=defer_losses)
            labels = torch.argmax(dumps["cluster_pred"][0], dim=1)
            count = None if prev_pred is None else torch.sum(labels != prev_pred)
        return count, labels, metrics

    @staticmethod
    def _resolve_delta(count: Optional[torch.Tensor], n_rows: Optional[int]
                       ) -> Tuple[float, Optional[int]]:
        """(delta, n_changed) from a dispatched count: the one host read of a
        DEC epoch (1.0, None without a previous prediction)."""
        if count is None:
            return 1.0, None
        with tracing.span("delta"):
            n_changed = int(count)
            tracing.count("host_reads")
        return n_changed / n_rows, n_changed

    def generate_pred_cluster(self, scope: str, ds: ArrayDataset,
                              prev_pred: Optional[torch.Tensor], denoise: bool = False,
                              defer_losses: bool = False
                              ) -> Tuple[float, Optional[int], torch.Tensor, Dict[str, float]]:
        """One eval pass over `ds`: the labels (argmax of `cluster_pred`, on
        the device), and `delta`, the share of them that changed from
        `prev_pred` (1.0 without one). Returns (delta, n_changed, labels,
        metrics); the count is the one value the host reads."""
        count, labels, metrics = self._dispatch_pred_cluster(scope, ds, prev_pred, denoise,
                                                             defer_losses)
        delta, n_changed = self._resolve_delta(
            count, None if prev_pred is None else int(prev_pred.shape[0]))
        return delta, n_changed, labels, metrics

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

    def _drained(self, epoch: int, valid_losses=None, delta=None) -> None:
        """A deferred DEC epoch's validation row: its losses, fetched now,
        with its delta (none for an epoch whose eval wrote its own)."""
        if valid_losses is None:
            return
        with tracing.span("fetch"):
            vm = _host_means(valid_losses)
        vm["delta"] = delta
        self.summary.add_summary(epoch, scope="valid", **vm)
        logger.info("Epoch %d valid %s", epoch, _fmt(vm))
        self._last_valid = vm

    def _snapshot(self):
        """What a dispatched epoch changes: device copies of the parameters,
        buffers and optimizer state, the generator's state and the update
        count (JAX `_snapshot` of the carries)."""
        return snapshot(self._mutable_state()), self.generator.get_state(), self.num_updates

    def _rollback(self, snap) -> None:
        """Undo the epochs dispatched since `snap`, in place (the captured
        graphs keep their addresses)."""
        tensors, gen_state, num_updates = snap
        restore_(tensors, self._mutable_state())
        self.generator.set_state(gen_state)
        self.num_updates = num_updates

    def _train(self) -> Dict[str, float]:
        """Centre init, then the DEC epochs until `max_epochs` or a stop;
        returns the last validation metrics (with `delta`). The JAX loop,
        with its deferred cadence under `eval_interval > 1` and the fused
        epoch, and `pipeline_delta`'s lagged count with its rollback
        (`train()` calls it inside the span `train`)."""
        cfg = self.cfg
        train_ds, valid_ds = self.datasets["training"], self.datasets["validation"]
        valid_prev = self.init_centers()
        self._last_valid: Dict[str, float] = {}
        self._best_delta = float("inf")
        self._since_improve = 0
        self.delta_history = []
        # deferred epochs: (epoch, train handles, n_batches, validation loss
        # handles, delta), drained at each eval (`_drain`, `_drained`)
        pending: List[tuple] = []
        # pipeline_delta: the one epoch whose count is dispatched, not read
        inflight: Optional[dict] = None

        def resolve_inflight():
            """Read the lagged epoch's count; log, record and test it as the
            unlagged loop does at that epoch. Returns (stop reason, epoch)."""
            nonlocal inflight
            rec, inflight = inflight, None
            delta, n_changed = self._resolve_delta(rec["count"], rec["n_rows"])
            pending.append((rec["epoch"], rec["handles"], rec["nb"], rec["vh"], delta))
            logger.info("Epoch %d: valid delta of label change: %s", rec["epoch"], delta)
            self.delta_history.append(delta)
            stop_msg = None
            if rec["epoch"] % cfg.update_interval == 0:
                stop_msg = self._should_stop(delta, n_changed)
            return stop_msg, rec["epoch"]

        def stop_candidacy(host_metrics=None, delta=None):
            """A stop between evals: the stopping epoch's weights become
            checkpoint candidates. A stepped epoch's metrics were never
            written: their row (with the rate) is written here; a deferred
            epoch's row was written by `_drain`."""
            if host_metrics is not None:
                vm = _host_means(host_metrics)
                vm["delta"] = delta
                vm["lr"] = self.lr_schedule.lr
                self.summary.add_summary(self.epoch, scope="valid", **vm)
                self._last_valid = vm
            if self._last_valid:
                self._ckpt_candidacy(self._last_valid)

        with timer("Duration of training"):
            while self.epoch < cfg.max_epochs:
                with tracing.span("epoch", epoch=self.epoch):
                    is_eval = (cfg.eval_interval <= 1 or self.epoch % cfg.eval_interval == 0
                               or self.epoch + 1 >= cfg.max_epochs)
                    defer = cfg.eval_interval > 1 and self._can_fuse(train_ds)
                    # at an eval nothing would hide the lagged read: resolve it
                    # first, so that a stop cancels this epoch entirely
                    if inflight is not None and is_eval:
                        stop_msg, stopped_epoch = resolve_inflight()
                        if stop_msg:
                            self.epoch = stopped_epoch
                            self._drain(pending)
                            stop_candidacy()
                            logger.info("Early stopping as %s.", stop_msg)
                            break
                    if defer:
                        n_batches = train_ds.num_batches(cfg.batch_size)
                        rollback = None
                        if cfg.pipeline_delta and not is_eval:
                            rollback = self._snapshot()
                        handles = self._dispatch_fused_epoch()
                    else:
                        logger.info("==> Epoch %d train %s", self.epoch,
                                    _fmt(self.train_one_epoch()))

                    if is_eval:
                        if defer:
                            pending.append((self.epoch, handles, n_batches, None, None))
                        self._drain(pending)
                        delta, n_changed, valid_pred, valid_metrics = self.generate_pred_cluster(
                            "valid", valid_ds, valid_prev)
                        logger.info("Epoch %d: valid delta of label change: %s", self.epoch, delta)
                        valid_metrics["delta"] = delta
                        self._last_valid = valid_metrics
                        self.aly_pred("valid", valid_metrics)
                    elif defer and cfg.pipeline_delta:
                        # dispatch this epoch's count, then read the last one's
                        # while the card works on this one
                        count, valid_pred, vh = self._dispatch_pred_cluster(
                            "valid", valid_ds, valid_prev, defer_losses=True)
                        rec = {"epoch": self.epoch, "count": count,
                               "n_rows": None if valid_prev is None else int(valid_prev.shape[0]),
                               "handles": handles, "nb": n_batches, "vh": vh}
                        if inflight is not None:
                            stop_msg, stopped_epoch = resolve_inflight()
                            if stop_msg:
                                # the speculative epoch is undone: the weights
                                # are those after the stopping epoch
                                self._rollback(rollback)
                                self.epoch = stopped_epoch
                                self._drain(pending)
                                stop_candidacy()
                                logger.info("Early stopping as %s.", stop_msg)
                                break
                        inflight = rec
                        if self.epoch % cfg.update_interval == 0:
                            valid_prev = valid_pred
                        if cfg.lr_decay_mode != "plateau":
                            self._step_schedule(None)
                        self.epoch += 1
                        continue
                    else:
                        delta, n_changed, valid_pred, vh = self.generate_pred_cluster(
                            "valid", valid_ds, valid_prev, defer_losses=True)
                        if defer:
                            pending.append((self.epoch, handles, n_batches, vh, delta))
                        logger.info("Epoch %d: valid delta of label change: %s", self.epoch, delta)
                        # plateau steps on a validation loss, at evals only
                        if cfg.lr_decay_mode != "plateau":
                            self._step_schedule(None)
                    self.delta_history.append(delta)

                    if self.epoch % cfg.update_interval == 0:
                        stop_msg = self._should_stop(delta, n_changed)
                        if stop_msg:
                            self._drain(pending)
                            if not is_eval:  # an eval's stop ran aly_pred already
                                stop_candidacy(None if defer else vh, delta)
                            logger.info("Early stopping as %s.", stop_msg)
                            break
                        valid_prev = valid_pred
                    self.epoch += 1
            if inflight is not None:  # the last epoch is an eval, which resolved it
                resolve_inflight()
            self._drain(pending)
        return self._last_valid
