"""p4 final labels (counterpart of the JAX `cluster/final.py`, reference
p4_clustering_final.py:43-309) over the p1 or p3 feature dumps:

  * `kmeans`    - k-means (`kmeans_n_init` restarts) on the training
                  latents on the device, the centres permuted by the
                  SBP-descending align map, every cohort labelled with the
                  aligned centres;
  * `consensus` - external consensus labels (CSV column `k{K}`) re-mapped
                  through the training align map (training and validation);
  * `dbscan`    - DBSCAN at `opt_eps` on each cohort's latents on the
                  device (`dbscan_impl`), min_samples the latent width;
                  training aligned by SBP, validation and test to the
                  training centroids by nearest-centre bijection;
  * `dl`        - the argmax of DEC's `cluster_pred` (or `cluster_label`).

Each path writes `out_feat/{metric}_{method}_aligned/{cohort}_{K}.npy`
dicts carrying `cluster_id` (`{cohort}_eps-{opt_eps}.npy` for dbscan), as
the JAX package does.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..info import COHORTS
from ..parallel import is_main_process
from ..utils.device import resolve_device
from ..utils.logging import logger
from .align import align_labels, align_labels_with_center, generate_align_map
from .dbscan import fit_dbscan_impl
from .kmeans import fit_kmeans_impl, kmeans_predict
from .optk import dbscan_quality

LOAD_KEYS = ("encounter_id", "hidden", "ob", "padding_mask")
DL_KEYS = ("cluster_pred", "cluster_label")


def load_feature_dumps(feat_path: str, dl_keys: bool = False) -> Dict[str, Dict]:
    """The `{cohort}.npy` dicts, kept to the keys p4 reads (with the DEC
    probabilities for the `dl` path)."""
    out = {}
    keys = LOAD_KEYS + (DL_KEYS if dl_keys else ())
    for cohort in COHORTS:
        full = np.load(os.path.join(feat_path, f"{cohort}.npy"), allow_pickle=True).item()
        out[cohort] = {k: full[k] for k in keys if k in full}
        logger.info("cohort %s: %d samples", cohort, len(out[cohort]["encounter_id"]))
    return out


def read_consensus_column(path: str, column: str) -> np.ndarray:
    """One column of a consensus CSV as integers when every value is one
    (float otherwise), as `pandas.read_csv` types it."""
    with open(path, newline="") as f:
        values = np.asarray([float(row[column]) for row in csv.DictReader(f)])
    if np.all(np.isfinite(values)) and np.all(values == np.round(values)):
        return values.astype(np.int64)
    return values


class FinalLabeler:
    """Final labels of a run directory's dumps, on the card unless
    `device="cpu"`."""

    def __init__(self, cfg: Config, exp_path: str,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.exp_path = exp_path
        self.device = resolve_device(device)

    def _out_path(self, metric: str) -> str:
        p = os.path.join(self.exp_path, "out_feat", f"{metric}_{self.cfg.cluster_method}_aligned")
        if is_main_process():  # under a multi-process launch rank 0 writes
            os.makedirs(p, exist_ok=True)
        return p

    def pred(self, metrics: Optional[List[str]] = None, seed: int = 0
             ) -> Dict[str, Dict[str, np.ndarray]]:
        """The configured path for each restore metric; returns {metric:
        {cohort: labels}} and writes the `{cohort}_{K}.npy` dumps."""
        method = self.cfg.cluster_method
        paths = {"kmeans": lambda d, p: self._pred_kmeans(d, p, seed),
                 "dbscan": self._pred_dbscan, "consensus": self._pred_consensus,
                 "dl": self._pred_dl}
        if method not in paths:
            raise ValueError(f"unknown cluster_method {method!r}")
        results: Dict[str, Dict[str, np.ndarray]] = {}
        for metric in metrics or ["ae_mse", "loss", "delta"]:
            feat_path = os.path.join(self.exp_path, "out_feat", metric)
            data = load_feature_dumps(feat_path, dl_keys=method == "dl")
            results[metric] = paths[method](data, self._out_path(metric))
        return results

    @staticmethod
    def _save(d: Dict, path: str) -> None:
        d.pop("ob", None)
        d.pop("padding_mask", None)
        if is_main_process():
            np.save(path, d)

    # ------------------------------------------------------------ kmeans
    def _pred_kmeans(self, data, out_path: str, seed: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        opt_k = cfg.num_clusters
        train = data["training"]
        latents = {c: torch.as_tensor(data[c]["hidden"], dtype=torch.float32,
                                      device=self.device) for c in COHORTS}
        fit_on = train["hidden"] if cfg.kmeans_impl == "sklearn" else latents["training"]
        result = fit_kmeans_impl(cfg, seed, fit_on, opt_k, n_init=cfg.kmeans_n_init)
        centers = torch.as_tensor(result.centers, dtype=torch.float32, device=self.device)
        train_raw = kmeans_predict(centers, latents["training"]).cpu().numpy()
        align_map, _, _ = generate_align_map(train_raw, train["ob"], train["padding_mask"])
        aligned = centers.clone()
        for org_id, new_id in align_map.items():
            aligned[new_id] = centers[org_id]
        out = {}
        for cohort in COHORTS:
            d = dict(data[cohort])
            # int32, as the JAX package's device predict gives them
            labels = kmeans_predict(aligned, latents[cohort]).to(torch.int32).cpu().numpy()
            d["cluster_id"] = labels
            self._save(d, os.path.join(out_path, f"{cohort}_{opt_k}.npy"))
            out[cohort] = labels
        return out

    # ------------------------------------------------------------ dbscan
    def _pred_dbscan(self, data, out_path: str) -> Dict[str, np.ndarray]:
        """Per-cohort DBSCAN (reference p4:175-239); min_samples is the
        latent width, as in the reference and JAX (p2's explorers take the
        width + 1)."""
        cfg = self.cfg
        out = {}
        train_centers = None
        for cohort in COHORTS:
            d = dict(data[cohort])
            feat = d["hidden"]
            x = torch.as_tensor(feat, dtype=torch.float32, device=self.device)
            raw, _ = fit_dbscan_impl(cfg, x, cfg.opt_eps, feat.shape[-1])
            if (raw < 0).all():
                raise ValueError(
                    f"dbscan found 0 clusters on '{cohort}' at eps={cfg.opt_eps}, "
                    f"min_samples={feat.shape[-1]} ({len(feat)} rows): raise --opt_eps "
                    "(use the p2 k-distance knee) or use a larger cohort")
            if cohort == "training":
                _, aligned, train_centers = generate_align_map(raw, d["ob"], d["padding_mask"],
                                                               feat)
            else:
                aligned = align_labels_with_center(feat, raw, train_centers)
            d["cluster_id"] = aligned
            logger.info("dbscan %s quality: %s", cohort, dbscan_quality(x, aligned))
            self._save(d, os.path.join(out_path, f"{cohort}_eps-{cfg.opt_eps}.npy"))
            out[cohort] = aligned
        return out

    # --------------------------------------------------------- consensus
    def _pred_consensus(self, data, out_path: str) -> Dict[str, np.ndarray]:
        """External consensus labels through the training align map
        (reference p4:241-287; training and validation, as there)."""
        opt_k = self.cfg.num_clusters
        raw_dir = os.path.join(self.exp_path, "out_feat", "raw_consensus_result")

        def read(cohort):
            lbl = read_consensus_column(os.path.join(raw_dir, f"{cohort}_consensus.csv"),
                                        f"k{opt_k}")
            if not np.any(lbl == 0):
                lbl -= 1  # 1-based -> 0-based
            return lbl

        train = data["training"]
        raw_labels = {"training": read("training"), "validation": read("validation")}
        align_map, _, _ = generate_align_map(raw_labels["training"], train["ob"],
                                             train["padding_mask"])
        out = {}
        for cohort in ("training", "validation"):
            d = dict(data[cohort])
            d["cluster_id"] = align_labels(raw_labels[cohort], align_map)
            self._save(d, os.path.join(out_path, f"{cohort}_{opt_k}.npy"))
            out[cohort] = d["cluster_id"]
        return out

    # ---------------------------------------------------------------- dl
    def _pred_dl(self, data, out_path: str) -> Dict[str, np.ndarray]:
        key = "cluster_label" if self.cfg.dl_cluster_label_type == "label" else "cluster_pred"
        out = {}
        for cohort in COHORTS:
            d = dict(data[cohort])
            prob = d[key]
            d["cluster_id"] = np.argmax(prob, axis=1)
            for k in DL_KEYS:
                d.pop(k, None)
            self._save(d, os.path.join(out_path, f"{cohort}_{prob.shape[1]}.npy"))
            out[cohort] = d["cluster_id"]
        return out
