"""Cluster-ID alignment by descending mean SBP (the port's own copy of the JAX
package's `cluster/align.py`, reference p4_clustering_final.py:63-139).

The canonical phenotype ordering that makes cluster labels stable across
cohorts and runs: training clusters are sorted by descending masked mean SBP
(channel 0 of the physical-unit `ob` planes), producing an `align_map`
old-id → new-id; validation/test labels are aligned by nearest training
center so the ordering relation cannot flip across cohorts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.logging import logger


def _n_clusters(labels: np.ndarray) -> int:
    return len(set(labels.tolist())) - (1 if -1 in labels else 0)


def _apply_map(labels: np.ndarray, align_map: Dict[int, int]) -> np.ndarray:
    """Relabel via pre-captured per-cluster index sets, so chained renames
    never collide (reference's cluster_idx capture, p4:82-98)."""
    labels = np.asarray(labels).copy()
    cluster_idx = {i: np.where(labels == i) for i in align_map}
    for org_id, new_id in align_map.items():
        labels[cluster_idx[org_id]] = new_id
    return labels


def generate_align_map(
    org_label: np.ndarray,
    ob: np.ndarray,
    padding: np.ndarray,
    feat: Optional[np.ndarray] = None,
) -> Tuple[Dict[int, int], np.ndarray, List[np.ndarray]]:
    """Order training clusters by descending masked mean SBP
    (reference p4:63-98). Returns (align_map, aligned_labels,
    aligned_feat_centers) — centers are computed from `feat` with the
    *aligned* labels when given (dbscan path)."""
    org_label = np.asarray(org_label).copy()
    sbp = ob[:, 0, :] * padding[:, 0, :]
    avg_sbp = np.sum(sbp, axis=1) / np.sum(padding[:, 0, :], axis=1)
    n = _n_clusters(org_label)

    cluster_sbp = [np.average(avg_sbp[org_label == i]) for i in range(n)]
    sorted_ids = np.argsort(cluster_sbp)[::-1]  # descending mean SBP
    align_map = {int(prev): cur for cur, prev in enumerate(sorted_ids)}
    align_map = {k: align_map[k] for k in sorted(align_map)}
    logger.info("align_map: %s", align_map)

    aligned = _apply_map(org_label, align_map)
    centers: List[np.ndarray] = []
    if feat is not None:
        centers = [np.mean(feat[aligned == i], axis=0) for i in range(n)]
    return align_map, aligned, centers


def align_labels(org_label: np.ndarray, align_map: Dict[int, int]) -> np.ndarray:
    """Apply a previously-computed align map (reference p4:101-110)."""
    return _apply_map(org_label, align_map)


def align_labels_with_center(
    org_feat: np.ndarray, org_label: np.ndarray, aligned_feat_centers
) -> np.ndarray:
    """Align a cohort's labels to the training centers by nearest-center
    matching; raises if the mapping is not a bijection (reference p4:113-139)."""
    org_label = np.asarray(org_label).copy()
    n = _n_clusters(org_label)
    org_centers = np.stack(
        [np.mean(org_feat[org_label == i], axis=0) for i in range(n)]
    )
    centers = np.stack(aligned_feat_centers)
    d = np.sqrt(
        np.maximum(
            (org_centers**2).sum(1)[:, None]
            - 2 * org_centers @ centers.T
            + (centers**2).sum(1)[None, :],
            0,
        )
    )
    min_idx = np.argmin(d, axis=1)
    if len(set(min_idx.tolist())) != n:
        raise ValueError("Different org_feat_centers map to a same train_feat_center")
    align_map = {int(i): int(j) for i, j in enumerate(min_idx)}
    logger.info("align_map: %s", align_map)
    return _apply_map(org_label, align_map)
