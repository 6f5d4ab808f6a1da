"""p0 tail in NumPy: train-mean imputation, hold-out masks and min-max
normalization (the port's own copy of the JAX `data/preprocess.py` helpers
behind `process_splits`, reference p0_data_process.py:72-204). Observations
are front-packed per (encounter, channel): slot k holds the k-th
observation, `padding_mask` marks real entries.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..info import MIN_MAX_VALUES, USE_FEATURES


def mean_imputation(
    vitals: np.ndarray, mask: np.ndarray, pre_mean: Optional[np.ndarray] = None
) -> np.ndarray:
    """Channels with zero observations get one synthetic observation at t=0
    valued at the training-set channel mean (reference p0:72-93; modifies
    `vitals`/`mask` in place, same contract). Vectorized over (N, C)."""
    if pre_mean is not None:
        mean_values = pre_mean
    else:
        counts = mask.sum(axis=(0, 2))
        mean_values = (vitals * mask).sum(axis=(0, 2)) / counts
    empty = mask.sum(axis=2) == 0  # (N, C)
    n_idx, c_idx = np.nonzero(empty)
    mask[n_idx, c_idx, 0] = 1
    vitals[n_idx, c_idx, 0] = mean_values[c_idx]
    return mean_values


def hold_out(
    mask: np.ndarray, perc: float = 0.2, rng: Optional[np.random.RandomState] = None
) -> np.ndarray:
    """Zero `perc` of observed points per (encounter, channel) in the
    returned drop mask — only when `int(perc*count) > 1`, matching the
    reference's guard (p0:105-117). The reference's triple Python loop
    becomes a masked rank-and-threshold over random scores: taking the
    positions whose random-score rank falls below k is an exact uniform
    k-subset without replacement.
    """
    if rng is None:
        rng = np.random
    n, c, t = mask.shape
    counts = mask.sum(axis=2).astype(np.int64)  # (N, C)
    k = (perc * counts).astype(np.int64)
    k = np.where(k > 1, k, 0)  # guard: only drop when int(perc*count) > 1

    scores = rng.random_sample(mask.shape)
    scores = np.where(mask > 0, scores, np.inf)
    ranks = np.argsort(np.argsort(scores, axis=2), axis=2)  # rank among valid
    drop = ranks < k[:, :, None]

    drop_mask = (mask > 0).astype(mask.dtype) * np.where(drop, 0, 1).astype(mask.dtype)
    return drop_mask


def normalize_data(split_dict: Dict[str, Dict[str, np.ndarray]], norm_method: str = "minmax"):
    """Min-max to [0,1] per channel with fixed physiological ranges (reference
    p0:119-133); in place."""
    if norm_method != "minmax":
        raise NotImplementedError(norm_method)
    for i, feature in enumerate(USE_FEATURES):
        min_val, max_val = MIN_MAX_VALUES[feature]
        for cohort in split_dict:
            feat = split_dict[cohort]["feat"]
            feat[:, i, :] = (feat[:, i, :] - min_val) / (max_val - min_val)


def process_splits(
    split_dict: Dict[str, Dict[str, np.ndarray]],
    holdout_frac: float = 0.2,
    rng: Optional[np.random.RandomState] = None,
    norm_method: str = "minmax",
) -> Dict[str, Dict[str, np.ndarray]]:
    """Full p0 tail: train-mean imputation reused for valid/test, hold-out
    masks, min-max normalization (reference p0:187-204). Mutates and returns
    `split_dict`."""
    train = split_dict["training"]
    train_mean = mean_imputation(train["feat"], train["padding_mask"], pre_mean=None)
    for cohort in split_dict:
        if cohort in ("validation", "testing"):
            mean_imputation(
                split_dict[cohort]["feat"],
                split_dict[cohort]["padding_mask"],
                pre_mean=train_mean,
            )
        split_dict[cohort]["drop_mask"] = hold_out(
            split_dict[cohort]["padding_mask"], holdout_frac, rng
        )
    normalize_data(split_dict, norm_method)
    return split_dict
