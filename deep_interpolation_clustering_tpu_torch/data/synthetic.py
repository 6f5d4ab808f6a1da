"""Synthetic clinical cohort generator.

The reference ships no data and no way to run without the (private) UF
cohort pickles; this module generates a statistically similar irregular
vital-sign cohort with planted phenotype structure so the whole p0->p4
pipeline is runnable and testable anywhere (BASELINE.json configs[0]): K
latent phenotypes with distinct vital profiles, per-channel observation
counts, jittered timestamps, hour-7 extreme values for the future-vital aux
task, and phenotype-correlated binary outcomes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..info import COHORTS, MIN_MAX_VALUES, USE_FEATURES

# per-phenotype channel means (physical units), spanning the clinical ranges
_PHENOTYPE_SHIFT = np.array(
    [
        # sbp, dbp, heartRate, temperature, spo2, respiratory
        [135.0, 80.0, 72.0, 36.8, 97.0, 15.0],  # stable
        [110.0, 65.0, 95.0, 37.8, 93.0, 22.0],  # febrile/tachycardic
        [90.0, 55.0, 115.0, 36.2, 88.0, 28.0],  # shock-like
        [150.0, 95.0, 60.0, 36.5, 98.0, 12.0],  # hypertensive
        [100.0, 60.0, 105.0, 38.5, 90.0, 25.0],  # septic
        [125.0, 72.0, 85.0, 37.2, 95.0, 18.0],  # intermediate
    ]
)

_CHANNEL_STD = np.array([12.0, 8.0, 9.0, 0.4, 2.0, 3.0])


def make_synthetic_cohorts(
    n_total: int = 1000,
    hours: float = 6.0,
    max_obs: int = 48,
    min_obs: int = 4,
    n_phenotypes: int = 4,
    missing_channel_prob: float = 0.02,
    seed: int = 7529,
    split: Tuple[float, float, float] = (0.7, 0.15, 0.15),
) -> Dict[str, Dict[str, np.ndarray]]:
    """Build raw (pre-p0-tail) cohort dicts keyed by cohort name.

    Each cohort dict carries the gridded planes (`feat`, `time_step`,
    `padding_mask`, `encounter_id`) in physical units, plus auxiliary arrays:
    `future_vital` (normalized hour-7 extremes with NaNs where unobserved),
    binary outcome labels, and the planted `true_phenotype`.
    """
    rng = np.random.RandomState(seed)
    shift = _PHENOTYPE_SHIFT[:n_phenotypes]
    c = len(USE_FEATURES)

    phenos = rng.randint(0, n_phenotypes, size=n_total)
    t_max = max_obs

    counts = rng.randint(min_obs, max_obs + 1, size=(n_total, c))
    # a small fraction of channels entirely missing (exercises mean imputation)
    counts[rng.rand(n_total, c) < missing_channel_prob] = 0

    # per-encounter slow drift so the series aren't iid noise
    drift_amp = rng.randn(n_total, c) * 0.5 * _CHANNEL_STD
    drift_phase = rng.rand(n_total, c) * 2 * np.pi
    base = shift[phenos] + rng.randn(n_total, c) * 0.5 * _CHANNEL_STD  # (N, C)

    # fully vectorized gridding: draw t_max candidates per (encounter,
    # channel), sort the first k into the front slots, mask the rest —
    # the 100k-encounter scaled cohort generates in seconds
    padding_mask = (
        np.arange(t_max)[None, None, :] < counts[:, :, None]
    ).astype(np.int8)
    ts_all = rng.rand(n_total, c, t_max) * hours
    ts_all = np.where(padding_mask > 0, ts_all, np.inf)
    ts_all = np.sort(ts_all, axis=2)  # valid stamps sorted, inf pushed back
    time_step = np.where(padding_mask > 0, ts_all, 0.0)

    vals = (
        base[:, :, None]
        + drift_amp[:, :, None]
        * np.sin(time_step / hours * 2 * np.pi + drift_phase[:, :, None])
        + rng.randn(n_total, c, t_max) * 0.6 * _CHANNEL_STD[None, :, None]
    )
    lo = np.array([MIN_MAX_VALUES[f][0] for f in USE_FEATURES])
    hi = np.array([MIN_MAX_VALUES[f][1] for f in USE_FEATURES])
    vals = np.clip(vals, lo[None, :, None], hi[None, :, None])
    feat = np.where(padding_mask > 0, vals, 0.0)

    # hour-7 extremes (min for sbp/dbp/spo2, max otherwise), ~90% observed
    nxt = base + rng.randn(n_total, c) * 0.3 * _CHANNEL_STD
    nxt = (np.clip(nxt, lo, hi) - lo) / (hi - lo)
    future_vital = np.where(rng.rand(n_total, c) < 0.9, nxt, np.nan)

    # phenotype-correlated binary outcomes
    sev = phenos / max(n_phenotypes - 1, 1)
    outcomes = {
        task: (rng.rand(n_total) < (0.05 + 0.4 * sev)).astype(np.int64)
        for task in ("AKI_overall", "mort_status_30d", "ICU")
    }

    # split into cohorts
    order = rng.permutation(n_total)
    n_train = int(split[0] * n_total)
    n_valid = int(split[1] * n_total)
    idx = {
        "training": order[:n_train],
        "validation": order[n_train : n_train + n_valid],
        "testing": order[n_train + n_valid :],
    }

    cohorts: Dict[str, Dict[str, np.ndarray]] = {}
    for cohort in COHORTS:
        sel = idx[cohort]
        d = dict(
            feat=feat[sel].copy(),
            time_step=time_step[sel].copy(),
            padding_mask=padding_mask[sel].copy(),
            encounter_id=[f"enc_{int(e):07d}" for e in sel],
            future_vital=future_vital[sel].copy(),
            true_phenotype=phenos[sel].copy(),
        )
        for task, arr in outcomes.items():
            d[task] = arr[sel].copy()
        cohorts[cohort] = d
    return cohorts
