"""Global constants of the deep temporal interpolation-clustering framework.

Mirrors the constant surface of the reference (`info.py:1-41`): the vital-sign
feature list, cohort names, fixed physiological min/max normalization ranges,
and the monitored metric lists used by the per-metric best-checkpoint logic.
"""

from __future__ import annotations

# The six vital-sign channels, in canonical order (reference info.py:3).
USE_FEATURES = ("sbp", "dbp", "heartRate", "temperature", "spo2", "respiratory")

NUM_FEATURES = len(USE_FEATURES)

# Cohort split names (reference info.py:4).
COHORTS = ("training", "validation", "testing")

COHORT2SCOPE = {
    "training": "train",
    "validation": "valid",
    "testing": "test",
}

# Fixed physiological ranges used for min-max normalization — these are
# clinical constants, NOT data-derived statistics (reference info.py:6-7).
MIN_MAX_VALUES = {
    "sbp": (20.0, 300.0),
    "dbp": (5.0, 225.0),
    "heartRate": (0.0, 300.0),
    "temperature": (24.0, 45.0),
    "spo2": (0.0, 100.0),
    "respiratory": (0.0, 60.0),
}

# Metrics monitored for per-metric best checkpoints (reference info.py:38-40).
# All are minimized; `delta` only exists in the DEC (clustering) stage.
METRICS = ("loss", "ae_mse", "delta")
MIN_METRICS = ("loss", "ae_mse", "delta")
MAX_METRICS = ()

# Extra scalar series recorded to the summary writer (reference info.py:41).
SUMMARY_ITEMS = ("lr", "kl", "fake_detection")

# Phenotype display names keyed by aligned cluster id (reference info.py:15-26).
LEGEND_INFO = {
    "0": "Phenotype A",
    "1": "Phenotype B",
    "2": "Phenotype C",
    "3": "Phenotype D",
    "4": "Phenotype E",
    "5": "Phenotype F",
    "6": "Phenotype G",
    "7": "Phenotype H",
    "8": "Phenotype I",
    "9": "Phenotype J",
}

PALETTE_INFO = {
    0: "#9b59b6",
    1: "#3498db",
    2: "#8de5a1",
    3: "#e74c3c",
    4: "#34495e",
    5: "#2ecc71",
}
