"""Auxiliary "future vital" targets (the port's own copy of the JAX
`data/abnormal.py`).

From 24h vitals, take records in hour [h, h+1) and reduce per encounter:
min of sbp/dbp/spo2 (hypotension/desaturation), max of temperature/heartRate/
respiratory (fever/tachycardia/tachypnea), then min-max normalize (reference
get_abnormal_vital.py:55-78). Each reduction is keyed by vital name, not by
the pickle's key order (the reference zips the two, get_abnormal_vital.py:70).
Needs pandas.
"""

from __future__ import annotations

from typing import Dict

from ..info import MIN_MAX_VALUES, USE_FEATURES

# which extreme is "abnormal" for each vital
_AGG = {
    "sbp": "min",
    "dbp": "min",
    "spo2": "min",
    "temperature": "max",
    "heartRate": "max",
    "respiratory": "max",
}


def extract_abnormal_vitals(
    vital_data: Dict[str, "pandas.DataFrame"],
    encounter: "pandas.DataFrame",
    hours_from_admission: int = 6,
) -> "pandas.DataFrame":
    """Return the encounter table joined with normalized hour-(h+1) extremes.

    `vital_data` maps vital name -> long dataframe with columns
    `encounter_deiden_id`, `time_stamp`, `measurement` (24h horizon).
    Unobserved encounters get NaN, which downstream masks out.
    """
    out = encounter.copy()
    for vital in USE_FEATURES:
        df = vital_data[vital]
        window = df[
            (df["time_stamp"] >= hours_from_admission)
            & (df["time_stamp"] < hours_from_admission + 1)
        ]
        grouped = window.groupby("encounter_deiden_id", as_index=False)["measurement"]
        reduced = grouped.min() if _AGG[vital] == "min" else grouped.max()
        reduced = reduced.rename(columns={"measurement": vital})
        out = out.merge(reduced, on="encounter_deiden_id", how="left")

    for vital in USE_FEATURES:
        lo, hi = MIN_MAX_VALUES[vital]
        out[vital] = (out[vital] - lo) / (hi - lo)
    return out
