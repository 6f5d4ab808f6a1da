"""Kneedle knee/elbow detection (Satopaa et al., 2011); the port's own copy
of the JAX package's `cluster/kneedle.py` (NumPy in both packages).

Replaces the reference's `kneed.KneeLocator` dependency
(p2_clustering_optK.py:17,118) with a self-contained implementation: the
curve is normalized and mapped to concave-increasing form, and the knee is
the x where the difference curve `y_n - x_n` peaks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def kneedle(
    x: np.ndarray,
    y: np.ndarray,
    curve: str = "convex",
    direction: str = "decreasing",
) -> Optional[float]:
    """Returns the x-coordinate of the knee/elbow, or None for degenerate
    curves (constant y)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(x) < 3 or y.max() == y.min():
        return None
    xn = (x - x.min()) / (x.max() - x.min())
    yn = (y - y.min()) / (y.max() - y.min())

    # map every (curve, direction) case onto concave increasing
    if curve == "concave" and direction == "increasing":
        yd = yn
    elif curve == "concave" and direction == "decreasing":
        yd = yn[::-1]
    elif curve == "convex" and direction == "decreasing":
        yd = 1.0 - yn
    elif curve == "convex" and direction == "increasing":
        yd = (1.0 - yn)[::-1]
    else:
        raise ValueError(f"unknown curve/direction {curve}/{direction}")

    diff = yd - xn
    idx = int(np.argmax(diff))
    if diff[idx] <= 0:
        return None
    if (curve == "concave") == (direction == "increasing"):
        return float(x[idx])
    return float(x[len(x) - 1 - idx])
