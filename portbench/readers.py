"""What the per-layer metrics read from a run: each function returns None
when the run holds nothing for it (another job's cell, no trace), and the
harness then leaves the metric out of the line."""

from __future__ import annotations

from typing import Optional

from portbench.work import FP32_FLOP_PER_S


def _mine(run, tag: str) -> bool:
    return run.readings.get("tag") == tag and bool(run.readings.get("steps"))


def trainer_share(run, tag: str) -> Optional[float]:
    """% of the traced call's seconds outside its train epochs (dispatch to
    the end of their device work): eval passes, checkpoints, summaries,
    fetches and the loop."""
    if not _mine(run, tag):
        return None
    return 100.0 * (1.0 - run.readings["train_s"] / run.readings["call_s"])


def step_ms(run, tag: str) -> Optional[float]:
    """The train epochs' ms over their steps."""
    if not _mine(run, tag):
        return None
    return 1e3 * run.readings["train_s"] / run.readings["steps"]


def mfu(run, tag: str) -> Optional[float]:
    """% of the float32 peak: the model's operations of the train epochs'
    steps over their seconds."""
    if not _mine(run, tag):
        return None
    flop = run.readings["flops_per_step"] * run.readings["steps"]
    return 100.0 * flop / run.readings["train_s"] / FP32_FLOP_PER_S


def hand_roofline(run, tag: str) -> Optional[float]:
    """% of their roofline: the hand kernels' bound over their device
    seconds in the profiled window."""
    if not _mine(run, tag) or not (run.profile or {}).get("hand_kernels_s"):
        return None
    return 100.0 * run.readings["hand_bound_s"] / run.profile["hand_kernels_s"]


def idle_share(run, tag: str) -> Optional[float]:
    """% of the profiled window with no kernel, copy or set on the card."""
    if run.readings.get("tag") != tag or not (run.profile or {}).get("busy_s"):
        return None
    return 100.0 * (1.0 - run.profile["busy_s"] / run.profile["window_s"])
