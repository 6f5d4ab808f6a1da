"""The per-layer metrics that the program's own tracer feeds
(`deep_interpolation_clustering_tpu_torch/utils/tracing.py`): its spans
and counters over the traced run's profiled `train()` call.

A traced run profiles one more `train()` call after the window
(`training.profile_call`), with no synchronise added by the benchmark. A
program that has the tracer traces that call by itself, since a profiler is
recording (`tracing.call`), and keeps the report; the first reader takes it
(`tracing.take`) into `run.readings["program_trace"]`, and prints one
summary line on standard error. A program without the tracer (an older
commit), an untraced run and a rehearsal (no profiled call) keep no such
report: every reader then returns None, and the harness leaves the metric
out of the line. Nothing here synchronises or times anything: the numbers
are the program's, read where the work happens.
"""

from __future__ import annotations

import importlib
import sys
from typing import Optional

PROGRAM_TRACER = "deep_interpolation_clustering_tpu_torch.utils.tracing"


def program_tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        return importlib.import_module(PROGRAM_TRACER)
    except ModuleNotFoundError as e:
        if e.name != PROGRAM_TRACER:
            raise
        return None


def _trace(run, tag: str) -> Optional[dict]:
    """The program's report of the run's profiled call, or None."""
    if not run.args.trace or run.readings.get("tag") != tag:
        return None
    if "program_trace" not in run.readings:
        tracer = program_tracer()
        take = getattr(tracer, "take", None)
        run.readings["program_trace"] = take() if take is not None else None
        if run.readings["program_trace"]:
            say(run.readings["program_trace"])
    return run.readings["program_trace"] or None


def _spans(trace: dict, name: str) -> list:
    return [s for s in trace.get("spans", ()) if s["name"] == name]


def step_device_ms(run, tag: str) -> Optional[float]:
    """The train epochs' device ms over their steps: the `train_epoch`
    spans' intervals between their two events on the card's stream, over
    the counter `train.steps`; None without device intervals (the CPU).
    The profiled call's step carries the profiler's own cost on the card
    (its kernel tracing), so it reads above the same step unprofiled."""
    trace = _trace(run, tag)
    if trace is None:
        return None
    epochs = _spans(trace, "train_epoch")
    steps = trace.get("counters", {}).get("train.steps", 0)
    if not epochs or not steps or any(s["device_ms"] is None for s in epochs):
        return None
    return sum(s["device_ms"][1] - s["device_ms"][0] for s in epochs) / steps


def host_reads(run, tag: str) -> Optional[float]:
    """The counter `host_reads` (each transfer of card data to the host:
    loss tables, dumps, checkpoint tensors, k-means' flag reads, the DEC
    count) over the profiled call's `epoch` spans."""
    trace = _trace(run, tag)
    if trace is None:
        return None
    epochs = len(_spans(trace, "epoch"))
    if not epochs:
        return None
    return trace.get("counters", {}).get("host_reads", 0) / epochs


def checkpoint_ms(run, tag: str) -> Optional[float]:
    """The `checkpoint` spans' host ms (the state's copy to the host and the
    files' write) over the profiled call's `epoch` spans: what checkpoints
    take from an epoch, 0 where the call wrote none. Not a file's ms (the
    counter `checkpoint.writes`): a T=354 p1 call writes in about one epoch
    of ten, so a per-file reading would be missing from some runs."""
    trace = _trace(run, tag)
    if trace is None:
        return None
    epochs = len(_spans(trace, "epoch"))
    if not epochs:
        return None
    return sum(s["host_ms"][1] - s["host_ms"][0] for s in _spans(trace, "checkpoint")) / epochs


def describe(trace: dict) -> str:
    """One line for standard error: each span name's calls, host, self and
    device ms, the counters, the root's unnamed share and the longest
    device gaps of leaf spans."""
    by_name = {k: [v["calls"], round(v["host_ms"], 3), round(v["self_ms"], 3),
                   round(v["device_ms"], 3)] for k, v in trace.get("by_name", {}).items()}
    roots = [s for s in trace.get("spans", ()) if s["parent"] is None]
    total = sum(s["host_ms"][1] - s["host_ms"][0] for s in roots)
    unnamed = sum(s["self_ms"] for s in roots)
    gaps = sorted(trace.get("gaps", ()), key=lambda g: -g[2])[:8]
    return (f"program spans (calls, host ms, self ms, device ms): {by_name}; counters: "
            f"{trace.get('counters')}; unnamed {100.0 * unnamed / max(total, 1e-9):.3f}% of "
            f"the root; events {trace.get('events')}; longest gaps (span, at ms, ms): "
            f"{[[n, round(a, 3), round(g, 3)] for n, a, g in gaps]}")


def say(trace: dict) -> None:
    print(describe(trace), file=sys.stderr)
