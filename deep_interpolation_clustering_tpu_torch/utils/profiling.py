"""Where a p1 train step spends its time on the card (counterpart of the JAX
`utils/profiling.py`).

    python -m deep_interpolation_clustering_tpu_torch.utils.profiling

builds the default `Config` trainer (B=256, T=354, H=128) on a synthetic
cohort, and prints one JSON object with:
  * `step_ms`: the median host time of a train step ending in a synchronise;
  * from a `torch.profiler` window over a few steps: the device's busy time
    (union of its kernel and copy intervals), its idle share in that window
    and against `step_ms` (the profiler slows the host), the kernels
    launched per step, the kernels that take the most device time, and
    every hand-written kernel of `csrc/` (the selects, the SCI forward and
    backward, the RBF push, each kernel of B6/B7, for the split of the
    biLSTM backward between its recurrence and its dW kernels, the
    optimizer tail's two, and mTAN's encoder attention, `mtan_*`), whatever
    its rank; and `rbf_backward`, the device time of the kernels launched
    inside the `rbf_push_backward` range (RBFFunction's backward, which
    recomputes the push in plain PyTorch and differentiates it), with the
    span of that range on the device's timeline;
  * `graphed`: the same step as the fused epoch runs it, a replay of the
    captured step (`train/graphs.py`) with its rows copied in and its
    losses copied out: the seconds of the warm-up and capture, the device
    memory the capture reserved, the median ms of a replayed step, and the
    same `torch.profiler` window over replays (device-busy ms, idle share,
    device operations a step, the hand kernels);
  * `turns_ms`: the stepped and the replayed step's ms, in turns
    (`step_turns`), so that the host's load moves both alike.
It needs a CUDA card and raises without one.

`collective_calls` counts the collectives that `parallel/` issues, eagerly
and while a graph captures them (the tracer's counters, `utils.tracing`),
and `device_profile` counts the NCCL kernels the card ran; `chip_smoke.py`
phase `dp` reads both for a rank of a NCCL group.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import time
from collections import defaultdict
from collections.abc import Mapping
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from . import tracing


# substrings of the names of the kernels in csrc/*.cu
HAND_KERNELS = ("fake_select", "sci_", "rbf_", "lstm_", "optim_", "mtan_")


def _sync_ms(fn: Callable) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def graphed_step(trainer) -> Callable:
    """A callable that does one batch of the fused epoch on the trainer's
    full batches in turn: the rows into the captured full-batch step's
    buffer, a replay, the losses copied out (`Trainer._dispatch_fused_epoch`'s
    work a batch). The graph is captured on the first call."""
    graph = trainer._train_graph(False)
    full = [idx for idx, mask in trainer._epoch_batches(trainer.epoch) if mask is None]
    if trainer.shard_cohort:  # block numbers, as the graph's (1,) index buffer holds them
        full = [torch.tensor([k], device=trainer.device) for k in full]
    rows = itertools.cycle(full)
    out = {}

    def step():
        out["losses"] = graph(next(rows))["losses"].clone()

    return step


class _Collectives(Mapping):
    """{"eager": n, "captured": n}: the tracer's `collective.*` counters
    since this view was made, live until `freeze()`."""

    KINDS = ("eager", "captured")

    def __init__(self):
        self.base = {k: tracing.counter("collective." + k) for k in self.KINDS}
        self.frozen: Optional[Dict[str, int]] = None

    def __getitem__(self, kind: str) -> int:
        if self.frozen is not None:
            return self.frozen[kind]
        return tracing.counter("collective." + kind) - self.base[kind]

    def __iter__(self):
        return iter(self.KINDS)

    def __len__(self) -> int:
        return len(self.KINDS)

    def freeze(self) -> None:
        self.frozen = dict(self)


@contextlib.contextmanager
def collective_calls() -> Iterator[Mapping]:
    """Count, while the block runs, the collectives that `parallel/` issues
    (`all_reduce`, `broadcast`, `all_to_all_single`): {"eager": n,
    "captured": n}, the latter issued while the calling thread's stream is
    being captured into a CUDA graph (an autograd backward runs on the
    forward's stream). The counts are the tracer's (`parallel.mesh.issued`);
    the block enables it if it is off (and disables it after), and the
    mapping holds its values after the block."""
    started = not tracing.enabled()
    if started:
        tracing.enable(torch.device("cuda", torch.cuda.current_device())
                       if torch.cuda.is_available() else None)
    counts = _Collectives()
    try:
        yield counts
    finally:
        counts.freeze()
        if started:
            tracing.disable()


def step_turns(steps: Dict[str, Callable], turns: int, n: int) -> Dict[str, List[float]]:
    """Each step's ms (the mean over `n` calls ended by a synchronise), the
    steps in turns, `turns` times."""
    out: Dict[str, List[float]] = defaultdict(list)
    for _ in range(turns):
        for name, step in steps.items():
            out[name].append(_sync_ms(lambda: [step() for _ in range(n)]) / n)
    return dict(out)


def device_profile(step: Callable, n: int, top: int = 12) -> Dict:
    """Profile `n` calls of `step`: device busy time and idle share over the
    window, kernels per step, the `top` kernels by device time, every
    hand-written kernel of csrc/ and the RBF backward's range. Where the
    steps replay CUDA graphs, also the graph launches the host made and the
    kernels of each replay the trace holds (`replay_kernels`), and the
    counts and ms a step are over those replays (`steps_traced`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..ops.cuda_interp import RBF_BACKWARD_RANGE

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels, copies and sets; not the ranges that annotations (such as
    # `Optimizer.step`) draw on the device's timeline around them
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -np.inf
    for s, e in spans:  # union of the intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    # a graph's kernels carry the correlation id of the cudaGraphLaunch that
    # ran them: each replay's hand and NCCL kernels, for the replays whose
    # device events the trace holds (CUPTI has been seen to drop all of one
    # replay's events); counts a step are over those replays
    launches = {e.id for e in prof.events() if e.name == "cudaGraphLaunch"}
    replays: Dict[int, Dict[str, int]] = {e.id: defaultdict(int) for e in events
                                          if e.id in launches}
    for e in events:
        if e.id in replays and (any(k in e.name for k in HAND_KERNELS)
                                or "nccl" in e.name.lower()):
            replays[e.id][e.name] += 1
    steps = max(len(replays), 1) if launches else n
    by_name: Dict[str, List[float]] = defaultdict(list)
    for e in events:
        by_name[e.name].append(e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    per_step = lambda name, t: {"name": name[:90], "ms_per_step": sum(t) / 1e3 / steps,
                                "calls_per_step": len(t) / steps}
    # the kernels launched inside the range on the host (by it or by the
    # operations under it), and the span the profiler draws for the range on
    # the device's timeline
    launched = lambda e: list(e.kernels) + [k for c in e.cpu_children for k in launched(c)]
    rbf_kernels = [k for e in prof.events() if e.name == RBF_BACKWARD_RANGE
                   and e.device_type == DeviceType.CPU for k in launched(e)]
    device_spans = [e.time_range.elapsed_us() for e in prof.events()
                    if e.name == RBF_BACKWARD_RANGE and e.device_type == DeviceType.CUDA]
    return {
        "window_steps": n,
        "window_ms": wall_us / 1e3,
        "graph_launches": len(launches),
        "steps_traced": steps,
        "replay_kernels": [dict(c) for c in replays.values()],
        "device_events": len(events),
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if events else None,
        "device_events_per_step": len(events) / steps,
        "nccl_kernels_per_step": sum(len(t) for name, t in by_name.items()
                                     if "nccl" in name.lower()) / steps,
        "nccl_ms_per_step": sum(sum(t) for name, t in by_name.items()
                                if "nccl" in name.lower()) / 1e3 / steps,
        "top_kernels": [per_step(name, t) for name, t in ranked[:top]],
        "hand_kernels": [per_step(name, t) for name, t in ranked
                         if any(k in name for k in HAND_KERNELS)],
        "rbf_backward": {
            "kernel_ms_per_step": sum(k.duration for k in rbf_kernels) / 1e3 / steps,
            "kernels_per_step": len(rbf_kernels) / steps,
            "span_ms_per_step": sum(device_spans) / 1e3 / steps,
        },
    }


def main() -> None:
    import subprocess
    import tempfile

    from ..config import Config
    from ..data import ArrayDataset, make_synthetic_cohorts, process_splits
    from ..train import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")
    cfg = Config()
    cohorts = process_splits(
        make_synthetic_cohorts(n_total=2927, max_obs=cfg.num_timestamps, seed=cfg.seed),
        rng=np.random.RandomState(0))
    run_dir = tempfile.TemporaryDirectory()
    trainer = Trainer(cfg, {"training": ArrayDataset(cfg, cohorts["training"], "training")},
                      run_dir.name)
    trainer.train_steps(3)  # warm-up: kernel build, cuBLAS, allocator
    stream = trainer._stream()
    step = lambda: trainer.step(*next(stream))
    step_ms = float(np.median([_sync_ms(step) for _ in range(10)]))
    replay = graphed_step(trainer)
    replay()  # warm-up and capture
    graph = trainer._graphs[("train", False)]
    replay_ms = float(np.median([_sync_ms(replay) for _ in range(10)]))
    torch.cuda.reset_peak_memory_stats()
    out = {
        "device": torch.cuda.get_device_name(0),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        "batch": cfg.batch_size, "T": cfg.num_timestamps, "lstm_hidden": cfg.lstm_hidden,
        "step_ms": step_ms,
        "profile": device_profile(step, 5),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "graphed": {
            "capture_s": graph.capture_seconds, "pool_bytes": graph.pool_bytes,
            "launches_per_replay": graph.launches, "step_ms": replay_ms,
            "profile": device_profile(replay, 20),
        },
        "turns_ms": step_turns({"stepped": step, "graphed": replay}, 4, 10),
    }
    # the profiler slows the host, so the idle share of an unprofiled step
    # is read against `step_ms`
    prof = out["profile"]
    out["device_idle_share_at_step_ms"] = 1.0 - prof["device_busy_ms"] / prof["window_steps"] / step_ms
    gprof = out["graphed"]["profile"]
    out["graphed"]["device_idle_share_at_step_ms"] = (
        1.0 - gprof["device_busy_ms"] / gprof["window_steps"] / replay_ms)
    trainer.close()
    run_dir.cleanup()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
