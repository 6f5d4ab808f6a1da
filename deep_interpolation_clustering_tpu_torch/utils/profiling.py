"""Where a p1 train step spends its time on the card (counterpart of the JAX
`utils/profiling.py`).

    python -m deep_interpolation_clustering_tpu_torch.utils.profiling

builds the default `Config` trainer (B=256, T=354, H=128) on a synthetic
cohort, and prints one JSON object with:
  * `step_ms`: the median host time of a train step ending in a synchronise;
  * `phases_ms`: the median of each phase of the step (build_inputs, forward
    and losses, backward, clip, optimizer), each ended by a synchronise, so
    their sum exceeds `step_ms` by the lost overlap;
  * from a `torch.profiler` window over a few steps: the device's busy time
    (union of its kernel and copy intervals), its idle share in that window
    and against `step_ms` (the profiler slows the host), the kernels
    launched per step, the kernels that take the most device time, and
    every hand-written kernel of `csrc/` (the selects, the SCI forward and
    backward, the RBF push, and each kernel of B6/B7, for the split of the
    biLSTM backward between its recurrence and its dW kernels), whatever
    its rank; and `rbf_backward`, the device time of the kernels launched
    inside the `rbf_push_backward` range (RBFFunction's backward, which
    recomputes the push in plain PyTorch and differentiates it), with the
    span of that range on the device's timeline.
It needs a CUDA card and raises without one.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np
import torch


# substrings of the names of the kernels in csrc/*.cu
HAND_KERNELS = ("fake_select", "sci_", "rbf_", "lstm_")


def _sync_ms(fn: Callable) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_times(trainer, n: int) -> Dict[str, float]:
    """Median ms of each phase of `trainer`'s step over `n` steps."""
    from ..train.optim import clip_grad_global_norm_
    from ..train.steps import build_inputs, forward_and_losses, gather_batch

    cfg, net, opt, gen = trainer.cfg, trainer.net, trainer.opt, trainer.generator
    data = trainer.cohort_data("training")
    times = defaultdict(list)
    for idx, _ in trainer._epoch_batches(trainer.epoch)[:n]:
        box = {}
        times["build_inputs"].append(_sync_ms(lambda: box.update(inputs=build_inputs(
            cfg, gather_batch(data, idx), gen, True, cfg.denoise))))
        opt.zero_grad(set_to_none=True)
        times["forward_losses"].append(_sync_ms(lambda: box.update(losses=forward_and_losses(
            net, cfg, box["inputs"], True, gen)[1])))
        times["backward"].append(_sync_ms(lambda: box["losses"]["loss"].backward()))
        times["clip"].append(_sync_ms(lambda: clip_grad_global_norm_(net.parameters(),
                                                                     cfg.grad_clip)))
        times["optimizer"].append(_sync_ms(opt.step))
    return {k: float(np.median(v)) for k, v in times.items()}


def device_profile(step: Callable, n: int, top: int = 12) -> Dict:
    """Profile `n` calls of `step`: device busy time and idle share over the
    window, kernels per step, the `top` kernels by device time, every
    hand-written kernel of csrc/ and the RBF backward's range."""
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
    by_name: Dict[str, List[float]] = defaultdict(list)
    for e in events:
        by_name[e.name].append(e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    per_step = lambda name, t: {"name": name[:90], "ms_per_step": sum(t) / 1e3 / n,
                                "calls_per_step": len(t) / n}
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
        "device_events": len(events),
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us if events else None,
        "device_events_per_step": len(events) / n,
        "top_kernels": [per_step(name, t) for name, t in ranked[:top]],
        "hand_kernels": [per_step(name, t) for name, t in ranked
                         if any(k in name for k in HAND_KERNELS)],
        "rbf_backward": {
            "kernel_ms_per_step": sum(k.duration for k in rbf_kernels) / 1e3 / n,
            "kernels_per_step": len(rbf_kernels) / n,
            "span_ms_per_step": sum(device_spans) / 1e3 / n,
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
    torch.cuda.reset_peak_memory_stats()
    out = {
        "device": torch.cuda.get_device_name(0),
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
        "batch": cfg.batch_size, "T": cfg.num_timestamps, "lstm_hidden": cfg.lstm_hidden,
        "step_ms": step_ms,
        "phases_ms": phase_times(trainer, 10),
        "profile": device_profile(step, 5),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    # the profiler slows the host, so the idle share of an unprofiled step
    # is read against `step_ms`
    prof = out["profile"]
    out["device_idle_share_at_step_ms"] = 1.0 - prof["device_busy_ms"] / prof["window_steps"] / step_ms
    trainer.close()
    run_dir.cleanup()
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
