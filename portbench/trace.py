"""Spans around the program's layers, set from the benchmark's side, and the
reading of a `torch.profiler` trace.

`Spans` wraps methods of one object (an instance attribute over the class's
method, removed again by `remove`): each call is a span of the host clock,
ended by a synchronise of the card when `sync` is on (the traced run
only), and, inside a profiler, a `record_function` range of the same name,
so that the trace can say which span the host was in when the device idled.

`device_profile` holds the arithmetic of the program's own
`utils/profiling.py` `device_profile`, copied: the device's busy time is the
union of its kernel, copy and set intervals; the hand kernels are those
whose names hold a `HAND_KERNELS` prefix.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

# substrings of the names of the port's hand kernels (csrc/*.cu)
HAND_KERNELS = ("fake_select", "sci_", "rbf_", "lstm_")


class Spans:
    """Host-clock spans of wrapped methods: {name: [seconds, ...]}, and
    {name: total} of what `count` counts."""

    def __init__(self, device: torch.device, sync: bool):
        self.device = device
        self.sync = sync and device.type == "cuda"
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.counts: Dict[str, int] = defaultdict(int)
        self._wrapped: List[Tuple[object, str]] = []

    def wrap(self, obj, method: str, name: str,
             count: Optional[Callable[..., int]] = None) -> None:
        """Make `obj.method` a span called `name`; `count(result, *args)`
        adds to `counts[name]` after each call."""
        inner = getattr(obj, method)

        @functools.wraps(inner)
        def spanned(*args, **kwargs):
            with torch.profiler.record_function("bench." + name):
                t0 = time.perf_counter()
                out = inner(*args, **kwargs)
                if self.sync:
                    torch.cuda.synchronize(self.device)
                self.seconds[name].append(time.perf_counter() - t0)
            if count is not None:
                self.counts[name] += count(out, *args, **kwargs)
            return out

        setattr(obj, method, spanned)
        self._wrapped.append((obj, method))

    def total(self, name: str) -> float:
        return float(sum(self.seconds.get(name, ())))

    def remove(self) -> None:
        for obj, method in reversed(self._wrapped):
            delattr(obj, method)
        self._wrapped.clear()


@contextlib.contextmanager
def profiled(device: torch.device) -> Iterator[dict]:
    """A `torch.profiler` window over the block; on exit the dict holds the
    profile (`device_profile`) and the window's wall seconds."""
    from torch.profiler import ProfilerActivity, profile

    box: dict = {}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield box
        torch.cuda.synchronize(device)
        box["window_s"] = time.perf_counter() - t0
    box.update(device_profile(prof))


def device_profile(prof, top: int = 10) -> dict:
    """From a finished profile: the device's busy seconds (the union of its
    intervals), the seconds of the hand kernels, the `top` device
    operations by seconds, and the `top` longest idle gaps on the device,
    each named by the innermost host span (`record_function`) open when it
    began."""
    from torch.autograd import DeviceType

    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith("bench.")]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, float("-inf")
    gaps: List[Tuple[float, float]] = []
    for s, e in spans:  # the union of the intervals, and the gaps between
        if e > end:
            if end > float("-inf") and s > end:
                gaps.append((end, s))
            busy += e - max(s, end)
            end = e
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us()
    hand_us = sum(t for n, t in by_name.items() if any(k in n for k in HAND_KERNELS))

    def named(at: float) -> str:
        open_ = [(e - s, n) for s, e, n in host if s <= at < e]
        return min(open_)[1][len("bench."):] if open_ else "outside_spans"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "busy_s": busy / 1e6,
        "hand_kernels_s": hand_us / 1e6,
        "device_events": len(dev),
        "device_ops": [[n[:120], t / 1e6] for n, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[named(s), (e - s) / 1e6] for s, e in longest],
    }
