"""The port's tracer: spans and counters at the trainers' layer boundaries,
on the host's clock, the device's and a `torch.profiler` trace's at once.

    from deep_interpolation_clustering_tpu_torch.utils import tracing
    tracing.enable(device)          # a new recording
    trainer.train()
    out = tracing.report()          # one synchronise; the dict below
    tracing.disable()

`span(name, **attrs)` is a context manager and `count(name, n=1)` adds to a
counter. Off, which is the default, `span` hands back one shared null
context after a single flag test and `count` returns at once: no event, no
allocation, no record. There is no configuration field and no environment
variable; `enable` is the switch.

A trainer's `train()` call opens its root span with `call(device)`. Where
the tracer is off and a `torch.profiler` is recording, that call traces
itself: the tracer is on for the call alone, and its report is kept until
`take()` hands it over. A profiled call then holds the program's spans,
counters and device intervals without the caller knowing of the tracer
(the benchmark's traced run profiles one `train()` call this way); an
unprofiled call with the tracer off pays one flag test and one query of
the profiler's state.

On, a span records its name, its id, its parent's id (the innermost span
open when it began) and its root's id (a `train()` call's spans share the
root's), its host start and end (`time.perf_counter_ns`), its attributes,
and a `torch.profiler.record_function` range named `dicl.<name>`, so a
device trace taken over the run holds the program's spans on its own
clock. On a CUDA device it also records a timing event on the current
stream at entry and at exit, with no synchronise. While the current stream
is being captured into a CUDA graph a span records no event: no span may
sit inside a captured step function (its host times would be the
capture's, and a replay runs none of its code). A counter may: it counts
what the host did while capturing.

`enable(device)` synchronises once and records an anchor event beside its
host time. `report()` synchronises once, then places every span's device
interval on the host's clock (the anchor's host time plus the anchor's
elapsed time to each event), gives each span its self time (its host
duration less what its children cover), lists the gaps between
consecutive device intervals of leaf spans (each put down to the innermost
span open on the host when it began), and returns these with the counters.
Spans stay in memory until then; nothing is written while the program runs.
Times in the report are ms from the anchor.

The hand kernels' call counters (`mtan.attn_launches`, `mtan.gru_launches`:
`ops/_cuda_build.KernelWrapper`'s `counter`) count every call of a kernel's
wrapper, a capture's too, and every launch of it that a graph's replay makes
(`_cuda_build.add_launches`), so a call that only replays graphs counts them.

A CUDA graph captured while the tracer is on (`train/graphs.py`) also
captures one `add_(1)` on a device counter of its own and is watched
(`watch_graph`): `report()` gives `graph.replays_unrun`, the host's replays
of the watched graphs less the device's count of them, which is 0 unless a
replay the host launched never ran.

One recording at a time, for the thread that runs the trainer.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Union

import torch

PREFIX = "dicl."
ROOT = "train"  # the root span of a trainer's `train()` call

_on = False
_rec: Optional["_Recording"] = None
_kept: Optional[dict] = None  # the report of the last call that traced itself


class _Null:
    """The context `span` hands back when the tracer is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NULL = _Null()


class _Recording:
    """What one `enable()` records until `report()`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.closed: List["_Span"] = []
        self.stack: List["_Span"] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.graphs: list = []  # GraphedSteps captured with a device replay counter
        self.ids = 0
        self.anchor: Optional[torch.cuda.Event] = None
        if self.cuda:
            torch.cuda.synchronize(device)
            self.anchor = torch.cuda.Event(enable_timing=True)
            before = time.perf_counter_ns()
            self.anchor.record(torch.cuda.current_stream(device))
            self.anchor.synchronize()
            self.anchor_ns = (before + time.perf_counter_ns()) // 2
        else:
            self.anchor_ns = time.perf_counter_ns()

    def event(self) -> Optional[torch.cuda.Event]:
        """A timing event recorded on the current stream now, or None off
        the card or while the stream is being captured."""
        if not self.cuda or torch.cuda.is_current_stream_capturing():
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "t0", "t1", "ev0", "ev1", "range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Span":
        rec = _rec
        rec.ids += 1
        self.id = rec.ids
        outer = rec.stack[-1] if rec.stack else None
        self.parent = outer.id if outer is not None else None
        self.root = outer.root if outer is not None else self.id
        rec.stack.append(self)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        self.ev0 = rec.event()
        return self

    def __exit__(self, *exc) -> bool:
        rec = _rec
        self.ev1 = rec.event() if self.ev0 is not None else None
        self.t1 = time.perf_counter_ns()
        self.range.__exit__(*exc)
        rec.stack.pop()
        rec.closed.append(self)
        return False


def enabled() -> bool:
    return _on


def enable(device: Union[str, torch.device, None] = None) -> None:
    """Start a new recording (the last one's spans and counters dropped).
    `device`: where the trainer runs; on a CUDA device the spans record
    events (None: the CPU, host times only)."""
    global _on, _rec
    _rec = _Recording(torch.device(device if device is not None else "cpu"))
    _on = True


def disable() -> None:
    """Stop and drop the recording (`report()` first to keep it)."""
    global _on, _rec
    _on = False
    _rec = None


def span(name: str, **attrs):
    """A span called `name` around the block (the shared null context when
    the tracer is off)."""
    if not _on:
        return NULL
    return _Span(name, attrs)


class _ProfiledCall:
    """The root span of a call that traces itself (see `call`)."""

    __slots__ = ("device", "root")

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self) -> "_Span":
        enable(self.device)
        self.root = _Span(ROOT, {})
        return self.root.__enter__()

    def __exit__(self, *exc) -> bool:
        global _kept
        try:
            self.root.__exit__(*exc)
            _kept = report()
        finally:
            disable()
        return False


def call(device: Union[str, torch.device, None]):
    """The root span `train` of a trainer's `train()` call: a span when the
    tracer is on; where it is off and a `torch.profiler` records, a call
    that traces itself (its report kept for `take()`); else the shared null
    context."""
    if _on:
        return _Span(ROOT, {})
    if not torch._C._autograd._profiler_enabled():
        return NULL
    return _ProfiledCall(torch.device(device if device is not None else "cpu"))


def take() -> Optional[dict]:
    """The report of the last `train()` call that traced itself under a
    profiler, handed over once (None if there was none since)."""
    global _kept
    out, _kept = _kept, None
    return out


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (nothing when the tracer is off)."""
    if not _on:
        return
    _rec.counters[name] += n


def counter(name: str) -> int:
    """The counter's value in the current recording (0 without one)."""
    return _rec.counters.get(name, 0) if _rec is not None else 0


def watch_graph(graph) -> None:
    """Hold a graph captured with a device replay counter
    (`graph.device_replays`, host count `graph.replays`) for `report()`."""
    if _on:
        _rec.graphs.append(graph)


def report() -> dict:
    """The recording so far: its spans (closed ones), each name's totals,
    the leaf spans' device gaps, and the counters. Synchronises once."""
    rec = _rec
    if rec is None:
        return {}
    if rec.cuda:
        torch.cuda.synchronize(rec.device)
    spans = sorted(rec.closed, key=lambda s: s.id)
    at = lambda ns: (ns - rec.anchor_ns) / 1e6  # noqa: E731
    covered: Dict[int, int] = defaultdict(int)
    parents = set()
    for s in spans:
        if s.parent is not None:
            covered[s.parent] += s.t1 - s.t0
            parents.add(s.parent)
    depth: Dict[int, int] = {}
    out = []
    for s in spans:
        depth[s.id] = depth.get(s.parent, -1) + 1
        device = None
        if s.ev0 is not None and s.ev1 is not None:
            device = [rec.anchor.elapsed_time(s.ev0), rec.anchor.elapsed_time(s.ev1)]
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
                    "attrs": s.attrs, "host_ms": [at(s.t0), at(s.t1)],
                    "self_ms": (s.t1 - s.t0 - covered[s.id]) / 1e6, "device_ms": device})
    by_name: Dict[str, dict] = {}
    for d in out:
        b = by_name.setdefault(d["name"], {"calls": 0, "host_ms": 0.0, "self_ms": 0.0,
                                           "device_ms": 0.0})
        b["calls"] += 1
        b["host_ms"] += d["host_ms"][1] - d["host_ms"][0]
        b["self_ms"] += d["self_ms"]
        if d["device_ms"] is not None:
            b["device_ms"] += d["device_ms"][1] - d["device_ms"][0]
    counters = dict(rec.counters)
    if rec.graphs:
        counters["graph.replays_unrun"] = sum(
            g.replays - int(g.device_replays.item()) for g in rec.graphs)
    return {"spans": out, "by_name": by_name, "gaps": _gaps(out, parents, depth),
            "counters": counters,
            "events": sum(2 for d in out if d["device_ms"] is not None)}


def _gaps(out: List[dict], parents: set, depth: Dict[int, int]) -> List[list]:
    """[name, start ms, length ms] of each gap between consecutive device
    intervals of leaf spans, named by the innermost span open on the host
    at its start."""
    leaves = sorted((d["device_ms"] for d in out
                     if d["id"] not in parents and d["device_ms"] is not None))
    gaps, end = [], None
    for s, e in leaves:
        if end is not None and s > end:
            open_ = [d for d in out if d["host_ms"][0] <= end < d["host_ms"][1]]
            name = max(open_, key=lambda d: depth[d["id"]])["name"] if open_ else "outside"
            gaps.append([name, end, s - end])
        end = e if end is None else max(end, e)
    return gaps
