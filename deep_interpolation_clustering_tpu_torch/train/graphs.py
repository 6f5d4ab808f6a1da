"""The fused epoch on the card (counterpart of the JAX `make_train_epoch` and
`make_eval_epoch`, train/steps.py:299-441).

JAX runs an epoch as one compiled `lax.scan`: one dispatch an epoch. Here a
step is captured once as a CUDA graph over static buffers and replayed for
each batch. The host writes the batch's rows (and a tail's sample mask)
into the graph's buffers with one device copy, replays the graph, and the
caller copies the outputs out: three calls a batch, none of which waits for
the device, where the eager step dispatches several hundred operations.

`GraphedStep(fn, ...)` holds one such step, and is the one place that
decides whether it is captured. `fn(rows, mask)` reads the batch through the
index buffer `rows` (the rank's B/D rows of the cohort, or the number of the
block of a row-sharded cohort) and, for a masked step, the (B/D,) `mask`,
and returns a dict of tensors (static outputs, overwritten by each replay).
It captures where the caller's `capture` switch (the trainers'
`fused_epoch`) is on, the device is CUDA and the world's collectives can be
captured (`parallel.capturable()`): the first call warms `fn` up, captures
it and replays it. Everywhere else (the CPU, a gloo group, the switch off)
every call runs `fn` directly on the same buffers: one body, captured or
called directly.

Warm-up (the kernels' build, cuBLAS handles, the optimizer's state) must
not move the trajectory: the tensors `state()` names (parameters, buffers,
optimizer state) and the generator's state are snapshot first and written
back in place after the warm-up and after the capture, so the graph's
addresses hold; a tensor that the warm-up created (a fresh optimizer's
moments and step count) is zeroed, which is its fresh value. The generator
is registered with the graph, so that each replay takes the draws an eager
step takes at that point (the Philox offset advances by the graph's total
on each replay, as it does over the eager step's operations).

The graphs of one trainer share one memory pool (`SharedPool`): the first
capture makes it and the later ones allocate from it. They never replay at
once, and each replay's outputs are copied out before another graph
replays, so a later graph may take the memory of an earlier one's
intermediates (its live outputs the capture leaves alone); they are
captured on one side stream, since the allocator reuses a block only on
the stream that freed it.

Hand-kernel launches recorded while the graph is captured are counted and
added to the wrappers' counts on each replay (`ops._cuda_build`).

Tracing (`utils.tracing`): a capture is the span `capture` and the counter
`graph.captures`; each replay adds to `graph.replays` (a counter, no span).
A graph captured while the tracer is on also captures one `add_(1)` on a
device counter of its own (`device_replays`), so that the tracer's report
can hold the replays the host launched against those the card ran; a graph
captured while it is off captures nothing more than the step.

On the ranks of a NCCL group (`parallel.capturable()`) the step's
collectives are captured with it: every rank warms up and captures the same
step at the same point of its run, the warm-up's collectives run for real
(the first of them makes the communicator, which must exist before a
capture), and each replay issues the collectives in the captured order on
every rank. NCCL runs them on its own stream, which joins the capture
through events. Its watchdog thread queries the events of earlier
collectives while a capture may be in progress, so a group captures with
`capture_error_mode="thread_local"`: only the capturing thread's calls are
checked.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import parallel
from ..ops import _cuda_build as cb
from ..utils import tracing

Snapshot = List[Tuple[torch.Tensor, torch.Tensor]]


def snapshot(tensors: List[torch.Tensor]) -> Snapshot:
    """Device copies of `tensors`, each beside the tensor it copies."""
    return [(t, t.detach().clone()) for t in tensors]


@torch.no_grad()
def restore_(snap: Snapshot, tensors: List[torch.Tensor]) -> None:
    """Write `snap` back into `tensors` in place; a tensor the snapshot does
    not hold (made since) is zeroed."""
    saved = {id(t): copy for t, copy in snap}
    for t in tensors:
        copy = saved.get(id(t))
        if copy is None:
            t.zero_()
        else:
            t.copy_(copy)


class SharedPool:
    """The memory pool that the graphs of one owner capture into (the
    first capture's, None before it) and the one side stream they warm up
    and capture on: the caching allocator gives a freed block again only
    to the stream that freed it, so graphs that share a pool share this
    stream too."""

    def __init__(self):
        self.handle = None
        self.stream: Optional[torch.cuda.Stream] = None


class GraphedStep:
    """One step `fn(rows, mask) -> {name: tensor}` over static buffers: a
    CUDA graph where `capture` is on, the device is CUDA and the world is
    capturable; a direct call everywhere else."""

    def __init__(self, fn: Callable, batch_size: int, device: torch.device, masked: bool,
                 generator: Optional[torch.Generator] = None,
                 state: Optional[Callable[[], List[torch.Tensor]]] = None, warmup: int = 2,
                 pool: Optional[SharedPool] = None, index_size: Optional[int] = None,
                 capture: bool = True):
        self.fn = fn
        self.device = device
        self.capture = capture and device.type == "cuda" and parallel.capturable()
        # the index buffer: `batch_size` rows, or `index_size` entries
        self.rows = torch.zeros(index_size or batch_size, dtype=torch.long, device=device)
        self.mask = torch.ones(batch_size, dtype=torch.float32, device=device) if masked else None
        self.generator = generator
        self.state = state or (lambda: [])
        self.warmup = warmup
        self.pool = pool or SharedPool()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[Dict[str, torch.Tensor]] = None
        self.launches: Dict[str, int] = {}  # hand-kernel launches a replay
        self.capture_seconds: Optional[float] = None  # warm-up and capture
        self.pool_bytes: Optional[int] = None  # device memory the capture added to the pool
        self.replays = 0
        # the device's count of replays, when captured with the tracer on
        self.device_replays: Optional[torch.Tensor] = None

    def __call__(self, rows: torch.Tensor, mask: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        self.rows.copy_(rows)
        if self.mask is not None:
            self.mask.copy_(mask)
        if not self.capture:
            return self.fn(self.rows, self.mask)
        if self.graph is None:
            with tracing.span("capture"):
                self._capture()
        self.graph.replay()
        cb.add_launches(self.launches)
        self.replays += 1
        tracing.count("graph.replays")
        return self.out

    def _restore(self, snap: Snapshot, gen_state: Optional[torch.Tensor]) -> None:
        restore_(snap, self.state())
        if gen_state is not None:
            self.generator.set_state(gen_state)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        tracing.count("graph.captures")
        counter = (torch.zeros(1, dtype=torch.int64, device=self.device)
                   if tracing.enabled() else None)
        snap = snapshot(self.state())
        gen_state = None if self.generator is None else self.generator.get_state()
        # warm up on the stream that captures (its cuBLAS workspace and the
        # allocator's stream state exist before the capture)
        if self.pool.stream is None:
            self.pool.stream = torch.cuda.Stream(self.device)
        stream = self.pool.stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(self.warmup):
                self.fn(self.rows, self.mask)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self._restore(snap, gen_state)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = cb.captured_counts()
        # a dead trainer's graphs lie in reference cycles (a step's closure
        # holds its trainer); the cyclic collector destroying one during a
        # capture would invalidate the capture: collect now, and not during it
        gc.collect()
        # the capture allocates from the shared pool, which keeps it: the
        # memory reserved over the capture (from an emptied cache, as
        # `torch.cuda.graph` leaves it) is what this graph added to the pool
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        mode = "thread_local" if parallel.grouped() else "global"
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool.handle, stream=stream,
                                  capture_error_mode=mode):
                out = self.fn(self.rows, self.mask)
                if counter is not None:
                    counter.add_(1)
        finally:
            if collecting:
                gc.enable()
        if self.pool.handle is None:
            self.pool.handle = graph.pool()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        after = cb.captured_counts()
        self._restore(snap, gen_state)
        torch.cuda.synchronize(self.device)
        self.graph, self.out = graph, out
        if counter is not None:
            self.device_replays = counter
            tracing.watch_graph(self)
        self.launches = {k: n - before[k] for k, n in after.items() if n != before[k]}
        self.capture_seconds = time.perf_counter() - t0
