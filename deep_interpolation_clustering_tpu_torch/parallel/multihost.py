"""Process groups, ranks and their launch (counterpart of the JAX
`parallel/multihost.py`).

One rank is one process with one device. A group is set up either

  * from the multi-process flags, one process per rank started by the user:
    `--num_processes P --process_id i --coordinator_address host:port`
    (`init_method="tcp://host:port"`), or with an empty address
    `env://`: torchrun's `MASTER_ADDR`, `MASTER_PORT`, `RANK` (or
    `--process_id`) and `WORLD_SIZE` (or `--num_processes`), the torchrun
    counterpart of the JAX package's TPU-pod auto-discovery;
  * or by `spawn`, which starts N local ranks with `torch.multiprocessing`
    (`spawn`, never `fork`) and joins them (`--data_parallel N`).

The rank's card is chosen before the group is made (`torch.cuda.set_device`):
`LOCAL_RANK` when torchrun sets it, else the rank modulo the visible cards.
NCCL serves ranks on CUDA and refuses two ranks on one card; gloo serves
ranks on the CPU, and ranks that share a card when the caller asks for it
(`backend="gloo"`). A rank that cannot reach its card or its peers raises:
nothing falls back to one process or to the CPU.

Every process of a run loads the same cohort and seeds the same generators,
so host control flow (shuffles, schedules, early stop) is the same on every
rank without coordination; what the ranks compute apart is summed, gathered
or broadcast by `mesh`. Rank 0 alone writes files.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .mesh import gather_rows, rank, world_size

# the per-rank launch counts of the kernel wrappers in the last `spawn`
# (each rank's own counters; the parent's are not touched)
last_rank_launches: List[Dict[str, int]] = []


def rank_device(device: Union[str, torch.device], backend: str, process_id: int
                ) -> torch.device:
    """The device of rank `process_id`: the CPU, or its card (`LOCAL_RANK`
    when set, else the rank modulo the visible cards; gloo ranks beyond the
    visible cards share them)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    n = torch.cuda.device_count()
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        return torch.device("cuda", process_id % n)
    if int(local) >= n and backend != "gloo":  # only gloo ranks may share a card
        raise RuntimeError(f"rank {process_id}: LOCAL_RANK {local} names card {local}, "
                           f"{n} visible")
    return torch.device("cuda", int(local) % n)


def default_backend(device: Union[str, torch.device]) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str], num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: Union[str, torch.device] = "cuda",
               backend: Optional[str] = None, timeout_s: Optional[float] = None
               ) -> torch.device:
    """Join the default process group as rank `process_id` of
    `num_processes`; returns this rank's device (made current on a card).

    `coordinator_address` "host:port" is rank 0's store
    (`tcp://host:port`); empty or None reads torchrun's `env://` variables,
    with `num_processes` / `process_id` (when given) in place of
    `WORLD_SIZE` / `RANK`. Raises, naming what is missing, before anything
    is set up."""
    backend = backend or default_backend(device)
    if coordinator_address:
        if process_id is None or process_id < 0:
            raise ValueError(f"--num_processes {num_processes} with --coordinator_address "
                             f"needs this process's rank: pass --process_id")
        if not num_processes or num_processes < 1:
            raise ValueError("--coordinator_address needs --num_processes")
        init_method, world, r = f"tcp://{coordinator_address}", num_processes, process_id
    else:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT") if v not in os.environ]
        if process_id is None or process_id < 0:
            if "RANK" in os.environ:
                process_id = int(os.environ["RANK"])
            else:
                missing.insert(0, "--process_id (or RANK)")
        if not num_processes or num_processes < 1:
            if "WORLD_SIZE" in os.environ:
                num_processes = int(os.environ["WORLD_SIZE"])
            else:
                missing.append("--num_processes (or WORLD_SIZE)")
        if missing:
            raise ValueError(
                f"a multi-process run without --coordinator_address reads torchrun's "
                f"env:// variables; missing: {', '.join(missing)}")
        init_method, world, r = "env://", num_processes, process_id
    if not 0 <= r < world:
        raise ValueError(f"process_id {r} outside [0, {world})")
    dev = rank_device(device, backend, r)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=r, **kw)
    return dev


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """Ranks of the run (1 without a group)."""
    return world_size()


def is_main_process() -> bool:
    """True on the rank that owns file writes (checkpoints, dumps, summary,
    config.json); always True without a group."""
    return rank() == 0


def barrier(name: str = "") -> None:
    """Block until every rank is here (no-op in a world of one): a write
    before it on rank 0 is seen by every rank after it. `name` labels the
    call site for a reader of the code."""
    if world_size() > 1:
        dist.barrier()


def device_fetch(tree: Any) -> Any:
    """Tensors (each rank's rows) gathered over ranks in rank order and
    fetched to the host as NumPy; lists, tuples and dicts are walked, other
    leaves returned as they are."""
    if isinstance(tree, torch.Tensor):
        return gather_rows(tree.detach()).cpu().numpy()
    if isinstance(tree, dict):
        return {k: device_fetch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(device_fetch(v) for v in tree)
    return tree


def free_port() -> int:
    """A TCP port free on this host now (for a local coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(conn, fn: Callable, r: int, args: Sequence, threads: int) -> None:
    """A spawned rank: run `fn(r, *args)` with the parent's intra-op thread
    count (a CPU reduction's order follows it) and send back (ok, result
    or traceback, the kernels' launch counts)."""
    from ..ops import _cuda_build as cb

    torch.set_num_threads(threads)
    try:
        out = fn(r, *args)
    except BaseException:
        conn.send((False, traceback.format_exc(), {}))
        raise
    conn.send((True, out, {w.name: w.launches for w in cb.KERNELS}))


def spawn(fn: Callable, nprocs: int, args: Sequence = (), timeout_s: Optional[float] = None
          ) -> List[Any]:
    """Run `fn(rank, *args)` in `nprocs` fresh processes (`spawn`) and
    return their results in rank order. The first rank that fails stops the
    others and its traceback is raised; past `timeout_s` every rank is
    stopped and TimeoutError raised. Each rank's kernel launch counts are
    left in `last_rank_launches`."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    threads = torch.get_num_threads()
    procs, conns = [], []
    for r in range(nprocs):
        recv, send = ctx.Pipe(duplex=False)
        p = ctx.Process(target=_rank_main, args=(send, fn, r, tuple(args), threads),
                        daemon=True)
        p.start()
        send.close()
        procs.append(p)
        conns.append(recv)
    results: Dict[int, Any] = {}
    launches: Dict[int, Dict[str, int]] = {}
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    pending = dict(enumerate(conns))
    try:
        while pending:
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            ready = wait(list(pending.values()) + [procs[r].sentinel for r in pending], left)
            if not ready:
                raise TimeoutError(f"{nprocs} ranks still running after {timeout_s} s")
            for r, c in list(pending.items()):
                if c in ready or procs[r].sentinel in ready:
                    try:
                        ok, out, counts = c.recv()
                    except EOFError:
                        raise RuntimeError(f"rank {r} exited with code "
                                           f"{procs[r].exitcode} before reporting") from None
                    if not ok:
                        raise RuntimeError(f"rank {r} failed:\n{out}")
                    results[r], launches[r] = out, counts
                    del pending[r]
    finally:
        for p in procs:
            if pending:
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        for c in conns:
            c.close()
    last_rank_launches[:] = [launches[r] for r in range(nprocs)]
    return [results[r] for r in range(nprocs)]
