"""The data-parallel world and its collectives (counterpart of the JAX
`parallel/mesh.py`).

The JAX package shards the batch over a 1-D device mesh and lets XLA insert
the gradient sum and the global-batch reductions. Here each rank of a
`torch.distributed` group is one process with one device. Every rank holds
the whole model and the whole cohort, and takes a contiguous block of rows
of each global batch: rank r of D holds rows [r*B/D, (r+1)*B/D). The ops
ask this module for the world and reduce over it where the single-device
code reduces over the batch:

  * a sum over ranks without autograd (`all_sum`: counts, the DEC target's
    cluster frequencies, the reported losses);
  * a sum over ranks with autograd (`all_sum_grad`: BatchNorm moments),
    whose backward sums the incoming gradients over ranks, so that every
    rank back-propagates only its own share of the loss;
  * a gather of rows with autograd (`gather_rows`), as an `all_reduce` over
    a zero-filled (D, rows, ...) buffer in which each rank fills its own
    slot: exact, since x + 0 = x;
  * a broadcast from rank 0 (`broadcast_`);
  * for row-sharded data (p2's latents), rows at global indices fetched
    from their owners (`take_rows`, the same zero-filled sum) and an
    elementwise min or max over ranks (`all_min`, `all_max`).

Every collective here is an `all_reduce` (a sum, or p2's min and max) or a
`broadcast`, which NCCL and gloo both offer for CUDA tensors and gloo for
CPU tensors, so one code path serves NCCL, gloo on the CPU and gloo on
ranks that share one card (`cohort` adds the epoch relayout's
`all_to_all_single`).

Without a process group every helper returns its input: the single-device
code runs unchanged. In a group, of any size, the helpers that talk to
other ranks run their collective, one rank included, so that a one-rank
group issues the calls that D ranks issue; over one rank a sum is its
input and the zero-filled gather is exact, so the bits are those of no
group. The purely local helpers (`shard_rows`, `local_rows`,
`segment_rows`) and the callers' numerics follow `world_size()` alone.

Inside a train or eval step every helper reads nothing to the host,
allocates only tensors whose shapes follow from the batch, D and the
config, and issues its collectives in the same order on every rank: what
a CUDA graph needs to capture the step with its collectives
(`train/graphs.py`). `capturable()` says whether the group's collectives
can be captured: NCCL's can, gloo's run on the host and cannot.
`replicated()` reads to the host and runs outside every graph.

Each collective a helper issues is counted where it is issued
(`issued()`, with the tracer of `utils.tracing` on): `collective.captured`
while the calling thread's stream is being captured into a CUDA graph (an
autograd backward runs on the forward's stream), else `collective.eager`.
A replay issues none from the host and counts none.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import tracing


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def grouped() -> bool:
    """Whether this process is a rank of a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def capturable() -> bool:
    """Whether a CUDA graph can capture a step's collectives: true without a
    group (a step issues none) and in a NCCL group whose collectives do
    not wait on the host (`TORCH_NCCL_BLOCKING_WAIT`); false for gloo, whose
    collectives run on the host."""
    if not grouped():
        return True
    blocking = os.environ.get("TORCH_NCCL_BLOCKING_WAIT", os.environ.get("NCCL_BLOCKING_WAIT"))
    return dist.get_backend() == "nccl" and blocking not in ("1", "true", "True")


def issued() -> None:
    """Count one collective about to be issued (nothing with the tracer
    off)."""
    if tracing.enabled():
        capturing = torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()
        tracing.count("collective.captured" if capturing else "collective.eager")


def shard_rows(n: int) -> slice:
    """This rank's rows of a global batch of `n` rows."""
    d = world_size()
    if n % d:
        raise ValueError(f"{n} rows do not split over {d} ranks")
    k = n // d
    r = rank()
    return slice(r * k, (r + 1) * k)


def _all_reduce(t: torch.Tensor, op) -> torch.Tensor:
    if not grouped():
        return t
    out = t.detach().clone(memory_format=torch.contiguous_format)
    issued()
    dist.all_reduce(out, op=op)
    return out


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over ranks, detached from autograd (`t` itself
    without a group)."""
    return _all_reduce(t, dist.ReduceOp.SUM)


class _AllSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the gradients over ranks too (each
    rank's gradient is that of its own share of the loss)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        issued()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone(memory_format=torch.contiguous_format)
        issued()
        dist.all_reduce(g)
        return g


def all_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over ranks, with autograd."""
    if not grouped():
        return t
    return _AllSum.apply(t)


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `t` in rank order, with autograd: (D*n, ...)."""
    if not grouped():
        return t
    d, r = world_size(), rank()
    zeros = torch.zeros_like(t) if d > 1 else None
    slots = torch.stack([t if i == r else zeros for i in range(d)])
    return all_sum_grad(slots).reshape((d * t.shape[0],) + tuple(t.shape[1:]))


def gather_blocks(t: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """`t` holds this rank's share of `n_blocks` global batches, block after
    block; returns the global batches' rows in order (every rank's share of
    block 0, then of block 1, ...)."""
    if not grouped():
        return t
    d = world_size()
    rest = tuple(t.shape[1:])
    k = t.shape[0] // n_blocks
    g = gather_rows(t).reshape((d, n_blocks, k) + rest)
    return g.transpose(0, 1).reshape((d * n_blocks * k,) + rest)


def permuted_share(a: torch.Tensor, b: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """This rank's share of `torch.cat([A, B])[perm]`, where A and B are the
    global batches whose local rows are `a` and `b` and `perm` permutes the
    global 2B rows; with autograd through the gather."""
    if not grouped():
        return torch.cat([a, b])[perm]
    d = world_size()
    rest = tuple(a.shape[1:])
    g = gather_rows(torch.cat([a, b])).reshape((d, 2, a.shape[0]) + rest)
    rows = g.transpose(0, 1).reshape((2 * d * a.shape[0],) + rest)[perm]
    return rows[shard_rows(rows.shape[0])]


def local_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of a tensor drawn at the global batch shape along
    `dim`."""
    if world_size() == 1:
        return t
    index = [slice(None)] * t.dim()
    index[dim] = shard_rows(t.shape[dim])
    return t[tuple(index)]


def segment_rows(t: torch.Tensor, counts: Sequence[int]) -> torch.Tensor:
    """This rank's rows of a global plane made of segments that hold
    `counts[i] * D` rows each (segment i's local rows are `counts[i]`):
    the rank's block of every segment, in order."""
    d = world_size()
    if d == 1:
        return t
    r = rank()
    parts, off = [], 0
    for n in counts:
        parts.append(t[off + r * n: off + (r + 1) * n])
        off += n * d
    return torch.cat(parts)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The rows at global indices `idx` (any shape) of a row-sharded array
    whose rank r holds rows [r*n, (r+1)*n) as `x` (n, ...): each rank fills
    the rows it holds into a zero buffer and the buffers are summed, which
    is exact. `x[idx]` itself without a group."""
    if not grouped():
        return x[idx]
    n = x.shape[0]
    local = idx - rank() * n
    mine = (local >= 0) & (local < n)
    out = torch.zeros(tuple(idx.shape) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[mine] = x[local[mine]]
    return all_sum(out)


def all_min(t: torch.Tensor) -> torch.Tensor:
    """The elementwise minimum of `t` over ranks."""
    return _all_reduce(t, dist.ReduceOp.MIN)


def all_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of `t` over ranks."""
    return _all_reduce(t, dist.ReduceOp.MAX)


def all_sum_grads_(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over ranks in place, through one flat
    buffer (parameters without a gradient keep none)."""
    if not grouped():
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    issued()
    dist.all_reduce(flat)
    off = 0
    for g in grads:
        g.copy_(flat[off: off + g.numel()].view_as(g))
        off += g.numel()


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor in place with rank `src`'s."""
    if not grouped():
        return
    with torch.no_grad():
        for t in tensors:
            issued()
            if t.is_contiguous():
                dist.broadcast(t, src)
            else:
                buf = t.contiguous()
                dist.broadcast(buf, src)
                t.copy_(buf)


def replicated(named: Sequence[Tuple[str, torch.Tensor]]) -> List[str]:
    """The names of the tensors that differ, in any bit, from rank 0's; the
    same list on every rank. Tensors on the CPU (an optimizer's step count)
    are compared on the first tensor's device."""
    if world_size() == 1 or not named:
        return []
    dev = named[0][1].device
    flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float64) for _, t in named])
    ref = flat.clone()
    issued()
    dist.broadcast(ref, 0)
    differ = flat != ref  # float64 holds every float32 and int64 count below 2^53
    ends = np.cumsum([t.numel() for _, t in named]).tolist()
    bad = torch.stack([differ[a:b].any() for a, b in zip([0] + ends[:-1], ends)])
    bad = all_sum(bad.to(torch.float64))
    return [name for (name, _), b in zip(named, bad.tolist()) if b]


def pad_batch_to(batch: Dict[str, np.ndarray], size: int
                 ) -> Tuple[Dict[str, np.ndarray], int]:
    """Pad every array's leading axis to `size` by cyclically repeating the
    real rows and add `sample_mask` (1 on the real rows), as the JAX
    `pad_batch_to`: repeated rows, not zeros, so that every value stays
    finite (an all-zero row has an all-zero padding mask, and the
    interpolation's masked log-sum-exp would give NaN that poisons the
    gradients). A rank whose share holds only padding then still computes
    finite values that the mask leaves out. Returns `(padded, n_real)`."""
    n: Optional[int] = None
    for v in batch.values():
        if isinstance(v, np.ndarray):
            n = v.shape[0]
            break
    if n is None or not 0 < n <= size:
        raise ValueError(f"cannot pad {n} rows to {size}")
    wrap = np.arange(size) % n
    out = {k: (v[wrap] if isinstance(v, np.ndarray) and v.shape[0] == n else v)
           for k, v in batch.items()}
    mask = np.zeros((size,), np.float32)
    mask[:n] = 1.0
    out["sample_mask"] = mask
    return out, n
