"""Row-sharded cohort storage on the data-parallel ranks (counterpart of the
JAX `parallel/cohort.py`).

Replicated, every rank holds the whole cohort on its device. Sharded, rank
r of D holds only its columns of every batch: the planes live in block
layout `(nb, B/D, ...)`, block k being rank r's rows [r*B/D, (r+1)*B/D) of
batch k, which are the rows the train step takes from a global batch
(`mesh.shard_rows`). Each epoch the host draws the replicated path's
shuffle and the storage is permuted into that order once (`ensure`): a
local gather of the rows each rank sends to each other rank, one
`all_to_all_single` per plane, a local scatter back into the same storage.
A step then reads block k of its own storage; no step gathers across
ranks. The batches, the draws and the numerics are the replicated path's,
bit for bit.

The storage keeps its addresses for the cohort's life: a relayout writes
the new order in place, so a CUDA graph captured over the storage reads
each epoch's order. A train step reads block k through a (1,) device
tensor that holds k (`block_at`, the JAX `slice_block`), which the graph's
index buffer is; `block` slices it, the reference the tests hold it to.

The transport is the group's: NCCL and gloo both take the device's tensors
in `all_to_all_single` (gloo took CUDA tensors, float32 and bfloat16, on
the H100 machine's torch 2.11, and CPU tensors on the CPU).

The routing plan is the JAX package's: host-side, from the storage's
current order of original row ids to the target order; a duplicated id
(the padded tail repeats real rows) may come from any of its copies; the
per-(source, destination) capacity is bucketed to a power of two.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import issued, rank, world_size


def _bucket(m: int) -> int:
    """A segment capacity rounded up to the next power of two (>= 16), as
    the JAX package buckets it (there to bound recompiles; here it keeps the
    buffers' shapes to a few sizes)."""
    m = max(int(m), 16)
    return 1 << (m - 1).bit_length()


class ShardedCohort:
    """A cohort's planes in block layout, this rank's `(nb, B/D, ...)` on
    `device`, with the host-tracked storage order.

    `order` is the `(nb, B)` matrix of original row ids stored at each block
    position (every rank's columns); `ensure(tgt)` permutes the storage to a
    new matrix (nothing when it is the same). Block k of `data3` is this
    rank's share of the batch `X[tgt[k]]` the replicated path gathers."""

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 device: torch.device):
        self.d = world_size()
        self.r = rank()
        self.b = int(batch_size)
        if self.b % self.d:
            raise ValueError(f"batch_size {self.b} not divisible by {self.d} ranks")
        self.pb = self.b // self.d  # batch columns per rank
        self.n = int(next(iter(arrays.values())).shape[0])
        self.nb = -(-self.n // self.b)
        self.n_local = self.nb * self.pb
        # the eval layout: a fresh cohort evaluates with no relayout
        self.order = self.identity_order()
        flat = self.order.reshape(-1)
        cols = slice(self.r * self.pb, (self.r + 1) * self.pb)
        self.data3: Dict[str, torch.Tensor] = {
            k: torch.as_tensor(np.ascontiguousarray(
                np.asarray(v)[flat].reshape((self.nb, self.b) + v.shape[1:])[:, cols]),
                device=device)
            for k, v in arrays.items()
        }

    # -------------------------------------------------------------- orders
    def identity_order(self) -> np.ndarray:
        """Rows in order, the tail clamped to the last row: the eval layout."""
        return np.minimum(np.arange(self.nb * self.b), self.n - 1).reshape(self.nb, self.b)

    def epoch_order(self, order: np.ndarray) -> np.ndarray:
        """An epoch's shuffle `order` (n,) as a block matrix; the tail block
        is the short batch padded by cycling the tail's own rows
        (`np.resize(tail, ...)`, the padded tail step's rows)."""
        if order.shape != (self.n,):
            raise ValueError(f"epoch order of shape {order.shape}, want ({self.n},)")
        n_pad = self.nb * self.b
        if n_pad == self.n:
            return order.reshape(self.nb, self.b)
        tail = order[(self.n // self.b) * self.b:]
        return np.concatenate([order, np.resize(tail, n_pad - self.n)]).reshape(
            self.nb, self.b)

    @property
    def eval_mask(self) -> np.ndarray:
        """(nb, B) float mask of the real rows under `identity_order`."""
        return (np.arange(self.nb * self.b) < self.n).astype(np.float32).reshape(
            self.nb, self.b)

    def tail_mask(self) -> np.ndarray:
        """(B,) float mask of the last block's real rows under an
        `epoch_order` (its first n - (nb-1)*B columns)."""
        m = np.zeros((self.b,), np.float32)
        m[: self.n - (self.nb - 1) * self.b] = 1.0
        return m

    # ------------------------------------------------------------ relayout
    def ensure(self, tgt: np.ndarray) -> None:
        """Permute the storage into order `tgt` ((nb, B) original ids, each
        id of [0, n) at least once); every rank calls it with the same
        `tgt`."""
        tgt = np.asarray(tgt)
        if tgt.shape != (self.nb, self.b):
            raise ValueError(f"target order of shape {tgt.shape}, want {(self.nb, self.b)}")
        if np.array_equal(tgt, self.order):
            return
        send, dst, m_cap = self._plan(self.order.reshape(-1), tgt.reshape(-1))
        dev = next(iter(self.data3.values())).device
        dst = dst[self.r].reshape(-1)
        keep = dst < self.n_local  # unfilled slots of a segment carry n_local
        send = torch.as_tensor(send[self.r].reshape(-1), device=dev)
        src = torch.as_tensor(np.flatnonzero(keep), device=dev)
        dst = torch.as_tensor(dst[keep], device=dev)
        for v in self.data3.values():
            self._relayout_(v, send, src, dst)
        self.order = tgt

    def _relayout_(self, a: torch.Tensor, send: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor) -> None:
        """Permute plane `a` in place: every slot of `a` is a destination
        of the plan, and what it receives was gathered into `buf` first."""
        flat = a.view((self.n_local,) + tuple(a.shape[2:]))
        buf = flat.index_select(0, send)  # (D*M, ...): segment j goes to rank j
        recv = torch.empty_like(buf)  # segment j came from rank j
        issued()
        dist.all_to_all_single(recv, buf)
        flat.index_copy_(0, dst, recv.index_select(0, src))

    def _plan(self, cur_flat: np.ndarray, tgt_flat: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, int]:
        """The routing plan: for each (source, destination) pair of ranks the
        source's local rows to send and the destination's local slots to
        fill, padded to a bucketed capacity M. Returns `send` (D_src, D_dst,
        M), `dst` (D_dst, D_src, M) (each indexed by its consumer's rank
        first) and M."""
        d, b, pb = self.d, self.b, self.pb
        pos_of = np.empty(self.n, np.int64)
        pos_of[cur_flat] = np.arange(cur_flat.size)  # any copy of an id serves
        src_pos = pos_of[tgt_flat]
        dst_pos = np.arange(tgt_flat.size)

        def rank_loc(p):
            j = p % b
            return j // pb, (p // b) * pb + (j % pb)

        s_rank, s_loc = rank_loc(src_pos)
        d_rank, d_loc = rank_loc(dst_pos)
        key = s_rank * d + d_rank
        o = np.argsort(key, kind="stable")
        key_s, s_loc_s, d_loc_s = key[o], s_loc[o], d_loc[o]
        counts = np.bincount(key_s, minlength=d * d)
        m_cap = _bucket(counts.max())
        starts = np.zeros(d * d, np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        slot = np.arange(key_s.size) - starts[key_s]
        send = np.zeros((d * d, m_cap), np.int64)
        dst = np.full((d * d, m_cap), self.n_local, np.int64)
        send[key_s, slot] = s_loc_s
        dst[key_s, slot] = d_loc_s
        return (send.reshape(d, d, m_cap), dst.reshape(d, d, m_cap).transpose(1, 0, 2),
                m_cap)

    # -------------------------------------------------------------- sizing
    def nbytes_per_device(self) -> int:
        """This rank's bytes of the cohort's storage (cohort / D, plus the
        tail's padding)."""
        return sum(v.numel() * v.element_size() for v in self.data3.values())

    def block(self, k: int) -> Dict[str, torch.Tensor]:
        """This rank's rows of batch k: a slice of its storage."""
        return {name: v[k] for name, v in self.data3.items()}

    def block_at(self, k: torch.Tensor) -> Dict[str, torch.Tensor]:
        """This rank's rows of the batch whose number the (1,) device tensor
        `k` holds: the values of `block(k)`, read through the index."""
        return {name: torch.index_select(v, 0, k)[0] for name, v in self.data3.items()}
