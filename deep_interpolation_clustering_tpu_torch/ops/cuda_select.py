"""Exact-k fake-sample select (counterpart of the JAX `ops/pallas_select.py`).

For each (encounter, channel) row it takes exactly k of the first `n_valid`
slots: the k smallest 30-bit keys, a key being the random high bits of the
slot's 32-bit draw above the slot position. On a CUDA tensor this is a
hand-written kernel in `csrc/fake_select.cu`, routed by T: up to
`PACKED_MAX_T` the packed kernel (`fake_select_packed`: a warp a row,
several rows a block, `packed_layout(T)`), above it K1 (`fake_select`, one
row per block). The plain version of both is the sort oracle
`_select_sort`, the JAX `_select_xla`. All three are bit-identical.

Bits travel as int32 tensors holding the uint32 bit patterns (torch's
uint32 has few operations); every shift of them is logical.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda_build as cb

_KEY_BITS = 30
_INVALID = 0x7FFFFFFF  # int32 max: sorts after every valid key

# The packed kernel's layout; the constants are csrc/fake_select.cu's.
PACKED_WARPS = 8  # kPackWarps: rows a block, a warp each
PACKED_MAX_SLOTS = 6  # kPackMaxSlots: slots a lane holds at most
# The longest row the packed kernel takes. Every row it takes is routed to
# it: measured on an H100 at T = 16, 48, 96 and 192 it is more than twice as
# fast as K1 on the same rows (PERF.md), so no crossover lies below this.
PACKED_MAX_T = 32 * PACKED_MAX_SLOTS


def pos_bits(t: int) -> int:
    """Low key bits reserved for the slot position (unique within a row)."""
    return max(1, (t - 1).bit_length())


def packed_layout(t: int) -> Tuple[int, int]:
    """The packed kernel's layout for rows of `t` slots, as
    csrc/fake_select.cu chooses and checks it -> (slots a lane holds in
    registers, rows a block). A warp owns a row; lane l holds slots l,
    l + 32, ..."""
    if not 1 <= t <= PACKED_MAX_T:
        raise ValueError(f"fake_select_packed: takes 1 <= T <= {PACKED_MAX_T}, got {t}")
    return -(-t // 32), PACKED_WARPS


def _select_sort(bits: torch.Tensor, n_valid: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version: `bits` (rows, T) int32, `n_valid`/`k` (rows,) int32 ->
    (rows, T) bool, by sorting the combined keys (the JAX `_select_xla`)."""
    rows, t_len = bits.shape
    low_mask = (1 << pos_bits(t_len)) - 1
    pos = torch.arange(t_len, dtype=torch.int32, device=bits.device).expand(rows, t_len)
    # logical >> (32 - KEY_BITS) of the uint32 pattern: arithmetic shift, then
    # clear the sign-extended bits
    rand = (bits >> (32 - _KEY_BITS)) & ((1 << _KEY_BITS) - 1)
    combined = (rand & ~low_mask) | pos
    combined = torch.where(pos < n_valid[:, None], combined,
                           torch.full_like(combined, _INVALID))
    kth = torch.gather(torch.sort(combined, dim=-1).values, 1,
                       torch.clamp(k - 1, min=0)[:, None].long())
    return (combined <= kth) & (k[:, None] > 0)


def _launch(bits: torch.Tensor, n_valid: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    rows, t_len = bits.shape
    if not (rows >= 1 and 1 <= t_len <= 1024):
        raise ValueError(f"fake_select: takes 1 <= T <= 1024 and >= 1 row, "
                         f"got ({rows}, {t_len})")
    cb.check("fake_select bits", bits, torch.int32)
    cb.check("fake_select n_valid", n_valid, torch.int32, (rows,))
    cb.check("fake_select k", k, torch.int32, (rows,))
    out = torch.empty((rows, t_len), dtype=torch.bool, device=bits.device)
    fn = cb.c_function("fake_select", "dicl_fake_select", 4, 3)
    cb.raise_on_error("fake_select", fn(
        cb.ptr(bits), cb.ptr(n_valid), cb.ptr(k), cb.ptr(out),
        rows, t_len, pos_bits(t_len), cb.stream_of(bits),
    ))
    return out


def _launch_packed(bits: torch.Tensor, n_valid: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    rows, t_len = bits.shape
    if rows < 1:
        raise ValueError(f"fake_select_packed: takes >= 1 row, got ({rows}, {t_len})")
    slots, warps = packed_layout(t_len)
    cb.check("fake_select_packed bits", bits, torch.int32)
    cb.check("fake_select_packed n_valid", n_valid, torch.int32, (rows,))
    cb.check("fake_select_packed k", k, torch.int32, (rows,))
    out = torch.empty((rows, t_len), dtype=torch.bool, device=bits.device)
    fn = cb.c_function("fake_select", "dicl_fake_select_packed", 4, 5)
    cb.raise_on_error("fake_select_packed", fn(
        cb.ptr(bits), cb.ptr(n_valid), cb.ptr(k), cb.ptr(out),
        rows, t_len, slots, warps, pos_bits(t_len), cb.stream_of(bits),
    ))
    return out


_SOURCE = "deep_interpolation_clustering_tpu_torch/csrc/fake_select.cu"
_PALLAS_SELECT = "deep_interpolation_clustering_tpu/ops/pallas_select.py"

fake_select = cb.register(cb.KernelWrapper(
    "fake_select", _SOURCE, f"{_PALLAS_SELECT}:122", _select_sort, _launch))
fake_select_packed = cb.register(cb.KernelWrapper(
    "fake_select_packed", _SOURCE, f"{_PALLAS_SELECT}:202", _select_sort, _launch_packed))


def fake_select_mask(bits: torch.Tensor, n_valid: torch.Tensor, k: torch.Tensor,
                     use_kernel: bool = True) -> torch.Tensor:
    """`bits` (B, C, T) int32 bit patterns; `n_valid`, `k` (B, C) int32 with
    0 <= k <= n_valid -> (B, C, T) bool with exactly k True per row among
    the first n_valid slots. `use_kernel=False` takes the plain version on
    any device."""
    b, c, t = bits.shape
    fn = _select_sort
    if use_kernel:
        fn = fake_select_packed if t <= PACKED_MAX_T else fake_select
    sel = fn(bits.reshape(b * c, t), n_valid.reshape(b * c), k.reshape(b * c))
    return sel.reshape(b, c, t)
