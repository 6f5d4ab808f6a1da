"""Exact-k fake-sample select (counterpart of the JAX `ops/pallas_select.py`).

For each (encounter, channel) row it takes exactly k of the first `n_valid`
slots: the k smallest 30-bit keys, a key being the random high bits of the
slot's 32-bit draw above the slot position. On a CUDA tensor this is the
hand-written kernel of `csrc/fake_select.cu`, a warp or a team of warps a
row with the row's keys in registers up to T = 1024 and a block of 8 warps
that walks a longer row on every pass (`select_layout(T)`), behind two
wrappers with a launch count each: `fake_select_packed` for the rows of the JAX packed
kernel (T <= `PACKED_MAX_T`) and `fake_select` for the rows of its unpacked
one; `fake_select_mask` routes by T between them. The plain version of both
is the sort oracle `_select_sort`, the JAX `_select_xla`. All are
bit-identical.

Bits travel as int32 tensors holding the uint32 bit patterns (torch's
uint32 has few operations); every shift of them is logical.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda_build as cb

_KEY_BITS = 30
_INVALID = 0x7FFFFFFF  # int32 max: sorts after every valid key

# The kernel's layout; the constants are csrc/fake_select.cu's.
SELECT_MAX_T = 1024  # kMaxT: the longest row held in registers
LOOP_WARPS = 8  # kLoopWarps: warps of the block that walks a longer row
LANE_SLOTS = 6  # kLaneSlots: a row takes the fewest warps that keep a lane to this many slots
MAX_WARPS = 4  # kMaxWarps: ... but no more warps than this (one row a block above 1)
WARP_ROWS = 8  # kWarpRows: rows a block when a warp owns a row
# The rows `fake_select_mask` counts as the packed kernel's: those the JAX
# package packs two or more to a 384-lane row (`_pack_factor(T) >= 2`).
PACKED_MAX_T = 192


def pos_bits(t: int) -> int:
    """Low key bits reserved for the slot position (unique within a row)."""
    return max(1, (t - 1).bit_length())


def select_layout(t: int) -> Tuple[int, int, int]:
    """The kernel's layout for rows of `t` slots, as csrc/fake_select.cu
    chooses and checks it -> (warps a row, slots a lane, rows a block).
    Up to SELECT_MAX_T a lane holds its slots in registers: the fewest of
    1, 2 or 4 warps that keep a lane to LANE_SLOTS slots (a warp a row up
    to T=192, two up to 384, four up to 1024), WARP_ROWS rows a block for a
    warp a row and one row a block for a team. Above, LOOP_WARPS warps a
    row, one row a block, and a lane walks its slots on every pass. Warp w
    of a row's team owns the 32 x slots consecutive slots from
    32 x slots x w on, lane l the slots l, l + 32, ... of them."""
    if t < 1:
        raise ValueError(f"fake_select: takes rows of T >= 1 slots, got {t}")
    if t > SELECT_MAX_T:
        return LOOP_WARPS, -(-t // (32 * LOOP_WARPS)), 1
    warps = 1
    while warps < MAX_WARPS and t > 32 * warps * LANE_SLOTS:
        warps *= 2
    return warps, -(-t // (32 * warps)), WARP_ROWS if warps == 1 else 1


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


def _launcher(name: str, max_t: Optional[int] = None):
    """The launch of the select kernel for the wrapper `name`, which takes
    rows of up to `max_t` slots (any length with None)."""
    def launch(bits: torch.Tensor, n_valid: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        rows, t_len = bits.shape
        if not (rows >= 1 and 1 <= t_len <= (max_t or t_len)):
            limit = f"1 <= T <= {max_t}" if max_t else "T >= 1"
            raise ValueError(f"{name}: takes {limit} and >= 1 row, got ({rows}, {t_len})")
        warps, slots, block_rows = select_layout(t_len)
        cb.check(f"{name} bits", bits, torch.int32)
        cb.check(f"{name} n_valid", n_valid, torch.int32, (rows,))
        cb.check(f"{name} k", k, torch.int32, (rows,))
        out = torch.empty((rows, t_len), dtype=torch.bool, device=bits.device)
        fn = cb.c_function("fake_select", "dicl_fake_select", 4, 6)
        cb.raise_on_error(name, fn(
            cb.ptr(bits), cb.ptr(n_valid), cb.ptr(k), cb.ptr(out),
            rows, t_len, warps, slots, block_rows, pos_bits(t_len), cb.stream_of(bits),
        ))
        return out
    return launch


_SOURCE = "deep_interpolation_clustering_tpu_torch/csrc/fake_select.cu"
_PALLAS_SELECT = "deep_interpolation_clustering_tpu/ops/pallas_select.py"

fake_select = cb.register(cb.KernelWrapper(
    "fake_select", _SOURCE, f"{_PALLAS_SELECT}:122", _select_sort,
    _launcher("fake_select")))
fake_select_packed = cb.register(cb.KernelWrapper(
    "fake_select_packed", _SOURCE, f"{_PALLAS_SELECT}:202", _select_sort,
    _launcher("fake_select_packed", PACKED_MAX_T)))


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
