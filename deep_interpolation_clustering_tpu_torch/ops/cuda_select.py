"""Exact-k fake-sample select (counterpart of the JAX `ops/pallas_select.py`).

For each (encounter, channel) row it takes exactly k of the first `n_valid`
slots: the k smallest 30-bit keys, a key being the random high bits of the
slot's 32-bit draw above the slot position. On a CUDA tensor this is a
hand-written kernel in `csrc/fake_select.cu`, routed by T as the JAX
`_select_local` routes on the TPU: for T <= 192 the packed kernel
(`fake_select_packed`, `pack_factor(T)` rows per block), above it K1
(`fake_select`, one row per block). The plain version of both is the sort
oracle `_select_sort`, the JAX `_select_xla`. All three are bit-identical.

Bits travel as int32 tensors holding the uint32 bit patterns (torch's
uint32 has few operations); every shift of them is logical.
"""

from __future__ import annotations

import torch

from . import _cuda_build as cb

_KEY_BITS = 30
_INVALID = 0x7FFFFFFF  # int32 max: sorts after every valid key
_PACK_SLOTS = 384  # slots per block of the packed kernel


def pos_bits(t: int) -> int:
    """Low key bits reserved for the slot position (unique within a row)."""
    return max(1, (t - 1).bit_length())


def pack_factor(t: int) -> int:
    """Rows per block of the packed select (the JAX `_pack_factor`); 1 means
    the row-per-block K1."""
    return max(1, _PACK_SLOTS // t)


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
    if not (rows >= 1 and 1 <= t_len <= _PACK_SLOTS // 2):
        raise ValueError(f"fake_select_packed: takes 1 <= T <= {_PACK_SLOTS // 2} and "
                         f">= 1 row, got ({rows}, {t_len})")
    g = pack_factor(t_len)
    cb.check("fake_select_packed bits", bits, torch.int32)
    cb.check("fake_select_packed n_valid", n_valid, torch.int32, (rows,))
    cb.check("fake_select_packed k", k, torch.int32, (rows,))
    out = torch.empty((rows, t_len), dtype=torch.bool, device=bits.device)
    fn = cb.c_function("fake_select", "dicl_fake_select_packed", 4, 4)
    cb.raise_on_error("fake_select_packed", fn(
        cb.ptr(bits), cb.ptr(n_valid), cb.ptr(k), cb.ptr(out),
        rows, t_len, g, pos_bits(t_len), cb.stream_of(bits),
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
        fn = fake_select_packed if pack_factor(t) >= 2 else fake_select
    sel = fn(bits.reshape(b * c, t), n_valid.reshape(b * c), k.reshape(b * c))
    return sel.reshape(b, c, t)
