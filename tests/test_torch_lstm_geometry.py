"""The launch geometry of the biLSTM kernels B6
(`ops/cuda_lstm.py::forward_geometry`) and B7 (`backward_geometry`), checked
on the CPU: the kernels themselves run only on the card
(tests/test_torch_kernels_gpu.py), but what they are launched with is plain
integer arithmetic.

- the forward's block fits Hopper's limits at every H the wrapper takes,
  its warps cover every hidden unit, every row of W_hh^T is resident, in
  registers or read from L2, and at the main path's H=128 none is read from
  L2;
- the dW_hh^T / db_hh partials: the chunks of the T*B (t, row) pairs cover
  every pair exactly once, in increasing order, each non-empty, as the
  ordered sum of the partials needs;
- the dW product and the gates' product fill the H100 (132 SMs) at the
  main path's two shapes;
- the recurrence's block fits Hopper's limits at every H the wrapper takes
  and holds every (unit, row) pair of its tile, and the wrapper's constants
  are the CUDA source's.
"""

import re
from pathlib import Path

import pytest

from deep_interpolation_clustering_tpu_torch.ops import cuda_lstm as cl

SOURCE = Path(cl.__file__).resolve().parent.parent / "csrc" / "lstm.cu"
REGISTERS_PER_SM = 65_536
H100_SMS = 132


def _cuda_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"csrc/lstm.cu defines no {name}"
    return int(m.group(1))


@pytest.mark.parametrize("h", [1, 3, 16, 100, 128, 200, 256])
@pytest.mark.parametrize("t", [1, 6, 9, 48])
def test_dw_chunks_cover_every_pair_once_in_order(t, h):
    for b in (1, 13, 256, 512, 4096, 8192):
        geo = cl.backward_geometry(t, b, h)
        m_total = t * b
        bounds = [(i * geo.chunk, min(m_total, (i + 1) * geo.chunk)) for i in range(geo.nsplit)]
        assert bounds[0][0] == 0 and bounds[-1][1] == m_total
        assert all(lo < hi for lo, hi in bounds), "an empty chunk"
        assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:])), "a gap or an overlap"
        assert geo.chunk % cl.GEMM_STAGE == 0
        assert 1 <= geo.nsplit <= 1024  # dicl_lstm_bwd's limit
        tiles = 2 * -(-h // cl.GEMM_TILE_A) * -(-4 * h // cl.GEMM_TILE_N)
        assert geo.dw_blocks == tiles * geo.nsplit


@pytest.mark.parametrize("b", [256, 512])
def test_dw_grid_fills_the_card_at_the_main_path_shapes(b):
    geo = cl.backward_geometry(6, b, 128)  # the decoder's B=256, the encoder's B=512
    assert geo.dw_blocks >= H100_SMS
    assert geo.gate_blocks >= H100_SMS


@pytest.mark.parametrize("h", [1, 16, 33, 100, 128, 129, 200, 256])
def test_recurrence_block_fits_hopper(h):
    for b in (1, 13, 512):
        geo = cl.backward_geometry(6, b, h)
        assert geo.threads % 32 == 0 and 32 <= geo.threads <= cl.BWD_MAX_THREADS <= 1024
        if 4 * h <= cl.BWD_MAX_THREADS:
            assert geo.threads >= 4 * h  # one thread per dh work item
        else:
            assert geo.threads * 2 >= 4 * h  # at most two work items per thread
        pairs = -(-h // 8) * 8 * geo.rows  # the tile's (unit, row) slots
        assert geo.threads * cl.BWD_PAIR_CAP >= pairs
        assert geo.blocks == 2 * -(-b // geo.rows)
        # __launch_bounds__(BWD_MAX_THREADS) leaves each thread this many
        # registers when one block holds the SM: H=256 runs at that bound
        assert REGISTERS_PER_SM // cl.BWD_MAX_THREADS >= 128
        assert geo.smem_bytes <= cl.SMEM_PER_BLOCK
        assert 0 <= geo.resident_rows <= 4 * h
    for rows in (4, 8, 16):  # the rows-per-block sweep's range, at the main path's H
        geo = cl.backward_geometry(6, 512, 128, rows)
        assert geo.smem_bytes <= cl.SMEM_PER_BLOCK and geo.resident_rows > 0


def test_forward_block_fits_hopper_at_every_width():
    for h in range(1, cl.MAX_HIDDEN + 1):
        geo = cl.forward_geometry(512, h)
        assert geo.smem_bytes <= cl.SMEM_PER_BLOCK, h
        assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024, h
        assert geo.resident_rows > 0, h


@pytest.mark.parametrize("h", [1, 3, 16, 33, 100, 104, 105, 128, 129, 200, 256])
def test_forward_block_covers_units_and_rows(h):
    for b in (1, 13, 512):
        geo = cl.forward_geometry(b, h)
        assert geo.threads % 32 == 0 and 32 <= geo.threads <= cl.FWD_MAX_THREADS <= 1024
        items = -(-h // cl.FWD_GROUP)  # warp items: FWD_GROUP units x FWD_SPLITS splits
        assert cl.FWD_GROUP * cl.FWD_SPLITS == 32
        assert geo.threads // 32 * 2 >= items  # at most two items a warp
        assert geo.blocks == 2 * -(-b // geo.rows)
        assert geo.smem_bytes <= cl.SMEM_PER_BLOCK
        assert geo.smem_bytes % 16 == 0  # W_hh^T rows start on a float4
        # the resident rows are whole k iterations (zero rows past H included)
        assert geo.resident_rows % cl.FWD_SPLITS == 0 and geo.resident_rows > 0
        on_chip = min(h, geo.resident_rows)
        assert on_chip + geo.register_rows + geo.l2_rows == h
        assert geo.register_rows <= cl.FWD_TAIL_ITERS * cl.FWD_SPLITS
        if geo.threads // 32 < items:  # two items a warp: no registers for W
            assert geo.register_rows == 0
        # the 32 lanes of a warp item read 32 banks: a stride of 8 mod 32 words
        stride = (geo.smem_bytes // 4 - 2 * -(-h // 4) * 4 * geo.rows) // geo.resident_rows
        assert stride % 32 == 8 and stride >= 4 * h


def test_forward_keeps_w_on_chip_at_the_main_path_width():
    for b in (256, 512):  # the decoder's and the encoder's batch
        geo = cl.forward_geometry(b, 128)
        assert geo.threads == 512 and geo.rows == cl.FWD_ROWS
        assert geo.resident_rows >= 100
        assert geo.l2_rows == 0
        assert geo.blocks <= H100_SMS  # one wave at one block per SM
    for rows in (4, 8, 16):  # the rows-per-block sweep's range
        geo = cl.forward_geometry(512, 128, rows)
        assert geo.smem_bytes <= cl.SMEM_PER_BLOCK and geo.resident_rows >= 100
    assert cl.forward_geometry(512, 256).l2_rows > 0  # 1 MB of W_hh^T a direction


def test_wrapper_constants_are_the_sources():
    assert cl.FWD_ROWS == _cuda_constant("kRows")
    assert cl.FWD_MAX_THREADS == _cuda_constant("kFwdMaxThreads")
    assert cl.FWD_GROUP == _cuda_constant("kFwdGroup")
    assert cl.FWD_SPLITS == _cuda_constant("kFwdSplits")
    assert cl.FWD_TAIL_ITERS == _cuda_constant("kFwdTailIters")
    assert cl.BWD_ROWS == _cuda_constant("kBwdRows")
    assert cl.BWD_MAX_THREADS == _cuda_constant("kBwdMaxThreads")
    assert cl.BWD_PAIR_CAP == cl.BWD_ROWS // 2  # kBwdRows / 2
    assert cl.DH_SPLITS == _cuda_constant("kDhSplits")
    assert cl.GEMM_TILE_A == _cuda_constant("kGemmTileA")
    assert cl.GEMM_TILE_N == _cuda_constant("kGemmTileN")
    assert cl.GEMM_STAGE == _cuda_constant("kGemmStage")
    assert cl.SMEM_PER_BLOCK == _cuda_constant("kSmemLimit")
    assert cl.MAX_HIDDEN == _cuda_constant("kMaxHidden")
