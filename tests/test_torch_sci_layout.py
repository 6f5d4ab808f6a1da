"""The layout of the SCI kernels B3 and B4 and of the RBF push B5
(`ops/cuda_interp.py::sci_row_layout`, one rule for the three), checked on
the CPU: the kernels themselves run only on the card
(tests/test_torch_kernels_gpu.py), but which of their layouts a row length
gets is plain integer arithmetic that the C entries check again.

- a row of up to 64 slots gets a warp, a longer one a block of 128 threads;
- the slots a thread holds in registers cover the row, and a row too long
  for three slots a thread gets the looping layout;
- the main path's T=354 gets a block with three slots a thread, the scaled
  path's T=48 a warp with two;
- the wrapper's constants are the CUDA source's, csrc/rbf.cu states
  csrc/sci.cu's again, and each source instantiates every layout the rule
  can choose, for each of its kernels.
"""

import re
from pathlib import Path

import pytest

from deep_interpolation_clustering_tpu_torch.ops import cuda_interp as ci

SOURCE = Path(ci.__file__).resolve().parent.parent / "csrc" / "sci.cu"
RBF_SOURCE = SOURCE.with_name("rbf.cu")


def _cuda_constant(name, source=SOURCE):
    m = re.search(rf"constexpr int {name} = (\d+);", source.read_text())
    assert m, f"csrc/{source.name} defines no {name}"
    return int(m.group(1))


@pytest.mark.parametrize("t,want", [
    (1, (1, 1)), (32, (1, 1)), (33, (1, 2)), (48, (1, 2)), (64, (1, 2)), (65, (4, 1)),
    (128, (4, 1)), (129, (4, 2)), (256, (4, 2)), (257, (4, 3)), (354, (4, 3)), (384, (4, 3)),
    (385, (4, 0)), (1024, (4, 0))])
def test_layout_at_the_boundaries(t, want):
    assert ci.sci_row_layout(t) == want


def test_held_slots_cover_every_row_length():
    for t in range(1, 2049):
        warps, slots = ci.sci_row_layout(t)
        assert warps in (1, ci.SCI_BWD_THREADS // 32)
        team = 32 * warps
        if slots:
            assert team * (slots - 1) < t <= team * slots  # no idle slot index, none missing
            assert slots <= (ci.SCI_BWD_WARP_SLOTS if warps == 1 else ci.SCI_BWD_BLOCK_SLOTS)
        else:
            assert t > ci.SCI_BWD_THREADS * ci.SCI_BWD_BLOCK_SLOTS


def test_wrapper_constants_are_the_sources():
    assert ci.SCI_BWD_THREADS == _cuda_constant("kBwdThreads")
    assert ci.SCI_BWD_WARP_SLOTS == _cuda_constant("kBwdWarpSlots")
    assert ci.SCI_BWD_BLOCK_SLOTS == _cuda_constant("kBwdBlockSlots")
    assert ci.SCI_BWD_THREADS % 32 == 0


def test_source_instantiates_every_layout():
    text = SOURCE.read_text()
    layouts = {ci.sci_row_layout(t) for t in range(1, 2049)}
    assert layouts == {(1, 1), (1, 2), (4, 1), (4, 2), (4, 3), (4, 0)}
    for warps, slots in layouts:
        assert f"launch_bwd<R, {warps}, {slots}>" in text, (warps, slots)


@pytest.mark.parametrize("t,want", [
    (1, (1, 1)), (32, (1, 1)), (33, (1, 2)), (64, (1, 2)), (65, (4, 1)), (128, (4, 1)),
    (129, (4, 2)), (384, (4, 3)), (385, (4, 0)), (1024, (4, 0))])
def test_forward_layout_at_the_boundaries(t, want):
    assert ci.sci_row_layout(t) == want


def test_source_instantiates_every_forward_layout():
    text = SOURCE.read_text()
    for warps, slots in {ci.sci_row_layout(t) for t in range(1, 2049)}:
        assert f"launch_fwd<R, {warps}, {slots}>" in text, (warps, slots)
    # both C entries check the wrapper's layout against the source's rule
    assert text.count("row_layout(t_len, want_warps, want_slots);") == 2


def test_rbf_source_states_the_sci_layout():
    """csrc/rbf.cu's layout constants equal csrc/sci.cu's, it instantiates
    every layout the rule can choose, and its C entry checks the wrapper's."""
    for rbf_name, sci_name in (("kRowThreads", "kBwdThreads"), ("kWarpSlots", "kBwdWarpSlots"),
                               ("kBlockSlots", "kBwdBlockSlots")):
        assert _cuda_constant(rbf_name, RBF_SOURCE) == _cuda_constant(sci_name), rbf_name
    text = RBF_SOURCE.read_text()
    for warps, slots in {ci.sci_row_layout(t) for t in range(1, 2049)}:
        assert f"launch<R, {warps}, {slots}>" in text, (warps, slots)
    assert text.count("row_layout(t_len, want_warps, want_slots);") == 1
