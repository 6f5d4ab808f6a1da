"""Port of the exact-k fake-sample select vs the JAX package.

The port's select (plain version on the CPU) must be BIT-IDENTICAL to the
JAX sort oracle `_select_xla` and to the Pallas kernels `_select_pallas`
and `_select_pallas_packed` (interpreter mode), given the same uint32 bits.
"""

import functools
import re
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.data.loader import make_fake_ob as jax_make_fake_ob
from deep_interpolation_clustering_tpu.ops import pallas_select as ps
from deep_interpolation_clustering_tpu_torch.data.loader import make_fake_ob
from deep_interpolation_clustering_tpu_torch.ops import cuda_select
from deep_interpolation_clustering_tpu_torch.ops.cuda_select import fake_select_mask

torch.set_num_threads(1)

B, C = 4, 6


def _draw(rng, t):
    counts = rng.randint(0, t + 1, size=(B, C)).astype(np.int32)
    counts[0, :2] = 0  # rows with k = 0
    counts[1, 0] = t  # a full row
    k = np.where(counts > 0, np.maximum(1, counts // 2), 0).astype(np.int32)
    bits = rng.randint(0, 2**32, size=(B, C, t), dtype=np.uint64).astype(np.uint32)
    return bits, counts, k


def _port(bits, counts, k):
    return fake_select_mask(
        torch.from_numpy(bits.view(np.int32)), torch.from_numpy(counts),
        torch.from_numpy(k),
    ).numpy()


@pytest.mark.parametrize("t", [24, 48, 354])
def test_select_bit_identical_to_sort_oracle(rng, t):
    bits, counts, k = _draw(rng, t)
    want = np.asarray(ps._select_xla(
        jnp.asarray(bits).reshape(B * C, t), jnp.asarray(counts).reshape(B * C, 1),
        jnp.asarray(k).reshape(B * C, 1),
    )).reshape(B, C, t)
    got = _port(bits, counts, k)
    np.testing.assert_array_equal(got, want)  # bit-identical


@pytest.mark.parametrize("t", [24, 354])
def test_select_bit_identical_to_pallas_interpret(rng, t):
    bits, counts, k = _draw(rng, t)
    with mock.patch.object(
        ps.pl, "pallas_call", functools.partial(ps.pl.pallas_call, interpret=True)
    ):
        want = np.asarray(ps._select_pallas(
            jnp.asarray(bits).reshape(B * C, t), jnp.asarray(counts).reshape(B * C, 1),
            jnp.asarray(k).reshape(B * C, 1),
        )).reshape(B, C, t)
    np.testing.assert_array_equal(_port(bits, counts, k), want)


@pytest.mark.parametrize("rows,t", [(48, 48), (37, 37), (23, 100), (96, 16), (7, 192)])
def test_select_bit_identical_to_packed_pallas_interpret(rows, t):
    """The short-T route (T <= 192) against the JAX packed kernel in
    interpret mode, rows not a multiple of the pack factor included."""
    rng = np.random.RandomState(rows * 1000 + t)
    g = ps._pack_factor(t)
    assert g >= 2 and t <= cuda_select.PACKED_MAX_T  # packed on both sides
    nv = rng.randint(0, t + 1, size=rows).astype(np.int32)
    nv[:2] = (0, t)  # an empty row and a full row
    k = np.where(nv > 0, np.maximum(1, nv // 2), 0).astype(np.int32)
    bits = rng.randint(0, 2**32, size=(rows, t), dtype=np.uint64).astype(np.uint32)
    with mock.patch.object(
        ps.pl, "pallas_call", functools.partial(ps.pl.pallas_call, interpret=True)
    ):
        want = np.asarray(ps._select_pallas_packed(
            jnp.asarray(bits), jnp.asarray(nv)[:, None], jnp.asarray(k)[:, None], g))
    got = fake_select_mask(torch.from_numpy(bits.view(np.int32)).reshape(rows, 1, t),
                           torch.from_numpy(nv).reshape(rows, 1),
                           torch.from_numpy(k).reshape(rows, 1)).reshape(rows, t).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t,kernel", [(1, "fake_select_packed"), (48, "fake_select_packed"),
                                      (192, "fake_select_packed"), (193, "fake_select"),
                                      (354, "fake_select")])
def test_select_routes_by_t(monkeypatch, t, kernel):
    """The rows the JAX package packs (`PACKED_MAX_T`) count as the packed
    wrapper's launches, longer rows as `fake_select`'s; `use_kernel=False`
    takes neither."""
    assert cuda_select.PACKED_MAX_T == 192
    called = []
    for name in ("fake_select", "fake_select_packed"):
        wrapper = getattr(cuda_select, name)
        monkeypatch.setattr(wrapper, "plain",
                            lambda *a, _n=name: called.append(_n) or cuda_select._select_sort(*a))
    bits = torch.zeros((2, 3, t), dtype=torch.int32)
    n = torch.full((2, 3), t, dtype=torch.int32)
    fake_select_mask(bits, n, n // 2)
    fake_select_mask(bits, n, n // 2, use_kernel=False)
    assert called == [kernel]


SOURCE = Path(cuda_select.__file__).resolve().parent.parent / "csrc" / "fake_select.cu"


def _cuda_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"csrc/fake_select.cu defines no {name}"
    return int(m.group(1))


@pytest.mark.parametrize("t,slots", [(1, 1), (16, 1), (32, 1), (33, 2), (48, 2), (64, 2),
                                     (65, 3), (96, 3), (128, 4), (129, 5), (160, 5),
                                     (161, 6), (192, 6)])
def test_packed_layout_at_the_boundaries(t, slots):
    """The packed wrapper's rows (T <= 192) get a warp a row with their
    slots a lane, as B2's kernel did."""
    assert cuda_select.select_layout(t) == (1, slots, cuda_select.WARP_ROWS)


def test_packed_layout_covers_every_routed_row_length():
    """Every T that is routed to the packed wrapper gets a warp a row whose
    held slots cover the row with no idle chunk; the packed wrapper refuses
    longer rows before it touches the card."""
    for t in range(1, cuda_select.PACKED_MAX_T + 1):
        warps, slots, rows = cuda_select.select_layout(t)
        assert (warps, rows) == (1, cuda_select.WARP_ROWS)
        assert 32 * (slots - 1) < t <= 32 * slots
    n = torch.ones(2, dtype=torch.int32)
    launch = cuda_select.fake_select_packed._launch
    for t in (0, cuda_select.PACKED_MAX_T + 1):
        with pytest.raises(ValueError, match="fake_select_packed: takes 1 <= T <= 192"):
            launch(torch.zeros((2, t), dtype=torch.int32), n, n)


def test_packed_constants_are_the_sources():
    """The wrapper's constants equal the CUDA source's, and the source
    instantiates the kernel for every (warps, slots) the layout can choose."""
    assert (cuda_select.SELECT_MAX_T, cuda_select.LANE_SLOTS, cuda_select.MAX_WARPS,
            cuda_select.WARP_ROWS) == tuple(
        _cuda_constant(n) for n in ("kMaxT", "kLaneSlots", "kMaxWarps", "kWarpRows"))
    text = SOURCE.read_text()
    # launch_slots instantiates 1 .. N slots a lane for each team size
    instantiated = {}
    for warps, rows, bound in re.findall(
            r"launch_slots<(\d+), (\w+)>\(slots, std::make_integer_sequence<int, (\w+)>", text):
        n = {"kLaneSlots": cuda_select.LANE_SLOTS,
             "kTopSlots": -(-cuda_select.SELECT_MAX_T // (32 * cuda_select.MAX_WARPS))}[bound]
        instantiated[int(warps)] = (set(range(1, n + 1)),
                                    cuda_select.WARP_ROWS if rows == "kWarpRows" else int(rows))
    assert "constexpr int kTopSlots = (kMaxT + 32 * kMaxWarps - 1) / (32 * kMaxWarps);" in text
    for t in range(1, cuda_select.SELECT_MAX_T + 1):
        warps, slots, rows = cuda_select.select_layout(t)
        assert slots in instantiated[warps][0] and rows == instantiated[warps][1], t


@pytest.mark.parametrize("t,want", [
    (1, (1, 1, 8)), (32, (1, 1, 8)), (33, (1, 2, 8)), (192, (1, 6, 8)), (193, (2, 4, 1)),
    (256, (2, 4, 1)), (257, (2, 5, 1)), (352, (2, 6, 1)), (353, (2, 6, 1)),
    (354, (2, 6, 1)), (384, (2, 6, 1)), (385, (4, 4, 1)), (512, (4, 4, 1)), (513, (4, 5, 1)),
    (768, (4, 6, 1)), (769, (4, 7, 1)), (1023, (4, 8, 1)), (1024, (4, 8, 1))])
def test_select_layout_at_the_boundaries(t, want):
    assert cuda_select.select_layout(t) == want


def test_select_layout_covers_every_row_length():
    """Every 1 <= T <= 1024 gets a layout whose held slots cover the row
    with no idle chunk: the fewest of 1, 2 or 4 warps that keep a lane to
    6 slots, a warp a row taking several rows a block and a team one."""
    for t in range(1, cuda_select.SELECT_MAX_T + 1):
        warps, slots, rows = cuda_select.select_layout(t)
        assert 32 * warps * (slots - 1) < t <= 32 * warps * slots
        assert warps in (1, 2, 4) and rows == (cuda_select.WARP_ROWS if warps == 1 else 1)
        assert slots <= cuda_select.LANE_SLOTS or warps == cuda_select.MAX_WARPS
        if warps > 1:  # half the warps would take more slots a lane
            assert t > 32 * (warps // 2) * cuda_select.LANE_SLOTS


@pytest.mark.parametrize("t", [0, 1025])
def test_select_layout_refuses_rows_it_cannot_hold(t):
    """An empty row is the only one refused. A row of 1025 slots, one past
    what a lane holds in registers, gets the block of 8 warps that walks
    it, and the launch goes on to the device check (no sort, no raise on
    the length)."""
    n = torch.ones(2, dtype=torch.int32)
    launch = cuda_select.fake_select._launch
    if t == 0:
        with pytest.raises(ValueError, match="T >= 1"):
            cuda_select.select_layout(t)
        with pytest.raises(ValueError, match="fake_select: takes T >= 1"):
            launch(torch.zeros((2, t), dtype=torch.int32), n, n)
        return
    assert cuda_select.select_layout(t) == (cuda_select.LOOP_WARPS, 5, 1)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        launch(torch.zeros((2, t), dtype=torch.int32), n, n)


@pytest.mark.parametrize("t", [1025, 1280, 1281, 1536, 2048, 4096, 10_000])
def test_select_loop_layout_above_1024(t):
    """Above SELECT_MAX_T a block of LOOP_WARPS warps owns the row and each
    warp walks ceil(T / 256) chunks of 32 slots; the walks cover the row
    with no idle warp."""
    warps, slots, rows = cuda_select.select_layout(t)
    assert (warps, rows) == (cuda_select.LOOP_WARPS, 1) == (8, 1)
    assert 32 * warps * (slots - 1) < t <= 32 * warps * slots
    assert cuda_select.LOOP_WARPS == _cuda_constant("kLoopWarps")


def test_select_bit_identical_to_jax_at_t_2048(rng):
    """Rows longer than the register layouts (T=2048): the port's
    `fake_select_mask` equals the JAX `fake_select_mask` bit for bit."""
    t = 2048
    bits, counts, k = _draw(rng, t)
    want = np.asarray(ps.fake_select_mask(jnp.asarray(bits), jnp.asarray(counts),
                                          jnp.asarray(k)))
    got = _port(bits, counts, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(axis=2), k)


@pytest.mark.parametrize("t", [24, 48, 354])
def test_select_exactly_k_within_prefix(rng, t):
    bits, counts, k = _draw(rng, t)
    sel = _port(bits, counts, k)
    np.testing.assert_array_equal(sel.sum(axis=2), k)
    assert (sel <= (np.arange(t) < counts[..., None])).all()


def test_make_fake_ob_matches_jax_draws(rng):
    """Given the draws JAX's `make_fake_ob` takes from its key, the port's
    fake batch equals JAX's: the same slots replaced (exact) by the same
    scaled noise (1e-6: `noise*scale - scale/2` may fuse differently)."""
    t = 48
    mask = np.zeros((B, C, t), np.float32)
    for i in range(B):
        for j in range(C):
            mask[i, j, : rng.randint(1, t + 1)] = 1.0
    ob = (rng.rand(B, C, t).astype(np.float32) * 5 - 2.5) * mask
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_make_fake_ob(jnp.asarray(ob), jnp.asarray(mask), key, 5.0))
    k_sel, k_noise = jax.random.split(key)
    bits = np.array(jax.random.bits(k_sel, (B, C, t), dtype=jnp.uint32))
    noise = np.array(jax.random.uniform(k_noise, (B, C, t)))
    got = make_fake_ob(
        torch.from_numpy(ob), torch.from_numpy(mask), 5.0,
        bits=torch.from_numpy(bits.view(np.int32)), noise=torch.from_numpy(noise),
    ).numpy()
    np.testing.assert_array_equal(got != ob, want != ob)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_make_fake_ob_draws_from_generator(rng):
    """Without given draws, the port draws from its generator: the same seed
    gives the same fakes, exactly max(1, n//2) slots per channel change."""
    t = 24
    mask = np.zeros((B, C, t), np.float32)
    n = rng.randint(1, t + 1, size=(B, C))
    for i in range(B):
        for j in range(C):
            mask[i, j, : n[i, j]] = 1.0
    ob = torch.from_numpy(rng.rand(B, C, t).astype(np.float32) * mask + 10.0)
    m = torch.from_numpy(mask)
    a = make_fake_ob(ob, m, 5.0, generator=torch.Generator().manual_seed(1))
    b = make_fake_ob(ob, m, 5.0, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    changed = (a != ob).sum(dim=2).numpy()
    np.testing.assert_array_equal(changed, np.maximum(1, n // 2))
