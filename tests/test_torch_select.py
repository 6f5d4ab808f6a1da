"""Port of the exact-k fake-sample select vs the JAX package.

The port's select (plain version on the CPU) must be BIT-IDENTICAL to the
JAX sort oracle `_select_xla` and to the Pallas kernel `_select_pallas`
(interpreter mode), given the same uint32 bits.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.data.loader import make_fake_ob as jax_make_fake_ob
from deep_interpolation_clustering_tpu.ops import pallas_select as ps
from deep_interpolation_clustering_tpu_torch.data.loader import make_fake_ob
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
