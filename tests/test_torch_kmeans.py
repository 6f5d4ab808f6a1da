"""The port's k-means (`cluster/kmeans.py`) and its sklearn mirror
(`cluster/sklearn_compat.py`) vs the JAX package's, on the CPU.

The two packages' random draws differ (torch generators, JAX keys), so the
device k-means is held by parts: the distance helpers at 1e-5; `_lloyd`
from the same initial centres gives identical labels and `n_iter`, centres
at 1e-5 (an empty cluster reseeded from the farthest points included); the
port's k-means++ picks rows of the data; `kmeans_fit` on separated blobs
gives JAX's partition up to a relabelling, inertia at 1e-5 relative. The
NumPy sklearn mirror is bit for bit JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.cluster import kmeans as jkm
from deep_interpolation_clustering_tpu.cluster.sklearn_compat import (
    kmeans_fit_sklearn as jkmeans_fit_sklearn,
)
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.cluster import kmeans as km
from deep_interpolation_clustering_tpu_torch.cluster.sklearn_compat import kmeans_fit_sklearn

torch.set_num_threads(1)


def blobs(n=240, k=4, d=8, spread=0.3, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d).astype(np.float32) * 4.0
    labels = rng.randint(0, k, size=n)
    x = centers[labels] + rng.randn(n, d).astype(np.float32) * spread
    return x.astype(np.float32), labels


def _same_partition(a, b):
    """Equal up to a relabelling (a bijection between label sets)."""
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


def test_distance_helpers_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(50, 16).astype(np.float32) * 3
    c = rng.randn(5, 16).astype(np.float32)
    tx, tc, jx, jc = torch.from_numpy(x), torch.from_numpy(c), jnp.asarray(x), jnp.asarray(c)
    np.testing.assert_allclose(km.pairwise_sq_dist(tx, tc).numpy(),
                               np.asarray(jkm.pairwise_sq_dist(jx, jc)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(km.kmeans_predict(tc, tx).numpy(),
                                  np.asarray(jkm.kmeans_predict(jc, jx)))
    for fn, jfn in ((km.kmeans_inertia, jkm.kmeans_inertia),
                    (km.mean_min_distance, jkm.mean_min_distance)):
        got, want = float(fn(tc, tx)), float(jfn(jc, jx))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), fn.__name__
    # clamped at 0: a point's distance to itself
    assert float(km.pairwise_sq_dist(tx, tx).diagonal().min()) >= 0.0
    # a batch of restarts gives each restart's distances
    stacked = km.pairwise_sq_dist(tx, torch.stack([tc, tc.flip(0)]))
    torch.testing.assert_close(stacked[1], km.pairwise_sq_dist(tx, tc.flip(0)))


@pytest.mark.parametrize("case", ["blobs", "empty_cluster"])
def test_lloyd_from_the_same_centres_matches_jax(case):
    x, _ = blobs(seed=2)
    tol = 1e-4 * float(np.mean(np.var(x, axis=0)))
    if case == "blobs":
        init = x[[0, 1, 2, 3]].copy()
    else:
        # a centre far from every point gets no point on the first pass and
        # is reseeded from the farthest point
        init = np.concatenate([x[[5, 6, 7]], np.full((1, x.shape[1]), 50.0, np.float32)])
    centers, labels, inertia, n_iter = km._lloyd(torch.from_numpy(x), torch.from_numpy(init),
                                                 300, torch.tensor(tol))
    jc, jl, ji, jn = jkm._lloyd(jnp.asarray(x), jnp.asarray(init), 300, jnp.asarray(tol))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    assert int(n_iter) == int(jn) >= 2
    np.testing.assert_allclose(centers.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    assert abs(float(inertia) - float(ji)) <= 1e-5 * float(ji)
    if case == "empty_cluster":
        assert len(np.unique(labels.numpy())) == 4  # the reseeded centre won points


def test_lloyd_restarts_batched_equal_each_alone():
    """The restarts step as a batch, each held once it converged: every
    restart ends where it would alone."""
    x, _ = blobs(seed=3)
    tx = torch.from_numpy(x)
    tol = torch.tensor(1e-4 * float(np.mean(np.var(x, axis=0))))
    inits = torch.stack([tx[[0, 1, 2, 3]], tx[[10, 40, 70, 100]], tx[[4, 4, 9, 200]]])
    batched = km._lloyd(tx, inits, 300, tol)
    alone = [km._lloyd(tx, c, 300, tol) for c in inits]
    # the restarts converge after different numbers of iterations
    assert len({int(n) for *_, n in alone}) > 1
    for i, (c, l, inertia, n) in enumerate(alone):
        torch.testing.assert_close(batched[0][i], c, rtol=0, atol=1e-6)
        assert torch.equal(batched[1][i], l) and int(batched[3][i]) == int(n)
        torch.testing.assert_close(batched[2][i], inertia, rtol=1e-6, atol=0)


def test_kmeanspp_picks_data_points():
    x, _ = blobs(seed=4)
    tx = torch.from_numpy(x)
    centers = km._kmeanspp_init(torch.Generator().manual_seed(0), tx, 4, n_init=5)
    assert centers.shape == (5, 4, x.shape[1])
    for c in centers.reshape(-1, x.shape[1]):
        assert bool((tx == c).all(1).any())
    # k-means++ spreads the seeds over the four separated blobs
    _, true = blobs(seed=4)
    for restart in centers:
        rows = [int(torch.nonzero((tx == c).all(1))[0]) for c in restart]
        assert len(set(true[rows].tolist())) == 4


def test_kmeans_fit_gives_jax_partition_on_blobs():
    x, true = blobs(seed=5)
    got = km.kmeans_fit(torch.Generator().manual_seed(7), torch.from_numpy(x), 4, n_init=5)
    want = jkm.kmeans_fit(jax.random.PRNGKey(7), jnp.asarray(x), 4, n_init=5)
    assert _same_partition(got.labels.numpy(), np.asarray(want.labels))
    assert _same_partition(got.labels.numpy(), true)
    assert abs(float(got.inertia) - float(want.inertia)) <= 1e-5 * float(want.inertia)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  km.kmeans_predict(got.centers, torch.from_numpy(x)).numpy())
    # the same generator seed repeats the fit
    again = km.kmeans_fit(torch.Generator().manual_seed(7), torch.from_numpy(x), 4, n_init=5)
    assert torch.equal(again.centers, got.centers) and int(again.n_iter) == int(got.n_iter)


def test_kmeans_fit_takes_the_best_restart():
    """The best inertia of the restarts, the first one on ties."""
    x, _ = blobs(n=120, k=6, spread=1.5, seed=6)
    tx = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(3)
    got = km.kmeans_fit(gen, tx, 6, n_init=8)
    tol = 1e-4 * torch.mean(torch.var(tx, dim=0, correction=0))
    inits = km._kmeanspp_init(torch.Generator().manual_seed(3), tx, 6, 8)
    _, _, inertia, _ = km._lloyd(tx, inits, 300, tol)
    assert float(got.inertia) == float(inertia.min())
    assert float(got.inertia) == float(km.kmeans_inertia(got.centers, tx))


def test_kmeans_fit_sklearn_is_jax_bit_for_bit():
    x, _ = blobs(n=300, k=5, spread=1.0, seed=8)
    got = kmeans_fit_sklearn(x, 4, n_init=6, random_state=11)
    want = jkmeans_fit_sklearn(x, 4, n_init=6, random_state=11)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert type(got).__module__.startswith("deep_interpolation_clustering_tpu_torch")


def test_fit_kmeans_impl_dispatch():
    x, _ = blobs(seed=9)
    dev = km.fit_kmeans_impl(Config(kmeans_impl="device"), 3, torch.from_numpy(x), 4, 3)
    assert isinstance(dev.centers, torch.Tensor) and dev.centers.shape == (4, x.shape[1])
    sk = km.fit_kmeans_impl(Config(kmeans_impl="sklearn"), 3, x, 4, 3)
    want = jkmeans_fit_sklearn(x, 4, n_init=3, random_state=3)
    np.testing.assert_array_equal(sk.labels, want.labels)
    with pytest.raises(TypeError, match="tensor"):
        km.fit_kmeans_impl(Config(kmeans_impl="device"), 3, x, 4, 3)
