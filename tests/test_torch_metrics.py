"""The port's internal metrics and gap inertias (`cluster/metrics.py`) vs the
JAX package's, on the CPU.

Seeded blobs (300 rows, D=12, K=4) go through both packages' blocked
sweeps with a block that does not divide N (64) and one larger than N:
`pairwise_cluster_stats` (sums within 1e-5 of their largest, counts equal,
per-pair min and max within 1e-5 relative, an empty cluster's +inf/-inf
identities included), every internal metric and both inertias within 1e-5
relative, and `kth_neighbor_distance` within 1e-5 relative, with JAX's
ValueError for k outside 1..n-1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.cluster import metrics as jm
from deep_interpolation_clustering_tpu_torch.cluster import metrics as pm

torch.set_num_threads(1)

N, D, K = 300, 12, 4
RTOL = 1e-5


def _blobs(seed=0, n=N, d=D, k=K):
    """Latent-like blobs: centres near the origin, so the matmul identity's
    rounding (relative to |x|^2) stays well under the tolerance."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 2.0
    labels = rng.randint(0, k, n)
    labels[:k] = np.arange(k)
    x = (centers[labels] + rng.randn(n, d) * 0.6).astype(np.float32)
    return x, labels


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("block", [64, 1024])
@pytest.mark.parametrize("case", ["full", "empty_cluster"])
def test_pairwise_cluster_stats_match_jax(block, case):
    x, labels = _blobs(1)
    k = K
    if case == "empty_cluster":
        labels = labels % (K - 1)  # cluster K-1 has no member
    got = pm.pairwise_cluster_stats(x, labels, k, block)
    want = jm.pairwise_cluster_stats(jnp.asarray(x), jnp.asarray(labels), k, block)
    sums_w = np.asarray(want.sums)
    np.testing.assert_allclose(got.sums.numpy(), sums_w, rtol=0, atol=RTOL * sums_w.max())
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    for name in ("pair_min", "pair_max"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=name)
        np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)], err_msg=name)
        np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], rtol=RTOL,
                                   err_msg=name)
    if case == "empty_cluster":
        assert (got.pair_min[K - 1] == float("inf")).all()
        assert (got.pair_max[:, K - 1] == float("-inf")).all()
    # without the extrema the sums and counts are the same, and no min/max
    lean = pm.pairwise_cluster_stats(x, labels, k, block, extrema=False)
    assert lean.pair_min is None and lean.pair_max is None
    torch.testing.assert_close(lean.sums, got.sums, rtol=0, atol=0)


@pytest.mark.parametrize("block", [64, 1024])
@pytest.mark.parametrize("name", ["Sihouette", "Davies-Bouldin_Index", "Calinski-Harabasz",
                                  "Dunn_Index", "inertia_v1", "inertia_v2"])
def test_metrics_match_jax(name, block):
    x, labels = _blobs(2)
    if name in pm.INTERNAL_METRICS:
        fn, jfn = pm.INTERNAL_METRICS[name], jm.INTERNAL_METRICS[name]
    else:
        fn, jfn = getattr(pm, name), getattr(jm, name)
    kw = {"block": block} if name not in ("Davies-Bouldin_Index", "Calinski-Harabasz") else {}
    got = fn(torch.from_numpy(x), torch.from_numpy(labels), K, **kw)
    want = jfn(jnp.asarray(x), jnp.asarray(labels), K, **kw)
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    assert _rel(got, want) <= RTOL, (float(got), float(want))


def test_compute_internal_metrics_matches_jax():
    x, labels = _blobs(3)
    names = list(pm.INTERNAL_METRICS)
    got = pm.compute_internal_metrics(names, x, labels, K)
    want = jm.compute_internal_metrics(names, x, labels, K)
    assert list(got) == list(want) == names
    for name in names:
        assert isinstance(got[name], float)
        assert _rel(got[name], want[name]) <= RTOL, name


def test_singleton_cluster_scores_zero_like_jax():
    """A singleton's silhouette is 0 and the Dunn diameter ignores it."""
    x, labels = _blobs(4, n=40)
    labels = labels % 3
    labels[7] = 3  # the only member of cluster 3
    for name in ("Sihouette", "Dunn_Index"):
        got = pm.INTERNAL_METRICS[name](x, labels, K, block=16)
        want = jm.INTERNAL_METRICS[name](jnp.asarray(x), jnp.asarray(labels), K, block=16)
        assert _rel(got, want) <= RTOL, name


@pytest.mark.parametrize("k", [1, 7, N - 1])
def test_kth_neighbor_distance_matches_jax(k):
    x, _ = _blobs(5)
    got = pm.kth_neighbor_distance(x, k, block=64).numpy()
    want = np.asarray(jm.kth_neighbor_distance(jnp.asarray(x), k, block=64))
    assert got.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # self excluded: the first neighbour of a point is another point
    if k == 1:
        assert (got > 0).all()


@pytest.mark.parametrize("k", [0, N])
def test_kth_neighbor_distance_rejects_k_out_of_range(k):
    x, _ = _blobs(5)
    with pytest.raises(ValueError, match="valid range: 1..299") as port_err:
        pm.kth_neighbor_distance(x, k)
    with pytest.raises(ValueError) as jax_err:
        jm.kth_neighbor_distance(jnp.asarray(x), k)
    assert str(port_err.value) == str(jax_err.value)
