"""The port's DBSCAN (`cluster/dbscan.py`), `dbscan_quality` and
`DbscanExplorer` vs the JAX package's, on the CPU.

Labels and core masks must be identical (not close): seeded blobs with
borders and far-out noise in a shuffled order, with blocks that do not
divide N, three (eps, min_samples) regimes; a long chain that needs many
propagation rounds; all noise; one cluster. `fit_dbscan_impl` dispatches
"device" and "sklearn" to the same labels (scikit-learn installed) and
raises an ImportError naming scikit-learn without it. The explorer's
k-distance graph (1e-5 relative, the same knee) and eps sweep (counts
identical, silhouettes 1e-5 relative) equal JAX's.

The explorer and quality tests put the latents on a grid of 1/4: every
squared distance is then exact in float32 in both packages, whatever the
order of the matmul's sums. Off the grid, the matmul identity's rounding of
|x|^2 + |y|^2 - 2 x.y differs between the packages by ~1e-7 |x|^2, which
near a distance of 0 (a point to itself, counted in every silhouette sum)
is far more than 1e-5 of the distance.
"""

import sys
import types

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu import Config as JConfig
from deep_interpolation_clustering_tpu.cluster import dbscan as jdb
from deep_interpolation_clustering_tpu.cluster import optk as joptk
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.cluster import dbscan as db
from deep_interpolation_clustering_tpu_torch.cluster import optk

torch.set_num_threads(1)


def _blobs(seed, n_per=60, k=3, d=5, spread=0.3):
    rng = np.random.RandomState(seed)
    parts = [(rng.randn(n_per, d) * spread + 4.0 * i).astype(np.float32) for i in range(k)]
    parts.append((rng.rand(7, d) * 40 - 20).astype(np.float32))  # far-out noise
    x = np.concatenate(parts)
    rng.shuffle(x)  # an arbitrary scan order
    return x


def _grid(x):
    return (np.round(x * 4) / 4).astype(np.float32)


def _same(x, eps, min_samples, block):
    labels, core = db.dbscan_fit(torch.from_numpy(x), eps, min_samples, block=block)
    want_l, want_c = jdb.dbscan_fit(x, eps, min_samples, block=block)
    assert labels.dtype == want_l.dtype == np.int64 and core.dtype == want_c.dtype
    np.testing.assert_array_equal(core, want_c)
    np.testing.assert_array_equal(labels, want_l)
    return labels, core


@pytest.mark.parametrize("eps,min_samples", [(1.0, 6), (0.6, 8), (0.5, 5)])
def test_dbscan_matches_jax_on_blobs(eps, min_samples):
    x = _blobs(0)
    labels, core = _same(x, eps, min_samples, block=64)  # 187 rows: ragged blocks
    assert labels.max() == 2 and (labels == -1).any()
    assert (~core & (labels >= 0)).any()  # border points


def test_dbscan_chained_component_matches_jax():
    """A long chain: many rounds of propagation and pointer jumping."""
    rng = np.random.RandomState(1)
    t = np.linspace(0, 20, 300).astype(np.float32)
    x = np.stack([t, np.sin(t).astype(np.float32)], axis=1)
    x += rng.randn(*x.shape).astype(np.float32) * 0.01
    labels, core = _same(x, 0.25, 3, block=32)
    assert (labels == 0).all() and core.all()


def test_dbscan_all_noise_and_one_cluster_match_jax():
    rng = np.random.RandomState(2)
    x = (rng.rand(50, 4) * 100).astype(np.float32)
    labels, core = _same(x, 0.01, 3, block=1024)
    assert (labels == -1).all() and not core.any()
    x2 = rng.randn(50, 4).astype(np.float32) * 0.01
    labels, core = _same(x2, 1.0, 3, block=16)
    assert (labels == 0).all() and core.all()


def test_fit_dbscan_impl_device_and_sklearn_agree():
    pytest.importorskip("sklearn")
    x = _blobs(3, n_per=30, k=2)
    dev = db.fit_dbscan_impl(Config(dbscan_impl="device"), torch.from_numpy(x), 1.0, 5)
    skl = db.fit_dbscan_impl(Config(dbscan_impl="sklearn"), torch.from_numpy(x), 1.0, 5)
    want = jdb.fit_dbscan_impl(JConfig(dbscan_impl="sklearn"), x, 1.0, 5)
    for got in (dev, skl):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError, match="dbscan_impl"):
        db.fit_dbscan_impl(types.SimpleNamespace(dbscan_impl="bogus"), x, 1.0, 5)


def test_sklearn_path_without_scikit_learn_raises(monkeypatch):
    """No quiet switch to the device fit where scikit-learn is missing."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        db.fit_dbscan_impl(Config(dbscan_impl="sklearn"), _blobs(3), 1.0, 5)


@pytest.mark.parametrize("labels", [[0, 0, 1, 1, -1, 2, 2, 2, -1, 1],
                                    [0, 0, -1, 0, 0, 0, -1, 0, 0, 0],
                                    [3, 3, 5, 5, 5, 3, 5, 3, 5, 5]],
                         ids=["noise", "one_cluster", "sparse_ids"])
def test_dbscan_quality_matches_jax(labels):
    rng = np.random.RandomState(4)
    labels = np.asarray(labels)
    feat = _grid(rng.randn(len(labels), 6) + labels[:, None])
    got = optk.dbscan_quality(torch.from_numpy(feat), labels)
    want = joptk.dbscan_quality(feat, labels)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-5), key


@pytest.mark.parametrize("n_rows", [187, 5], ids=["cohort", "clamped"])
def test_dbscan_explorer_matches_jax(tmp_path, n_rows):
    """The k-distance graph with k - 1 true neighbours (clamped when the
    cohort has fewer rows than min_samples) and the 9-value eps sweep."""
    x = _grid(_blobs(5, spread=0.6))[:n_rows]
    got = optk.DbscanExplorer(Config(), str(tmp_path / "port"), device="cpu")
    want = joptk.DbscanExplorer(JConfig(), str(tmp_path / "jax"))
    kd, jkd = got.k_distance_graph(x, plot=False), want.k_distance_graph(x, plot=False)
    np.testing.assert_allclose(kd["kth_distances"], jkd["kth_distances"], rtol=1e-5)
    if jkd["knee_eps"] is None:
        assert kd["knee_eps"] is None
    else:
        assert kd["knee_eps"] == pytest.approx(jkd["knee_eps"], rel=1e-5)
    rows, jrows = got.eps_sweep(x), want.eps_sweep(x)
    assert len(rows) == len(jrows) == 9
    for r, jr in zip(rows, jrows):
        assert sorted(r) == sorted(jr)
        for key in ("eps", "n_clusters", "n_noise"):
            assert r[key] == jr[key], key
        for key in set(jr) - {"eps", "n_clusters", "n_noise"}:
            assert r[key] == pytest.approx(jr[key], rel=1e-5), key
    if n_rows > 100:
        assert any(r["n_clusters"] >= 2 for r in rows)
