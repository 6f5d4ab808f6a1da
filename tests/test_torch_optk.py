"""The port's K selection (`cluster/optk.py`, `cluster/kneedle.py`) vs the
JAX package's, on the CPU.

The packages draw k-means differently (torch generators, JAX keys), so the
sweeps are held with the same fits: `kmeans_fit` is replaced in both
packages' `optk` by the packages' bit-identical `kmeans_fit_sklearn` with a
`random_state` from a call counter. Both loops fit in the same order, so
the fits agree, and then every row of the gap table (both inertias, with
and without `gap_subsample`) and of the elbow must match: the logs within
1e-5 absolute, the metrics and distortions within 1e-5 relative, the
Tibshirani choice, its argmax fallback and the elbow exactly. The
fingerprint sidecar is JAX's byte for byte, so a table either package
wrote reloads in the other; a second call fits nothing, and changed
latents or config recompute. Kneedle and the Tibshirani rule are held
exactly on their own. OPTICS equals JAX's where scikit-learn is installed
and raises an ImportError naming it where it is not.

The blobs lie on a grid of 1/4, where every squared distance is exact in
float32 in both packages (see `tests/test_torch_dbscan.py`); the uniform
reference cohorts do not, and their logs carry the packages' rounding.
"""

import os
import sys

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu import Config as JConfig
from deep_interpolation_clustering_tpu.cluster.kneedle import kneedle as jkneedle
from deep_interpolation_clustering_tpu.cluster import optk as joptk
from deep_interpolation_clustering_tpu.cluster.sklearn_compat import (
    kmeans_fit_sklearn as jkmeans_fit_sklearn,
)
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.cluster import optk
from deep_interpolation_clustering_tpu_torch.cluster.kneedle import kneedle
from deep_interpolation_clustering_tpu_torch.cluster.sklearn_compat import kmeans_fit_sklearn

torch.set_num_threads(1)

NAMES = ("Sihouette", "Davies-Bouldin_Index", "Calinski-Harabasz", "Dunn_Index")
LOGS = ("gap", "ref", "act", "ref_s")
SWEEP = dict(k_max=6, n_init=2, gap_b=3, internal_metrics=NAMES)


def _blobs(seed=0, n=160, d=8, k=4):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d) * 2.0
    labels = rng.randint(0, k, n)
    x = centers[labels] + rng.randn(n, d) * 0.6
    return (np.round(x * 4) / 4).astype(np.float32)


@pytest.fixture
def same_fits(monkeypatch):
    """Both packages' `optk.kmeans_fit` -> their sklearn mirror, seeded by
    call count; returns the counts."""
    calls = {"port": 0, "jax": 0}

    def port_fit(generator, x, k, n_init=10, sharded=False):
        assert not sharded  # one process: the whole latents
        assert isinstance(generator, torch.Generator) and isinstance(x, torch.Tensor)
        calls["port"] += 1
        return kmeans_fit_sklearn(x.cpu().numpy(), k, n_init=n_init, random_state=calls["port"])

    def jax_fit(key, x, k, n_init=10):
        calls["jax"] += 1
        return jkmeans_fit_sklearn(np.asarray(x), k, n_init=n_init, random_state=calls["jax"])

    monkeypatch.setattr(optk, "kmeans_fit", port_fit)
    monkeypatch.setattr(joptk, "kmeans_fit", jax_fit)
    return calls


def _same_rows(got, want, names=NAMES):
    assert [r["k"] for r in got] == [r["k"] for r in want]
    for r, w in zip(got, want):
        assert list(r) == list(w)
        for key in LOGS:
            assert abs(r[key] - w[key]) <= 1e-5, (r["k"], key, r[key], w[key])
        for key in names:
            assert r[key] == pytest.approx(w[key], rel=1e-5), (r["k"], key)


@pytest.mark.parametrize("subsample", [0, 100])
@pytest.mark.parametrize("version", [1, 2])
def test_gap_statistic_matches_jax_with_the_same_fits(tmp_path, same_fits, version,
                                                      subsample):
    x = _blobs()
    cfg = dict(SWEEP, gap_subsample=subsample)
    got = optk.KSelection(Config(**cfg), str(tmp_path / "port"), device="cpu").gap_statistic(
        x, version=version, seed=3, plot=False)
    want = joptk.KSelection(JConfig(**cfg), str(tmp_path / "jax")).gap_statistic(
        x, version=version, seed=3, plot=False)
    assert same_fits["port"] == same_fits["jax"] == 5 * (SWEEP["gap_b"] + 1)
    _same_rows(got["rows"], want["rows"])
    assert (got["opt_k"], got["opt_k_argmax"]) == (want["opt_k"], want["opt_k_argmax"])
    assert os.path.basename(got["csv"]) == f"gap_sts_v{version}.csv"
    with open(got["csv"] + ".fp") as f, open(want["csv"] + ".fp") as g:
        assert f.read() == g.read()
    _same_rows(optk._read_gap_csv(got["csv"]), joptk._read_gap_csv(want["csv"]))


def test_elbow_matches_jax_with_the_same_fits(tmp_path, same_fits):
    x, v = _blobs(1), _blobs(2, n=60)
    got = optk.KSelection(Config(**SWEEP), str(tmp_path / "port"), device="cpu").elbow(
        x, v, seed=3, plot=False)
    want = joptk.KSelection(JConfig(**SWEEP), str(tmp_path / "jax")).elbow(x, v, seed=3,
                                                                          plot=False)
    assert same_fits["port"] == same_fits["jax"] == 5
    assert got["k"] == want["k"] == [2, 3, 4, 5, 6]
    np.testing.assert_allclose(got["train"], want["train"], rtol=1e-5)
    np.testing.assert_allclose(got["valid"], want["valid"], rtol=1e-5)
    assert got["elbow_k"] == want["elbow_k"] == 4  # the planted K
    with open(tmp_path / "port" / "plot" / "elbow.csv") as f:
        assert f.readline().strip() == "k,train_distortion,valid_distortion"
        assert len(f.readlines()) == 5


def test_gap_table_reload_is_fingerprinted(tmp_path, same_fits):
    """A second call fits nothing; changed latents or config recompute; a
    table the JAX package wrote for the same latents reloads."""
    x = _blobs()
    cfg = Config(**SWEEP)
    sel = optk.KSelection(cfg, str(tmp_path), device="cpu")
    first = sel.gap_statistic(x, seed=3, plot=False)
    n_fits = same_fits["port"]
    again = sel.gap_statistic(x, seed=3, plot=False)
    assert same_fits["port"] == n_fits  # reloaded, no fit
    assert again["rows"] == optk._read_gap_csv(first["csv"])
    assert (again["opt_k"], again["opt_k_argmax"]) == (first["opt_k"], first["opt_k_argmax"])
    sel.gap_statistic(x + 0.25, seed=3, plot=False)  # other latents
    assert same_fits["port"] == 2 * n_fits
    optk.KSelection(cfg.replace(gap_b=2), str(tmp_path), device="cpu").gap_statistic(
        x + 0.25, seed=3, plot=False)  # other config
    assert same_fits["port"] == 2 * n_fits + 5 * 3
    optk.KSelection(cfg.replace(gap_b=2, overwrite=True), str(tmp_path),
                    device="cpu").gap_statistic(x + 0.25, seed=3, plot=False)
    assert same_fits["port"] == 2 * n_fits + 2 * 5 * 3  # overwrite recomputes
    # a header-only table recomputes
    with open(first["csv"], "w") as f:
        f.write("k,gap\n")
    optk.KSelection(cfg.replace(gap_b=2), str(tmp_path), device="cpu").gap_statistic(
        x + 0.25, seed=3, plot=False)
    assert same_fits["port"] == 2 * n_fits + 3 * 5 * 3
    # the JAX package's table for the same latents and sweep: no fit
    jsel = joptk.KSelection(JConfig(**SWEEP), str(tmp_path / "jax"))
    jgap = jsel.gap_statistic(x, seed=3, plot=False)
    before = same_fits["port"]
    reloaded = optk.KSelection(cfg, str(tmp_path / "jax"), device="cpu").gap_statistic(
        x, seed=3, plot=False)
    assert same_fits["port"] == before
    assert reloaded["rows"] == joptk._read_gap_csv(jgap["csv"])


def test_tensor_input_keeps_the_act_column_and_reloads(tmp_path, same_fits):
    """A tensor stays on its device and its reference cohorts are drawn
    there: other `ref` draws, the same `act` fits; its fingerprint (device
    moments) guards the reload too."""
    x = _blobs()
    sel = optk.KSelection(Config(**SWEEP), str(tmp_path / "host"), device="cpu")
    host = sel.gap_statistic(x, seed=3, plot=False)
    same_fits["port"] = 0
    dev = optk.KSelection(Config(**SWEEP), str(tmp_path / "dev"), device="cpu")
    tensor = dev.gap_statistic(torch.from_numpy(x), seed=3, plot=False)
    assert [r["act"] for r in tensor["rows"]] == [r["act"] for r in host["rows"]]
    assert [r["ref"] for r in tensor["rows"]] != [r["ref"] for r in host["rows"]]
    n_fits = same_fits["port"]
    dev.gap_statistic(torch.from_numpy(x), seed=3, plot=False)
    assert same_fits["port"] == n_fits
    dev.gap_statistic(torch.from_numpy(x) + 0.25, seed=3, plot=False)
    assert same_fits["port"] == 2 * n_fits
    sub = optk.KSelection(Config(**SWEEP, gap_subsample=100), str(tmp_path / "sub"),
                          device="cpu").gap_statistic(torch.from_numpy(x), seed=3, plot=False)
    assert [r["k"] for r in sub["rows"]] == [2, 3, 4, 5, 6]


def test_gap_and_elbow_with_the_port_kmeans(tmp_path):
    """The real device path (k-means on the tensor's device, here the CPU)
    finds the planted K, and writes the tables and figures."""
    x = _blobs(4, n=200)
    sel = optk.KSelection(Config(**SWEEP), str(tmp_path), device="cpu")
    out = sel.select_opt_k(x, x[:80], seed=3)
    assert sorted(out) == ["elbow", "gap_sts"]
    assert out["elbow"]["elbow_k"] == 4
    gap = out["gap_sts"]
    assert gap["opt_k"] == 4 and gap["opt_k_argmax"] in range(2, 7)
    for row in gap["rows"]:
        assert all(np.isfinite(row[key]) for key in (*LOGS, *NAMES))
    for name in ("gap_sts_v1.csv", "gap_sts_v1.csv.fp", "elbow.csv", "train_elbow.png",
                 "gap_statistic-1_v1.png", "gap_statistic-2_v1.png",
                 "internal_metrics_v1.png"):
        assert os.path.exists(tmp_path / "plot" / name), name


def test_fit_generators_are_disjoint_streams():
    """No (stream, k, b) shares a seed with another, including the k = 17 k'
    + b pairs an arithmetic composition would collide on."""
    seeds = {optk._generator("cpu", 7529, stream, k, b).initial_seed()
             for stream in range(5) for k in range(2, 40) for b in range(20)}
    assert len(seeds) == 5 * 38 * 20


@pytest.mark.parametrize("curve,direction", [("convex", "decreasing"), ("convex", "increasing"),
                                             ("concave", "increasing"),
                                             ("concave", "decreasing")])
def test_kneedle_matches_jax(curve, direction):
    rng = np.random.RandomState(5)
    x = np.arange(2, 16)
    for y in (1.0 / x, np.exp(-x / 3.0) + rng.rand(len(x)) * 0.01, np.sqrt(x), x ** 2.0,
              np.ones(len(x)), -np.log(x)):
        assert kneedle(x, y, curve, direction) == jkneedle(x, y, curve, direction)
    assert kneedle(x[:2], x[:2]) is None
    with pytest.raises(ValueError):
        kneedle(x, 1.0 / x, "flat", direction)


@pytest.mark.parametrize("gaps", [[0.5, 0.9, 1.2, 1.19, 1.1], [0.1, 0.2, 0.3, 0.4, 0.5],
                                  [0.9, 0.5, 0.6, 0.7, 0.1]],
                         ids=["rule", "monotone", "first"])
def test_tibshirani_and_argmax_choice_match_jax(tmp_path, gaps):
    rows = [{"k": k, "gap": g, "ref": 2.0, "act": 2.0 - g, "ref_s": 0.02,
             "Sihouette": 0.5} for k, g in zip(range(2, 7), gaps)]
    got = optk.KSelection(Config(**SWEEP), str(tmp_path / "p"), device="cpu")._gap_summary(
        rows, ["Sihouette"], str(tmp_path / "p.csv"), plot=False)
    want = joptk.KSelection(JConfig(**SWEEP), str(tmp_path / "j"))._gap_summary(
        rows, ["Sihouette"], str(tmp_path / "j.csv"), plot=False)
    assert (got["opt_k"], got["opt_k_argmax"]) == (want["opt_k"], want["opt_k_argmax"])
    with open(tmp_path / "p.csv") as f, open(tmp_path / "j.csv") as g:
        assert f.read() == g.read()


def test_missing_matplotlib_skips_the_plots(tmp_path, monkeypatch, same_fits):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    warned = []
    monkeypatch.setattr(optk.logger, "warning", lambda msg, *a: warned.append(msg % a))
    optk.KSelection(Config(**SWEEP), str(tmp_path), device="cpu").elbow(_blobs(), _blobs(),
                                                                         seed=3)
    assert any("plotting skipped" in w and "matplotlib" in w for w in warned)
    assert os.path.exists(tmp_path / "plot" / "elbow.csv")
    assert not os.path.exists(tmp_path / "plot" / "train_elbow.png")


def test_optics_matches_jax(tmp_path):
    pytest.importorskip("sklearn")
    x = _blobs(6, n=80, d=4)
    got = optk.OpticsExplorer(Config(), str(tmp_path / "p")).run(torch.from_numpy(x),
                                                                  plot=False)
    want = joptk.OpticsExplorer(JConfig(), str(tmp_path / "j")).run(x, plot=False)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["reachability"], want["reachability"])


def test_optics_without_scikit_learn_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        optk.OpticsExplorer(Config(), str(tmp_path)).run(_blobs(), plot=False)


def test_explorers_without_device_raise_when_no_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (optk.KSelection, optk.DbscanExplorer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(Config(), str(tmp_path))
