"""The port's p2 entry point (`cli.p2.main(argv, device="cpu")`) on a tiny
port p1 run vs the JAX `cli.p2.main` on a copy of the same run.

With the same fits in both packages (`kmeans_fit` -> the sklearn mirror,
seeded by call count, as in `tests/test_torch_optk.py`) the kmeans path
writes the files JAX writes, with the same tables (logs within 1e-5
absolute, metrics within 1e-5 relative), the same fingerprint and the same
suggestions; the dbscan path gives JAX's knee and eps sweep and writes the
k-distance graph; OPTICS gives JAX's labels. Tuple-valued Config flags
take JSON. Without a card and without `device="cpu"` p2 raises.

The p1 run's latents are rounded to a grid of 1/64 in its dumps, where
every squared distance is exact in float32 in both packages; off the grid
the packages' matmul rounding of a point's distance to itself (~1e-7 |x|^2
before the square root) moves a small table's logs by ~1e-5. The uniform
reference cohorts lie on no grid; the cohort has enough rows (160
encounters) that their rounding stays within the tolerance.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.cli import p2 as jp2
from deep_interpolation_clustering_tpu.cluster import optk as joptk
from deep_interpolation_clustering_tpu.cluster.sklearn_compat import (
    kmeans_fit_sklearn as jkmeans_fit_sklearn,
)
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.cli import p1, p2
from deep_interpolation_clustering_tpu_torch.cli.common import save_processed
from deep_interpolation_clustering_tpu_torch.cluster import optk
from deep_interpolation_clustering_tpu_torch.cluster.sklearn_compat import kmeans_fit_sklearn
from deep_interpolation_clustering_tpu_torch.data import make_synthetic_cohorts, process_splits

torch.set_num_threads(1)

T = 16
SWEEP = ["--k_max", "4", "--n_init", "2", "--gap_b", "2"]


@pytest.fixture(scope="module")
def p1_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("p2")
    base, results = str(root / "Data"), str(root / "Results")
    cohorts = process_splits(make_synthetic_cohorts(n_total=160, max_obs=T, seed=4),
                             rng=np.random.RandomState(0))
    save_processed(Config(base_path=base), cohorts)
    p1.main(["--batch_size", "8", "--num_timestamps", str(T), "--lstm_hidden", "8",
             "--head_hidden", "8", "--max_epochs", "2", "--aux_tasks",
             '{"future_vital": 0.5}', "--base_path", base, "--results_path", results],
            device="cpu")
    for metric in ("ae_mse", "loss"):
        for cohort in ("training", "validation", "testing"):
            path = os.path.join(results, "Pretrain", "out_feat", metric, f"{cohort}.npy")
            d = np.load(path, allow_pickle=True).item()
            d["hidden"] = (np.round(d["hidden"] * 64) / 64).astype(np.float32)
            np.save(path, d)
    return results


def _copy(results, tmp_path, name):
    dst = tmp_path / name
    shutil.copytree(os.path.join(results, "Pretrain", "out_feat"),
                    dst / "Pretrain" / "out_feat")
    return str(dst)


@pytest.fixture
def same_fits(monkeypatch):
    calls = {"port": 0, "jax": 0}

    def port_fit(generator, x, k, n_init=10, sharded=False):
        assert not sharded  # one process: the whole latents
        calls["port"] += 1
        return kmeans_fit_sklearn(x.cpu().numpy(), k, n_init=n_init, random_state=calls["port"])

    def jax_fit(key, x, k, n_init=10):
        calls["jax"] += 1
        return jkmeans_fit_sklearn(np.asarray(x), k, n_init=n_init, random_state=calls["jax"])

    monkeypatch.setattr(optk, "kmeans_fit", port_fit)
    monkeypatch.setattr(joptk, "kmeans_fit", jax_fit)
    return calls


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_p2_kmeans_writes_what_jax_writes(p1_run, tmp_path, same_fits):
    port, jax = _copy(p1_run, tmp_path, "port"), _copy(p1_run, tmp_path, "jax")
    out = p2.main(SWEEP + ["--results_path", port], device="cpu")
    jp2.main(SWEEP + ["--results_path", jax])
    assert same_fits["port"] == same_fits["jax"] == 2 * (3 * 3 + 3)  # 2 metrics
    assert sorted(out) == ["ae_mse", "loss"]
    opt_k = os.path.join("Pretrain", "opt_k")
    assert _tree(os.path.join(port, opt_k)) == _tree(os.path.join(jax, opt_k))
    for metric in ("ae_mse", "loss"):
        plot = os.path.join(opt_k, metric, "plot")
        assert {"gap_sts_v1.csv", "gap_sts_v1.csv.fp", "elbow.csv", "train_elbow.png",
                "gap_statistic-1_v1.png"} <= set(os.listdir(os.path.join(port, plot)))
        rows = optk._read_gap_csv(os.path.join(port, plot, "gap_sts_v1.csv"))
        jrows = joptk._read_gap_csv(os.path.join(jax, plot, "gap_sts_v1.csv"))
        assert [r["k"] for r in rows] == [2, 3, 4] and list(rows[0]) == list(jrows[0])
        for r, w in zip(rows, jrows):
            for key in ("gap", "ref", "act", "ref_s"):
                assert abs(r[key] - w[key]) <= 1e-5, (metric, r["k"], key)
            for key in Config().internal_metrics:
                assert r[key] == pytest.approx(w[key], rel=1e-5), (metric, r["k"], key)
        for name in ("gap_sts_v1.csv.fp",):
            with open(os.path.join(port, plot, name)) as f, \
                    open(os.path.join(jax, plot, name)) as g:
                assert f.read() == g.read()
        got = np.loadtxt(os.path.join(port, plot, "elbow.csv"), delimiter=",", skiprows=1)
        want = np.loadtxt(os.path.join(jax, plot, "elbow.csv"), delimiter=",", skiprows=1)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        gap = out[metric]["gap_sts"]
        assert gap["opt_k_argmax"] in (2, 3, 4) and gap["opt_k"] in (None, 2, 3)
    # the JSON-valued tuple flag: only the gap, reloaded from its table
    before = same_fits["port"]
    again = p2.main(SWEEP + ["--results_path", port, "--select_opt_k", '["gap_sts"]',
                             "--restore_metrics", "loss"], device="cpu")
    assert list(again["loss"]) == ["gap_sts"] and same_fits["port"] == before
    assert again["loss"]["gap_sts"]["rows"] == optk._read_gap_csv(
        os.path.join(port, opt_k, "loss", "plot", "gap_sts_v1.csv"))


def test_p2_dbscan_matches_jax(p1_run, tmp_path, monkeypatch):
    port, jax = _copy(p1_run, tmp_path, "port"), _copy(p1_run, tmp_path, "jax")
    seen = {}
    k_distance = joptk.DbscanExplorer.k_distance_graph
    sweep = joptk.DbscanExplorer.eps_sweep
    monkeypatch.setattr(joptk.DbscanExplorer, "k_distance_graph",
                        lambda self, f, **kw: seen.setdefault("kd", []).append(
                            k_distance(self, f, **kw)) or seen["kd"][-1])
    monkeypatch.setattr(joptk.DbscanExplorer, "eps_sweep",
                        lambda self, f, **kw: seen.setdefault("sweep", []).append(
                            sweep(self, f, **kw)) or seen["sweep"][-1])
    out = p2.main(["--cluster_algo", "dbscan", "--results_path", port], device="cpu")
    jp2.main(["--cluster_algo", "dbscan", "--results_path", jax])
    for i, metric in enumerate(("ae_mse", "loss")):
        kd, jkd = out[metric]["k_distance"], seen["kd"][i]
        np.testing.assert_allclose(kd["kth_distances"], jkd["kth_distances"], rtol=1e-5)
        assert kd["knee_eps"] == pytest.approx(jkd["knee_eps"], rel=1e-5)
        rows, jrows = out[metric]["eps_sweep"], seen["sweep"][i]
        assert [r["eps"] for r in rows] == [r["eps"] for r in jrows] == list(
            np.arange(0.5, 5.0, 0.5))
        for r, w in zip(rows, jrows):
            assert (r["n_clusters"], r["n_noise"]) == (w["n_clusters"], w["n_noise"])
        plot = os.path.join("Pretrain", "opt_k", metric, "plot")
        assert os.listdir(os.path.join(port, plot)) == os.listdir(os.path.join(jax, plot)) \
            == ["k_distance_graph.png"]


def test_p2_optics_matches_jax(p1_run, tmp_path, monkeypatch):
    pytest.importorskip("sklearn")
    port, jax = _copy(p1_run, tmp_path, "port"), _copy(p1_run, tmp_path, "jax")
    seen = []
    run = joptk.OpticsExplorer.run
    monkeypatch.setattr(joptk.OpticsExplorer, "run",
                        lambda self, f, **kw: seen.append(run(self, f, **kw)) or seen[-1])
    out = p2.main(["--cluster_algo", "optics", "--restore_metrics", "ae_mse",
                   "--results_path", port], device="cpu")
    jp2.main(["--cluster_algo", "optics", "--restore_metrics", "ae_mse",
              "--results_path", jax])
    np.testing.assert_array_equal(out["ae_mse"]["labels"], seen[0]["labels"])
    np.testing.assert_allclose(out["ae_mse"]["reachability"], seen[0]["reachability"],
                               rtol=1e-5)


def test_p2_without_device_raises_when_no_card(p1_run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p2.main(SWEEP + ["--results_path", p1_run])


def test_p2_data_parallel_two_is_one_process(p1_run, tmp_path, capfd):
    """`--data_parallel 2`: two gloo CPU ranks, each keeping its block of
    the latents' rows, with the device k-means on both sides (no injected
    fits), against one process on the grid latents: `elbow.csv` and
    `gap_sts_v1.csv` the same text, the suggestions the same."""
    one, two = _copy(p1_run, tmp_path, "one"), _copy(p1_run, tmp_path, "two")
    argv = SWEEP + ["--restore_metrics", "ae_mse"]
    want = p2.main(argv + ["--results_path", one], device="cpu")
    capfd.readouterr()
    got = p2.main(argv + ["--results_path", two, "--data_parallel", "2"], device="cpu")
    logs = capfd.readouterr().err
    n_train = len(np.load(os.path.join(one, "Pretrain", "out_feat", "ae_mse", "training.npy"),
                          allow_pickle=True).item()["hidden"])
    # each rank row-shards the training latents twice (elbow, gap)
    assert logs.count(f"{n_train} rows row-sharded over 2 ranks: {n_train // 2} a rank") == 4
    plot = os.path.join("Pretrain", "opt_k", "ae_mse", "plot")
    assert _tree(os.path.join(one, plot)) == _tree(os.path.join(two, plot))
    for name in ("elbow.csv", "gap_sts_v1.csv", "gap_sts_v1.csv.fp"):
        with open(os.path.join(one, plot, name)) as f, open(os.path.join(two, plot, name)) as g:
            assert f.read() == g.read(), name
    for method in ("elbow", "gap_sts"):
        for key in ("elbow_k", "opt_k", "opt_k_argmax"):
            assert got["ae_mse"][method].get(key) == want["ae_mse"][method].get(key)
