"""The port's p4 (alignment, `FinalLabeler`, `cli.p4`) and p3 entry point
(`cli.p3`) vs the JAX package, on the CPU.

  * `generate_align_map`, `align_labels` and `align_labels_with_center`
    give JAX's maps and labels.
  * `FinalLabeler` on copies of one dump directory: the kmeans path (the
    sklearn mirror), dl (pred and label) and consensus give JAX's labels
    and `{cohort}_{K}.npy` files; dbscan (on the device, here the CPU)
    gives JAX's labels and `{cohort}_eps-{opt_eps}.npy` files, and JAX's
    ValueError when a cohort is all noise.
  * `cli.p3.main(argv, device="cpu")` from a port p1 run trains DEC and
    writes a config, checkpoints and nine dumps that the JAX package
    reads; `cli.p4.main` labels them. Without a card and without
    `device="cpu"` both raise.
"""

import csv
import os
import shutil

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu import Config as JConfig
from deep_interpolation_clustering_tpu.cluster import align as jalign
from deep_interpolation_clustering_tpu.cluster.final import FinalLabeler as JFinalLabeler
from deep_interpolation_clustering_tpu.cluster.final import load_feature_dumps as jload
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.cli import p1, p3, p4
from deep_interpolation_clustering_tpu_torch.cli.common import save_processed
from deep_interpolation_clustering_tpu_torch.cluster import align
from deep_interpolation_clustering_tpu_torch.cluster.final import FinalLabeler
from deep_interpolation_clustering_tpu_torch.data import make_synthetic_cohorts, process_splits
from deep_interpolation_clustering_tpu_torch.info import COHORTS

torch.set_num_threads(1)

K = 3
SIZES = {"training": 60, "validation": 18, "testing": 15}


def _cohort(rng, n, k=K, d=12, t=10):
    """Latents in K blobs; the SBP channel's level follows the blob, so the
    SBP order of the clusters is well defined."""
    means = np.arange(k)[:, None] * 6.0 + rng.randn(k, d)
    lab = rng.randint(0, k, n)
    lab[:k] = np.arange(k)  # every blob has a member
    hidden = (means[lab] + rng.randn(n, d) * 0.3).astype(np.float32)
    pad = (rng.rand(n, 6, t) < 0.7).astype(np.float32)
    pad[:, :, 0] = 1.0
    ob = rng.rand(n, 6, t).astype(np.float32) * 10
    ob[:, 0] += (np.array([120.0, 90.0, 150.0])[lab % 3])[:, None]
    logits = rng.randn(n, k).astype(np.float32) + 3 * np.eye(k, dtype=np.float32)[lab]
    q = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    p = np.square(q) / q.sum(0)
    return {"encounter_id": np.array([f"e{i}" for i in range(n)]), "hidden": hidden,
            "ob": ob, "padding_mask": pad, "cluster_pred": q.astype(np.float32),
            "cluster_label": (p / p.sum(1, keepdims=True)).astype(np.float32),
            "rec_ob": ob.copy()}


@pytest.fixture(scope="module")
def dump_dir(tmp_path_factory):
    """A run directory with dumps for two metrics and consensus CSVs."""
    root = tmp_path_factory.mktemp("final")
    rng = np.random.RandomState(0)
    for metric in ("ae_mse", "delta"):
        d = root / "out_feat" / metric
        d.mkdir(parents=True)
        for cohort in COHORTS:
            np.save(d / f"{cohort}.npy", _cohort(rng, SIZES[cohort]))
    raw = root / "out_feat" / "raw_consensus_result"
    raw.mkdir()
    for cohort, one_based in (("training", True), ("validation", False)):
        labels = rng.randint(0, K, SIZES[cohort]) + int(one_based)
        with open(raw / f"{cohort}_consensus.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["encounter_id", f"k{K}", "k2"])
            for i, v in enumerate(labels):
                w.writerow([f"e{i}", v, v % 2])
    return root


def test_align_matches_jax():
    rng = np.random.RandomState(1)
    c = _cohort(rng, 40)
    raw = np.argmax(c["cluster_pred"], 1)
    got = align.generate_align_map(raw, c["ob"], c["padding_mask"], c["hidden"])
    want = jalign.generate_align_map(raw, c["ob"], c["padding_mask"], c["hidden"])
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, b)
    other = (raw + 1) % K
    np.testing.assert_array_equal(align.align_labels(other, got[0]),
                                  jalign.align_labels(other, want[0]))
    v = _cohort(rng, 20)
    vraw = np.argmax(v["cluster_pred"], 1)
    np.testing.assert_array_equal(align.align_labels_with_center(v["hidden"], vraw, got[2]),
                                  jalign.align_labels_with_center(v["hidden"], vraw, want[2]))
    # the aligned training clusters come in descending mean SBP
    sbp = (c["ob"][:, 0] * c["padding_mask"][:, 0]).sum(1) / c["padding_mask"][:, 0].sum(1)
    means = [sbp[got[1] == i].mean() for i in range(K)]
    assert means == sorted(means, reverse=True)


def _labelled(root, tmp_path, labeler, name, **kw):
    exp = tmp_path / name
    shutil.copytree(root, exp)
    cfg_kw = dict(num_clusters=K, kmeans_n_init=4, kmeans_impl="sklearn", seed=5, **kw)
    if labeler is FinalLabeler:
        out = labeler(Config(**cfg_kw), str(exp), device="cpu").pred(["ae_mse", "delta"], seed=5)
    else:
        out = labeler(JConfig(**cfg_kw), str(exp)).pred(["ae_mse", "delta"], seed=5)
    return exp, out


@pytest.mark.parametrize("kw", [
    dict(cluster_method="kmeans"),
    dict(cluster_method="dl"),
    dict(cluster_method="dl", dl_cluster_label_type="label"),
    dict(cluster_method="consensus"),
], ids=["kmeans", "dl_pred", "dl_label", "consensus"])
def test_final_labeler_matches_jax(dump_dir, tmp_path, kw):
    exp, got = _labelled(dump_dir, tmp_path, FinalLabeler, "port", **kw)
    jexp, want = _labelled(dump_dir, tmp_path, JFinalLabeler, "jax", **kw)
    assert sorted(got) == sorted(want) == ["ae_mse", "delta"]
    for metric in want:
        assert sorted(got[metric]) == sorted(want[metric])
        for cohort, labels in want[metric].items():
            np.testing.assert_array_equal(got[metric][cohort], labels)
            assert got[metric][cohort].dtype == labels.dtype
            assert set(np.unique(labels)) <= set(range(K))
        folder = f"{metric}_{kw['cluster_method']}_aligned"
        names = sorted(os.listdir(jexp / "out_feat" / folder))
        assert sorted(os.listdir(exp / "out_feat" / folder)) == names
        for fname in names:
            a = np.load(exp / "out_feat" / folder / fname, allow_pickle=True).item()
            b = np.load(jexp / "out_feat" / folder / fname, allow_pickle=True).item()
            assert sorted(a) == sorted(b), fname
            for k in b:
                assert a[k].dtype == b[k].dtype, (fname, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{fname} {k}")


def test_final_labeler_kmeans_on_the_device_path(dump_dir, tmp_path):
    """`kmeans_impl="device"` fits the port's k-means where the latents are
    (the CPU here): every cohort labelled, the training clusters aligned."""
    cfg = Config(cluster_method="kmeans", num_clusters=K, kmeans_n_init=4)
    exp = tmp_path / "dev2"
    shutil.copytree(dump_dir, exp)
    out = FinalLabeler(cfg, str(exp), device="cpu").pred(["ae_mse"], seed=5)["ae_mse"]
    train = np.load(exp / "out_feat" / "ae_mse" / "training.npy", allow_pickle=True).item()
    sbp = (train["ob"][:, 0] * train["padding_mask"][:, 0]).sum(1) / \
        train["padding_mask"][:, 0].sum(1)
    means = [sbp[out["training"] == i].mean() for i in range(K)]
    assert means == sorted(means, reverse=True)
    for cohort in COHORTS:
        assert len(out[cohort]) == SIZES[cohort] and set(out[cohort]) == set(range(K))


@pytest.fixture(scope="module")
def dbscan_dir(tmp_path_factory):
    """Dumps with 4-d latents: min_samples is the latent width, so the
    smallest cohort's blobs (5-6 rows each) still hold core points."""
    root = tmp_path_factory.mktemp("final_dbscan")
    rng = np.random.RandomState(3)
    for metric in ("ae_mse", "delta"):
        d = root / "out_feat" / metric
        d.mkdir(parents=True)
        for cohort in COHORTS:
            np.save(d / f"{cohort}.npy", _cohort(rng, SIZES[cohort], d=4))
    return root


def test_final_labeler_dbscan_matches_jax(dbscan_dir, tmp_path):
    exp, got = _labelled(dbscan_dir, tmp_path, FinalLabeler, "port", cluster_method="dbscan",
                         opt_eps=1.5)
    jexp, want = _labelled(dbscan_dir, tmp_path, JFinalLabeler, "jax", cluster_method="dbscan",
                           opt_eps=1.5)
    for metric in ("ae_mse", "delta"):
        for cohort in COHORTS:
            np.testing.assert_array_equal(got[metric][cohort], want[metric][cohort])
            assert got[metric][cohort].dtype == want[metric][cohort].dtype
        assert set(got[metric]["training"]) - {-1} == set(range(K))
        folder = f"{metric}_dbscan_aligned"
        names = sorted(os.listdir(jexp / "out_feat" / folder))
        assert names == [f"{c}_eps-1.5.npy" for c in sorted(COHORTS)]
        assert sorted(os.listdir(exp / "out_feat" / folder)) == names
        for fname in names:
            a = np.load(exp / "out_feat" / folder / fname, allow_pickle=True).item()
            b = np.load(jexp / "out_feat" / folder / fname, allow_pickle=True).item()
            assert sorted(a) == sorted(b), fname
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{fname} {k}")
    # every point noise: the same ValueError in both packages
    for labeler in (FinalLabeler, JFinalLabeler):
        with pytest.raises(ValueError, match="dbscan found 0 clusters on 'training'"):
            _labelled(dbscan_dir, tmp_path, labeler, f"noise_{labeler.__module__}",
                      cluster_method="dbscan", opt_eps=0.01)


# ------------------------------------------------------------ entry points
T = 16
FLAGS = ["--batch_size", "8", "--num_timestamps", str(T), "--lstm_hidden", "8",
         "--head_hidden", "8", "--aux_tasks", '{"future_vital": 0.5}']


@pytest.fixture(scope="module")
def p3_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("p3")
    base, results = str(root / "Data"), str(root / "Results")
    cohorts = process_splits(make_synthetic_cohorts(n_total=40, max_obs=T, seed=4),
                             rng=np.random.RandomState(0))
    save_processed(Config(base_path=base), cohorts)
    paths = ["--base_path", base, "--results_path", results]
    p1.main(FLAGS + paths + ["--max_epochs", "2"], device="cpu")
    exp = p3.main(FLAGS + paths + ["--max_epochs", "3", "--cluster_number", str(K),
                                   "--kmeans_n_init", "3"], device="cpu")
    return dict(exp=exp, cohorts=cohorts, paths=paths, results=results)


def test_p3_writes_what_jax_reads(p3_run):
    exp = p3_run["exp"]
    assert exp == os.path.join(p3_run["results"], "Clustering")
    jcfg = JConfig.load(os.path.join(exp, "config.json"))
    assert jcfg.loss == "ae_mse_sup_fake_detect_kl" and jcfg.cluster_number == K
    for m in ("loss", "ae_mse", "delta"):
        assert os.path.exists(os.path.join(exp, "weight", m, "checkpoint.npz")), m
        feats = jload(os.path.join(exp, "out_feat", m), dl_keys=True)
        for cohort in COHORTS:
            got = feats[cohort]
            n = len(p3_run["cohorts"][cohort]["encounter_id"])
            assert list(got["encounter_id"]) == list(p3_run["cohorts"][cohort]["encounter_id"])
            assert got["hidden"].shape == (n, 16) and np.isfinite(got["hidden"]).all()
            for key in ("cluster_pred", "cluster_label"):
                assert got[key].shape == (n, K) and np.isfinite(got[key]).all()
                np.testing.assert_allclose(got[key].sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("method", ["kmeans", "dl"])
def test_p4_labels_the_p3_dumps(p3_run, method):
    out = p4.main(["--cluster_method", method, "--num_clusters", str(K), "--kmeans_n_init",
                   "3", "--results_path", p3_run["results"]], device="cpu")
    assert sorted(out) == ["ae_mse", "delta", "loss"]
    for metric, cohorts in out.items():
        for cohort in COHORTS:
            labels = cohorts[cohort]
            assert len(labels) == len(p3_run["cohorts"][cohort]["encounter_id"])
            assert labels.min() >= 0 and labels.max() < K
            if method == "dl":
                full = np.load(os.path.join(p3_run["exp"], "out_feat", metric,
                                            f"{cohort}.npy"), allow_pickle=True).item()
                np.testing.assert_array_equal(labels, np.argmax(full["cluster_pred"], 1))


def test_p3_and_p4_without_device_raise_when_no_card(p3_run, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = ["--base_path", p3_run["paths"][1], "--results_path", str(tmp_path)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p3.main(FLAGS + paths + ["--pretrain_path", os.path.join(p3_run["results"], "Pretrain")])
    assert not os.path.exists(tmp_path / "Clustering" / "weight")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p4.main(["--results_path", p3_run["results"]])
