"""The port's entry points under data-parallel and multi-process launches,
on the CPU with gloo.

From one tiny p0 cohort (a ragged training tail that leaves rank 1's share
of the last batch all padding):
  * `p1 --data_parallel 1` (a one-rank group) writes the same bits as p1
    without a group: checkpoints, dumps, summary (invariant 2);
  * `p1 --data_parallel 2` (two spawned ranks) matches p1 in one process
    within invariant 1's band, and writes each file once;
  * `p1 --num_processes 2` as two subprocesses joined over tcp:// matches
    `--data_parallel 2`;
  * `p3 --data_parallel 2` matches p3 in one process;
  * `p2` and `p4` at `--num_processes 2` give the CSVs (rtol 1e-5, atol
    1e-6) and the labels (exactly) of one process, rank 0 writing.
Every spawned rank and subprocess runs under a timeout of its own.

Invariant 1's band (tests/test_trainer.py, tests/test_multihost.py):
losses within 1e-5, parameters at most 5e-3 apart with no more than 0.1%
of elements beyond 1e-4, validation ae_mse within 5e-4, latents within
1e-4, rec_ob (physical units) within rtol 3e-4 / atol 1e-4.
"""

import csv
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu_torch import Config, parallel
from deep_interpolation_clustering_tpu_torch.cli import p1, p2, p3, p4
from deep_interpolation_clustering_tpu_torch.cli.common import save_processed
from deep_interpolation_clustering_tpu_torch.data import make_synthetic_cohorts, process_splits
from deep_interpolation_clustering_tpu_torch.info import COHORTS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H = 16, 16, 16
FLAGS = ["--batch_size", str(B), "--num_timestamps", str(T), "--lstm_hidden", str(H),
         "--head_hidden", str(H), "--max_epochs", "3", "--aux_tasks",
         '{"future_vital": 0.5}', "--early_stopping", "100"]
P2 = ["--restore_metrics", "ae_mse", "--k_max", "4", "--n_init", "2", "--gap_b", "2"]
P3 = ["--cluster_number", "3", "--kmeans_n_init", "3", "--stopping_delta", "0"]
P4 = ["--stage", "Pretrain", "--restore_metrics", "ae_mse", "--cluster_method", "kmeans",
      "--num_clusters", "3", "--kmeans_n_init", "3"]
SUBPROCESS_TIMEOUT_S = 300


def _launch(code, cwd):
    """A python subprocess in a session of its own (so a hang is killed
    with whatever it started)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _wait(procs, timeout_s):
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, f"subprocess failed:\n{out[-6000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return outs


def _np2_code(pid, port, results, p2_results):
    """p1, then p2 and p4, as rank `pid` of 2 processes."""
    def flags(i, results_path):
        return ["--num_processes", "2", "--process_id", str(pid), "--results_path",
                results_path, "--coordinator_address", f"127.0.0.1:{port[i]}"]

    return (
        "import torch; torch.set_num_threads(1)\n"
        "from deep_interpolation_clustering_tpu_torch.cli import p1, p2, p4\n"
        f"p1.main({FLAGS + ['--base_path', 'Data'] + flags(0, results)!r}, device='cpu')\n"
        f"p2.main({P2 + flags(1, p2_results)!r}, device='cpu')\n"
        f"p4.main({P4 + flags(2, p2_results)!r}, device='cpu')\n"
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh")
    cohorts = process_splits(make_synthetic_cohorts(n_total=100, max_obs=T, seed=11),
                             rng=np.random.RandomState(0))
    sizes = {"training": 2 * B + 5, "validation": B + 5, "testing": 10}
    cohorts = {c: {k: v[:sizes[c]] for k, v in cohorts[c].items()} for c in COHORTS}
    save_processed(Config(base_path=str(root / "Data")), cohorts)
    old = os.getcwd()
    os.chdir(root)
    try:
        base = ["--base_path", "Data"]
        p1.main(FLAGS + base + ["--results_path", "single"], device="cpu")
        shutil.copytree(root / "single", root / "p2multi")
        ports = [parallel.free_port() for _ in range(3)]
        np2 = [_launch(_np2_code(pid, ports, "np2", "p2multi"), str(root)) for pid in range(2)]
        try:
            p1.main(FLAGS + base + ["--results_path", "dp1", "--data_parallel", "1"],
                    device="cpu")
            p1.main(FLAGS + base + ["--results_path", "dp2", "--data_parallel", "2"],
                    device="cpu")
            pre = ["--pretrain_path", os.path.join("single", "Pretrain")]
            p3.main(FLAGS + base + P3 + pre + ["--results_path", "single"], device="cpu")
            p3.main(FLAGS + base + P3 + pre + ["--results_path", "p3dp2", "--data_parallel",
                                                "2"], device="cpu")
            p2_single = p2.main(P2 + ["--results_path", "single"], device="cpu")
            p4_single = p4.main(P4 + ["--results_path", "single"], device="cpu")
        finally:
            _wait(np2, SUBPROCESS_TIMEOUT_S)
    finally:
        os.chdir(old)
    return dict(root=root, cohorts=cohorts, p2=p2_single, p4=p4_single)


def _files(folder):
    """The files under `folder` (TensorBoard event files, named by time and
    host, left out)."""
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, fs in os.walk(folder) for f in fs
                  if not f.startswith("events.out.tfevents"))


def _p1_files(run):
    """The p1 stage's files (not p2's or p4's, written into it later)."""
    return [f for f in _files(run / "Pretrain")
            if not f.startswith("opt_k") and "_aligned" not in f]


def _rows(run, stage="Pretrain"):
    with open(os.path.join(run, stage, "summary", "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _dump(run, metric, cohort, stage="Pretrain"):
    return np.load(os.path.join(run, stage, "out_feat", metric, f"{cohort}.npy"),
                   allow_pickle=True).item()


def _ckpt(run, metric, stage="Pretrain"):
    with np.load(os.path.join(run, stage, "weight", metric, "checkpoint.npz")) as z:
        return {k: z[k] for k in z.files}


def test_data_parallel_one_is_the_single_process_bit_for_bit(runs):
    """Invariant 2: a one-rank group writes the same files with the same
    bits as the process without a group."""
    one, single = runs["root"] / "dp1", runs["root"] / "single"
    assert _p1_files(one) == _p1_files(single)
    assert _rows(one) == _rows(single)
    for m in ("loss", "ae_mse"):
        a, b = _ckpt(one, m), _ckpt(single, m)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{m} {k}")
        for cohort in COHORTS:
            a, b = _dump(one, m, cohort), _dump(single, m, cohort)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{m} {cohort} {k}")


def test_env_launch_is_the_single_process_bit_for_bit(runs, monkeypatch):
    """torchrun's env:// variables and `--num_processes 1` without an
    address: a one-rank group in this process, the same bits as no group;
    the group is left afterwards."""
    root = runs["root"]
    for var, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(parallel.free_port())),
                       ("RANK", "0"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(var, value)
    monkeypatch.chdir(root)
    p1.main(FLAGS + ["--base_path", "Data", "--results_path", "env1", "--num_processes", "1"],
            device="cpu")
    assert not torch.distributed.is_initialized()
    assert _rows(root / "env1") == _rows(root / "single")
    for m in ("loss", "ae_mse"):
        a, b = _ckpt(root / "env1", m), _ckpt(root / "single", m)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{m} {k}")


def _within_band(run, single, stage="Pretrain", metrics=("loss", "ae_mse")):
    rows, want = _rows(run, stage), _rows(single, stage)
    assert [(r["scope"], r["step"]) for r in rows] == [(r["scope"], r["step"]) for r in want]
    for got, w in zip(rows, want):
        if got["scope"] == "train":
            assert abs(got["loss"] - w["loss"]) < 1e-5
        if got["scope"] == "valid":
            assert abs(got["ae_mse"] - w["ae_mse"]) < 5e-4
    for m in metrics:
        a, b = _ckpt(run, m, stage), _ckpt(single, m, stage)
        keys = sorted(k for k in b if k.startswith("params/"))
        assert keys == sorted(k for k in a if k.startswith("params/"))
        n_viol = n_tot = 0
        for k in keys:
            diff = np.abs(a[k] - b[k])
            assert diff.max() < 5e-3, f"{m} {k}: {diff.max():.2e}"
            n_viol += int((diff > 1e-4).sum())
            n_tot += diff.size
        assert n_viol <= max(1, n_tot // 1000), f"{m}: {n_viol}/{n_tot} beyond 1e-4"
        for cohort in COHORTS:
            a, b = _dump(run, m, cohort, stage), _dump(single, m, cohort, stage)
            np.testing.assert_array_equal(a["encounter_id"], b["encounter_id"])
            np.testing.assert_allclose(a["hidden"], b["hidden"], atol=1e-4)
            np.testing.assert_allclose(a["rec_ob"], b["rec_ob"], rtol=3e-4, atol=1e-4)
            if "cluster_pred" in b:
                np.testing.assert_allclose(a["cluster_pred"], b["cluster_pred"], atol=1e-4)


def test_data_parallel_two_matches_single(runs):
    """Invariant 1 through the entry point, and every file written once (by
    rank 0): the same file list and summary rows as one process."""
    dp2, single = runs["root"] / "dp2", runs["root"] / "single"
    _within_band(dp2, single)
    assert _p1_files(dp2) == _p1_files(single)
    with open(dp2 / "Pretrain" / "config.json") as f:
        saved = json.load(f)
    assert saved["data_parallel"] == 2 and "num_processes" not in saved


def test_num_processes_two_matches_data_parallel_two(runs):
    """Two processes joined over tcp:// are the same two ranks as
    `--data_parallel 2`: the same bits in every file; `config.json` holds
    no process field."""
    np2, dp2 = runs["root"] / "np2", runs["root"] / "dp2"
    assert _p1_files(np2) == _p1_files(dp2)
    for m in ("loss", "ae_mse"):
        a, b = _ckpt(np2, m), _ckpt(dp2, m)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{m} {k}")
        for cohort in COHORTS:
            a, b = _dump(np2, m, cohort), _dump(dp2, m, cohort)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{m} {cohort} {k}")
    with open(np2 / "Pretrain" / "config.json") as f:
        saved = json.load(f)
    assert not {"num_processes", "process_id", "coordinator_address"} & set(saved)
    assert saved["data_parallel"] == 0


def test_p3_data_parallel_two_matches_single(runs):
    """DEC at two ranks: the centres (in the checkpoints), the label deltas
    and the dumps' soft labels within the band of one process."""
    run, single = runs["root"] / "p3dp2", runs["root"] / "single"
    _within_band(run, single, "Clustering", ("loss", "ae_mse", "delta"))
    deltas = [[r["delta"] for r in _rows(x, "Clustering") if r["scope"] == "valid"]
              for x in (run, single)]
    assert deltas[0] == deltas[1]
    for m in ("loss", "ae_mse", "delta"):
        for cohort in COHORTS:
            a = _dump(run, m, cohort, "Clustering")["cluster_pred"]
            b = _dump(single, m, cohort, "Clustering")["cluster_pred"]
            np.testing.assert_array_equal(a.argmax(1), b.argmax(1))


def _csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], np.float64)


def test_p2_p4_num_processes_two_match_single(runs):
    """p2's tables and p4's labels under two processes, rank 0 writing,
    against one process over the same dumps."""
    multi, single = runs["root"] / "p2multi", runs["root"] / "single"
    plot = os.path.join("Pretrain", "opt_k", "ae_mse", "plot")
    for name in ("gap_sts_v1.csv", "elbow.csv"):
        ha, a = _csv(multi / plot / name)
        hb, b = _csv(single / plot / name)
        assert ha == hb
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
    for cohort in COHORTS:
        path = os.path.join("Pretrain", "out_feat", "ae_mse_kmeans_aligned", f"{cohort}_3.npy")
        a = np.load(multi / path, allow_pickle=True).item()
        b = np.load(single / path, allow_pickle=True).item()
        np.testing.assert_array_equal(a["encounter_id"], b["encounter_id"])
        np.testing.assert_array_equal(a["cluster_id"], b["cluster_id"])
        np.testing.assert_array_equal(a["cluster_id"], runs["p4"]["ae_mse"][cohort])
    assert _files(multi / "Pretrain" / "opt_k") == _files(single / "Pretrain" / "opt_k")


def _fail_or_hang(r):
    if r == 0:
        raise ValueError("rank 0 fails")
    time.sleep(600)


def test_spawn_raises_a_rank_failure_and_stops_the_others():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 0 failed.*rank 0 fails"):
        parallel.spawn(_fail_or_hang, 2, timeout_s=120)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("argv, match", [
    (["--data_parallel", "-1"], "counts the visible cards"),
    (["--num_processes", "2", "--process_id", "0", "--coordinator_address",
      "127.0.0.1:1", "--data_parallel", "3"], "one rank per process"),
], ids=["all_cards_on_cpu", "ranks_disagree"])
def test_p1_rejects_a_world_it_cannot_make(tmp_path, monkeypatch, argv, match):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match=match):
        p1.main(argv, device="cpu")
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("local_rank, backend, want", [
    (None, "nccl", 1), ("1", "gloo", 0), ("0", "nccl", 0), ("1", "nccl", None),
], ids=["rank_modulo_cards", "gloo_shares", "local_rank", "nccl_past_the_cards"])
def test_rank_device(monkeypatch, local_rank, backend, want):
    """A rank's card: `LOCAL_RANK` when torchrun sets it, else the rank
    modulo the visible cards; only gloo ranks may share a card, an NCCL
    rank past the visible cards raises. The CPU takes gloo only."""
    from deep_interpolation_clustering_tpu_torch.parallel.multihost import rank_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1 if local_rank else 2)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    if want is None:
        with pytest.raises(RuntimeError, match="LOCAL_RANK 1"):
            rank_device("cuda", backend, 1)
    else:
        assert rank_device("cuda", backend, 3) == torch.device("cuda", want)
    with pytest.raises(ValueError, match="only gloo"):
        rank_device("cpu", "nccl", 0)
