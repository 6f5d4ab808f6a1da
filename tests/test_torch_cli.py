"""The port's p1 entry point on the CPU, read back by the JAX package.

`cli.p1.main(argv, device="cpu")` on a tiny pickled cohort (written by the
port's `save_processed`, as either package's p0 writes it) trains two
epochs and writes `config.json`, which the JAX `Config.load` reads, a
checkpoint per improved metric, which the JAX `load_checkpoint` restores,
and six feature dumps, which the JAX `load_feature_dumps` reads. Without
`device` and without a card, it raises.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu import Config as JConfig
from deep_interpolation_clustering_tpu.cluster.final import load_feature_dumps
from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.train import checkpoint as jckpt
from deep_interpolation_clustering_tpu.train.optim import make_optimizer as jmake_optimizer
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.cli import p1
from deep_interpolation_clustering_tpu_torch.cli.common import (
    build_parser,
    config_from_args,
    save_processed,
)
from deep_interpolation_clustering_tpu_torch.data import make_synthetic_cohorts, process_splits
from deep_interpolation_clustering_tpu_torch.info import COHORTS

torch.set_num_threads(1)

T = 16
FLAGS = ["--batch_size", "8", "--num_timestamps", str(T), "--lstm_hidden", "8",
         "--head_hidden", "8", "--max_epochs", "3", "--aux_tasks", '{"future_vital": 0.5}']


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("p1")
    base, results = str(root / "Data"), str(root / "Results")
    cohorts = process_splits(make_synthetic_cohorts(n_total=40, max_obs=T, seed=4),
                             rng=np.random.RandomState(0))
    save_processed(Config(base_path=base), cohorts)
    exp = p1.main(FLAGS + ["--base_path", base, "--results_path", results], device="cpu")
    return dict(exp=exp, cohorts=cohorts, base=base, results=results)


def test_p1_writes_a_config_jax_reads(run):
    assert run["exp"] == os.path.join(run["results"], "Pretrain")
    jcfg = JConfig.load(os.path.join(run["exp"], "config.json"))
    assert (jcfg.batch_size, jcfg.num_timestamps, jcfg.lstm_hidden, jcfg.max_epochs) == (
        8, T, 8, 3)
    assert jcfg.base_path == run["base"]


def test_p1_checkpoints_restore_in_jax(run):
    jcfg = JConfig.load(os.path.join(run["exp"], "config.json"))
    params, _ = init_net(jax.random.PRNGKey(0), jcfg)
    template = jmake_optimizer(jcfg).init(params)
    rows = [json.loads(x) for x in open(os.path.join(run["exp"], "summary", "events.jsonl"))]
    assert [(r["scope"], r["step"]) for r in rows if r["scope"] in ("train", "valid")] == [
        ("train", 1), ("valid", 1), ("train", 2), ("valid", 2)]
    for m in ("loss", "ae_mse"):
        path = os.path.join(run["exp"], "weight", m, "checkpoint.npz")
        epoch, jparams, _, opt, meta = jckpt.load_checkpoint(path, opt_state_template=template)
        assert opt is not None and meta["metric"] == m and epoch in (1, 2)
        assert jax.tree_util.tree_structure(jparams) == jax.tree_util.tree_structure(params)


def test_p1_dumps_load_in_jax(run):
    for metric in ("loss", "ae_mse"):
        feats = load_feature_dumps(os.path.join(run["exp"], "out_feat", metric))
        for cohort in COHORTS:
            want_ids = list(run["cohorts"][cohort]["encounter_id"])
            got = feats[cohort]
            assert list(got["encounter_id"]) == want_ids
            n = len(want_ids)
            assert got["hidden"].shape == (n, 16) and np.isfinite(got["hidden"]).all()
            full = np.load(os.path.join(run["exp"], "out_feat", metric, f"{cohort}.npy"),
                           allow_pickle=True).item()
            assert full["rec_ob"].shape == (n, 6, T) and np.isfinite(full["rec_ob"]).all()


def test_config_flag_reloads_with_overrides_winning(run):
    path = os.path.join(run["exp"], "config.json")
    cfg = config_from_args(build_parser("p1").parse_args(
        ["--config", path, "--max_epochs", "5", "--restore", "true",
         "--aux_tasks", '{"future_vital": 0.25}']))
    assert (cfg.max_epochs, cfg.restore, cfg.batch_size) == (5, True, 8)
    assert cfg.aux_tasks == {"future_vital": 0.25}


def test_p1_without_device_raises_when_no_card(run, monkeypatch, tmp_path):
    """No device given means the card: with none, p1 raises before it trains."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p1.main(FLAGS + ["--base_path", run["base"], "--results_path", str(tmp_path)])
    assert not os.path.exists(tmp_path / "Pretrain" / "weight")
