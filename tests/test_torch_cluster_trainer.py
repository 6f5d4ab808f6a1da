"""The port's p3 `ClusterTrainer` vs the JAX package's, on the CPU at a
small width (B=8, T=24, H=16, K=3, dropout 0), and the DEC fields of the
port's `Config`.

  * `init_centers` with the sklearn mirror and with `random`, on the same
    latents, writes JAX's centres exactly (and the same validation labels),
    into the parameter the optimizer steps: after one DEC step they moved.
  * `load_pretrain_weight` takes every leaf of a JAX p1 checkpoint bit for
    bit and leaves the DEC head as it was; a port p3 checkpoint restores
    in the JAX `ClusterTrainer` and the reverse.
  * `_should_stop` in the delta, count and patience modes gives JAX's
    answers on the same sequence.
  * The DEC epoch loop's control against the JAX loop's with
    `fused_epoch=False`, each package's epoch and label prediction replaced
    by the same scripted deltas and metrics: the epochs trained and
    predicted, the labels each prediction is compared with, the rates, the
    stop epoch and reason, the checkpoint candidacy on every stop path and
    the summary rows (without `lr` on a stop between evals, whose JAX row
    has none).
  * `generate_pred_cluster` counts changed labels on the device.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.config import Config as JConfig
from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.train import ClusterTrainer as JClusterTrainer
from deep_interpolation_clustering_tpu.train import checkpoint as jckpt
from deep_interpolation_clustering_tpu.train.optim import get_learning_rate
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.config import PORT_ONLY
from deep_interpolation_clustering_tpu_torch.compat import jax_from_state_dict
from deep_interpolation_clustering_tpu_torch.train import ClusterTrainer
from test_torch_trainer import SMALL, _cohorts, _datasets, _port_cfg

torch.set_num_threads(1)

DEC = dict(SMALL, loss="ae_mse_sup_fake_detect_kl", cluster_number=3, kmeans_n_init=3,
           log_train_freq=1000, log_valid_freq=1000, fused_epoch=False)


def _pair(tmp_path, n_total=40, **kw):
    jcfg = JConfig(**{**DEC, **kw})
    cfg = _port_cfg(jcfg)
    jds, ds = _datasets(_cohorts(jcfg.num_timestamps, n_total=n_total), jcfg, cfg)
    jtr = JClusterTrainer(jcfg, jds, str(tmp_path / "jax"), use_tensorboard=False)
    tr = ClusterTrainer(cfg, ds, str(tmp_path / "port"), device="cpu")
    return jtr, tr


# ------------------------------------------------------------------ config
def test_config_dec_fields_load_from_a_jax_config(tmp_path, caplog):
    jcfg = JConfig(cluster_number=6, dec_alpha=2.0, init_cluster_center="random",
                   stopping_delta=1e-3, stopping_mode="patience", stopping_count=4,
                   stopping_patience=7, update_interval=2, kmeans_n_init=9,
                   kmeans_impl="sklearn", dc_restore_metric="delta", pipeline_delta=True,
                   cluster_method="dl", num_clusters=6, dl_cluster_label_type="label")
    with caplog.at_level("INFO", logger="dicl.torch"):
        cfg = Config.load(jcfg.save(str(tmp_path)))
    for name in ("cluster_number", "dec_alpha", "init_cluster_center", "stopping_delta",
                 "stopping_mode", "stopping_count", "stopping_patience", "update_interval",
                 "kmeans_n_init", "kmeans_impl", "dc_restore_metric", "pipeline_delta",
                 "cluster_method", "num_clusters", "dl_cluster_label_type", "compute_dtype"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    ignored = " ".join(r.getMessage() for r in caplog.records if "ignoring" in r.getMessage())
    for name in ("cluster_number", "stopping_mode", "kmeans_impl", "compute_dtype",
                 "cluster_method", "pipeline_delta"):
        assert name not in ignored, name
    # the defaults are JAX's
    for name in Config.__dataclass_fields__:
        if name not in PORT_ONLY:  # the JAX package has no mTAN
            assert getattr(Config(), name) == getattr(JConfig(), name), name


def test_config_compute_dtype_other_than_float32_raises(tmp_path):
    """A JAX bfloat16 config.json loads as bfloat16; a value other than the
    two the port computes in still raises, naming both."""
    bf16 = Config.load(JConfig(compute_dtype="bfloat16").save(str(tmp_path / "bf16")))
    assert bf16.compute_dtype == "bfloat16"
    assert Config(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    for other in ("float16", "float64"):
        with pytest.raises(ValueError, match=r"'float32', 'bfloat16'"):
            Config(compute_dtype=other)
    with pytest.raises(ValueError, match=r"'float32', 'bfloat16'"):
        Config.load(JConfig(compute_dtype="float16").save(str(tmp_path / "f16")))
    assert Config.load(JConfig().save(str(tmp_path / "f32"))).compute_dtype == "float32"
    for bad in (dict(stopping_mode="never"), dict(kmeans_impl="gpu")):
        with pytest.raises(ValueError):
            Config(**bad)


# ------------------------------------------------------------ centre init
def _latents(seed=0, n_train=28, n_valid=6, d=32):
    rng = np.random.RandomState(seed)
    means = rng.randn(3, d).astype(np.float32) * 3
    return {c: (means[rng.randint(0, 3, n)] + rng.randn(n, d)).astype(np.float32)
            for c, n in (("training", n_train), ("validation", n_valid))}


@pytest.mark.parametrize("mode,impl", [("kmeans", "sklearn"), ("random", "device")])
def test_init_centers_gives_jax_centres(tmp_path, mode, impl):
    jtr, tr = _pair(tmp_path, init_cluster_center=mode, kmeans_impl=impl)
    lat = _latents()
    for t, as_ in ((jtr, np.asarray), (tr, torch.from_numpy)):
        t.load_pretrain_weight = lambda: None
        t.generate_pretrain_feat = lambda cohort, denoise=False, _as=as_: _as(lat[cohort])
    jprev, prev = jtr.init_centers(), tr.init_centers()
    centers = tr.net.cluster_assignment.cluster_centers
    np.testing.assert_array_equal(centers.detach().numpy(),
                                  np.asarray(jtr.params["cluster_centers"]))
    if mode == "kmeans":
        np.testing.assert_array_equal(prev.numpy(), np.asarray(jprev))
    else:
        assert prev is None and jprev is None
    # the optimizer steps the parameter the centres were written into
    assert any(p is centers for g in tr.opt.param_groups for p in g["params"])
    before = centers.detach().clone()
    tr.train_steps(1)
    assert not torch.equal(centers, before)
    assert tr.opt.state[centers]["exp_avg"].abs().max() > 0
    tr.close()
    jtr.close()


def test_load_pretrain_weight_from_a_jax_p1_checkpoint(tmp_path):
    jcfg = JConfig(**DEC)
    cfg = _port_cfg(jcfg)
    params, state = init_net(jax.random.PRNGKey(3), jcfg)  # a p1 model: no DEC head
    pre = tmp_path / "Pretrain"
    jckpt.save_checkpoint(str(pre / "weight" / "ae_mse" / "checkpoint.npz"), 2, params, state)
    _, ds = _datasets(_cohorts(jcfg.num_timestamps, n_total=30), jcfg, cfg)
    tr = ClusterTrainer(cfg, ds, str(tmp_path / "Clustering"), pretrain_exp_path=str(pre),
                        device="cpu")
    centers = tr.net.cluster_assignment.cluster_centers
    head = centers.detach().clone()
    live = {n: p for n, p in tr.net.named_parameters()}
    tr.load_pretrain_weight()
    assert torch.equal(centers, head)
    got_p, got_s = jax_from_state_dict(tr.net.state_dict())
    want = jckpt._flatten_nested({"params": params, "state": state})
    got = jckpt._flatten_nested({"params": got_p, "state": got_s})
    assert sorted(got) == sorted(list(want) + ["params/cluster_centers"])
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert all(p is live[n] for n, p in tr.net.named_parameters())
    tr.close()


def test_dec_checkpoints_restore_across_packages(tmp_path):
    jtr, tr = _pair(tmp_path)
    tr.train_steps(1)
    tr.epoch = 2
    tr._ckpt_candidacy({"loss": 1.0, "ae_mse": 0.5, "delta": 0.25})
    jtr.weight_paths = tr.weight_paths
    jtr.load_weight("delta")
    want, _ = jax_from_state_dict(tr.net.state_dict())
    assert jtr.epoch == 2
    for k, v in jckpt._flatten_nested(want).items():
        np.testing.assert_array_equal(np.asarray(jckpt._flatten_nested(jtr.params)[k]), v,
                                      err_msg=k)
    # the reverse: JAX's centres and weights land in the port's parameters
    jtr.params = dict(jtr.params, cluster_centers=jtr.params["cluster_centers"] + 1.0)
    jtr.epoch = 3
    jtr.weight_paths = {m: str(tmp_path / "jaxw" / m) for m in tr.weight_paths}
    for d in jtr.weight_paths.values():
        os.makedirs(d)
    jtr.flag_dict = type(jtr.flag_dict)(list(jtr.weight_paths))
    jtr._ckpt_candidacy({"loss": 1.0, "ae_mse": 0.5, "delta": 0.25})
    tr.weight_paths = jtr.weight_paths
    tr.load_weight("delta")
    assert tr.epoch == 3
    np.testing.assert_array_equal(tr.net.cluster_assignment.cluster_centers.detach().numpy(),
                                  np.asarray(jtr.params["cluster_centers"]))
    tr.close()
    jtr.close()


# --------------------------------------------------------------- stopping
@pytest.mark.parametrize("kw", [
    dict(stopping_mode="delta", stopping_delta=0.1),
    dict(stopping_mode="delta", stopping_delta=None),
    dict(stopping_mode="count", stopping_count=2),
    dict(stopping_mode="patience", stopping_patience=2),
])
def test_should_stop_matches_jax(kw):
    seq = [(1.0, None), (0.5, 8), (0.6, 9), (0.4, 3), (0.41, 2), (0.45, 5), (0.05, 1), (0.0, 0)]
    answers = []
    for cls, cfg in ((JClusterTrainer, JConfig(**kw)), (ClusterTrainer, Config(**kw))):
        tr = cls.__new__(cls)
        tr.cfg = cfg
        tr._best_delta = float("inf")
        tr._since_improve = 0
        answers.append([tr._should_stop(d, n) for d, n in seq])
    assert answers[0] == answers[1]


# ------------------------------------------------------------ epoch loop
DELTAS = [0.9, 0.5, 0.3, 0.3, 0.2, 0.05, 0.2, 0.01, 0.0, 0.0]
LOSSES = [2.0, 1.5, 1.5, 1.6, 1.2, 1.25, 1.3, 1.31, 1.4, 1.5]
N_VALID = 100


def _script(t, trace, rate):
    """Replace the trainer's epoch, label prediction and centre init by the
    script; record what the loop asks of them."""
    t.init_centers = lambda: "init"
    t.train_one_epoch = lambda *a, **k: (
        trace.append(("train", t.epoch, np.float32(rate()))), {"loss": 1.0})[1]

    def pred(scope, ds, prev, *a, **k):
        trace.append(("pred", t.epoch, prev))
        d = DELTAS[t.epoch - 1]
        n_changed = None if prev == "init" and d == DELTAS[0] else int(round(d * N_VALID))
        return d, n_changed, t.epoch, {"loss": LOSSES[t.epoch - 1],
                                       "ae_mse": LOSSES[t.epoch - 1] / 2}

    t.generate_pred_cluster = pred
    candidacy = t._ckpt_candidacy
    # the rate is left out: the summary rows below hold it
    t._ckpt_candidacy = lambda m: (trace.append(
        ("cand", t.epoch, {k: v for k, v in m.items() if k != "lr"})), candidacy(m))[1]
    should_stop = t._should_stop
    t._should_stop = lambda d, n: (lambda r: (trace.append(("stop?", t.epoch, r)), r)[1])(
        should_stop(d, n))


def _valid_rows(exp):
    with open(os.path.join(exp, "summary", "events.jsonl")) as f:
        return [json.loads(x) for x in f if json.loads(x)["scope"] == "valid"]


@pytest.mark.parametrize("kw", [
    dict(eval_interval=1, stopping_delta=0.02),
    dict(eval_interval=3, stopping_delta=0.1),
    dict(eval_interval=3, stopping_delta=0.02, update_interval=2),
    dict(eval_interval=1, stopping_mode="count", stopping_count=5, update_interval=2),
    dict(eval_interval=3, stopping_mode="patience", stopping_patience=2),
    dict(eval_interval=2, stopping_delta=1e-9, lr_decay_mode="plateau",
         lr_decay_step_or_patience=1),
], ids=["every", "every3_stop_at_eval", "every3_update2_stop_between", "count_update2",
        "patience3_to_the_last", "plateau2_stop_between"])
def test_dec_epoch_loop_control_matches_jax(tmp_path, kw):
    kw = {"lr_decay_step_or_patience": 2, "max_epochs": 11, **kw}
    jtr, tr = _pair(tmp_path, **kw)
    traces = {}
    for name, t, rate in (("jax", jtr, lambda: get_learning_rate(jtr.opt_state)),
                          ("port", tr, lambda: tr.opt.param_groups[0]["lr"])):
        traces[name] = []
        _script(t, traces[name], rate)
        last = t.train()
        traces[name].append(("last", {k: v for k, v in last.items() if k != "lr"}))
        t.close()
    assert traces["port"] == traces["jax"]
    assert tr.epoch == jtr.epoch and tr.delta_history == jtr.delta_history
    assert tr.lr_schedule.state_dict() == jtr.lr_schedule.state_dict()
    assert tr.flag_dict.to_dict() == jtr.flag_dict.to_dict()
    jrows, rows = _valid_rows(jtr.exp_path), _valid_rows(tr.exp_path)
    assert [r["step"] for r in rows] == [r["step"] for r in jrows]
    for r, jr in zip(rows, jrows):
        if "lr" not in jr:  # the JAX row of a stop between evals
            r.pop("lr")
        assert r == jr
    assert sum(x[0] == "cand" for x in traces["port"]) >= 1


def test_generate_pred_cluster_counts_changed_labels(tmp_path):
    _, tr = _pair(tmp_path)
    valid = tr.datasets["validation"]
    delta, n_changed, labels, metrics = tr.generate_pred_cluster("valid", valid, None)
    assert delta == 1.0 and n_changed is None and labels.shape == (len(valid),)
    assert np.isfinite(metrics["kl"])
    prev = labels.clone()
    prev[:3] = (prev[:3] + 1) % tr.cfg.cluster_number
    delta, n_changed, again, _ = tr.generate_pred_cluster("valid", valid, prev)
    assert torch.equal(again, labels)
    assert n_changed == 3 and delta == 3 / len(valid)
    tr.close()
