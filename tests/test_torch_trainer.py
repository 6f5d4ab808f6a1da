"""The port's p1 trainer vs the JAX package's `Trainer`, on the CPU at a
small width (B=8, T=24, H=16), with the weights carried from JAX.

  * `eval_one_epoch` over a cohort whose size is not a multiple of B: every
    dump at 1e-5 and the metrics that take no random draw (`ae_mse`,
    `future_vital`) at 1e-5. `loss` and `fake_detection` depend on the
    fake batch: they are held to JAX on one padded, masked batch with the
    JAX `build_inputs` outputs fed to both, at 1e-5.
  * `merge_ob_pred` and `re_norm_data` equal to JAX's on the same dumps, and
    the dump keys of `feat_dump` full and lean equal to JAX's.
  * `train()` writes a checkpoint for each metric that improved, which the
    JAX `load_checkpoint` reads; a restore takes back the epoch, the
    optimizer, the rate schedule and the min-merged flags.
  * The epoch loop's control (eval cadence, schedule steps, plateau, early
    stop) against the JAX loop's, with each package's epoch and eval
    replaced by the same scripted metrics.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.config import Config as JConfig
from deep_interpolation_clustering_tpu.data import ArrayDataset as JArrayDataset
from deep_interpolation_clustering_tpu.data import make_synthetic_cohorts, process_splits
from deep_interpolation_clustering_tpu.train import checkpoint as jckpt
from deep_interpolation_clustering_tpu.train.optim import get_learning_rate
from deep_interpolation_clustering_tpu.train.steps import build_inputs as jbuild_inputs
from deep_interpolation_clustering_tpu.train.steps import make_eval_step
from deep_interpolation_clustering_tpu.train.trainer import Trainer as JTrainer
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.config import PORT_ONLY
from deep_interpolation_clustering_tpu_torch.compat import optimizer_to_jax, state_dict_from_jax
from deep_interpolation_clustering_tpu_torch.data import ArrayDataset
from deep_interpolation_clustering_tpu_torch.train import Trainer
from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt
from deep_interpolation_clustering_tpu_torch.train.steps import forward_and_losses
from test_torch_model import to_torch

torch.set_num_threads(1)

SMALL = dict(batch_size=8, num_timestamps=24, lstm_hidden=16, head_hidden=16, dropout=0.0)
DETERMINISTIC = ("ae_mse", "future_vital")


def _port_cfg(jcfg):
    return Config.from_dict({k: getattr(jcfg, k) for k in Config.__dataclass_fields__
                             if k not in PORT_ONLY})


def _cohorts(t, n_total=61, seed=5):
    return process_splits(make_synthetic_cohorts(n_total=n_total, max_obs=t, seed=seed),
                          rng=np.random.RandomState(0))


def _datasets(cohorts, jcfg, cfg):
    copy = lambda d: {k: np.array(v, copy=True) for k, v in d.items()}  # noqa: E731
    jds = {c: JArrayDataset(jcfg, copy(d), c) for c, d in cohorts.items()}
    ds = {c: ArrayDataset(cfg, copy(d), c) for c, d in cohorts.items()}
    return jds, ds


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A JAX trainer and a port trainer with JAX's weights, on one cohort."""
    jcfg = JConfig(**SMALL)
    cfg = _port_cfg(jcfg)
    jds, ds = _datasets(_cohorts(jcfg.num_timestamps), jcfg, cfg)
    jtr = JTrainer(jcfg, jds, str(tmp_path_factory.mktemp("jax")))
    tr = Trainer(cfg, ds, str(tmp_path_factory.mktemp("port")), device="cpu")
    tr.net.load_state_dict(state_dict_from_jax(jtr.params, jtr.state), strict=True)
    assert len(ds["validation"]) % cfg.batch_size != 0
    jmetrics, jdumps = jtr.eval_one_epoch("valid", jds["validation"], False)
    metrics, dumps = tr.eval_one_epoch("valid", ds["validation"], False)
    yield dict(jtr=jtr, tr=tr, jds=jds, ds=ds, jcfg=jcfg, cfg=cfg, jmetrics=jmetrics,
               jdumps=jdumps, metrics=metrics, dumps=dumps)
    tr.close()
    jtr.close()


def _cat(dumps):
    return {k: np.concatenate(v) for k, v in dumps.items()}


def test_eval_one_epoch_dumps_and_metrics(pair):
    got, want = _cat(pair["dumps"]), _cat(pair["jdumps"])
    n = len(pair["ds"]["validation"])
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["__index__"], np.arange(n))
    for k in want:
        assert got[k].shape == want[k].shape and got[k].shape[0] == n, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert sorted(pair["metrics"]) == sorted(pair["jmetrics"])
    for k in DETERMINISTIC:
        assert abs(pair["metrics"][k] - pair["jmetrics"][k]) <= 1e-5 * max(
            1.0, abs(pair["jmetrics"][k])), k


def test_masked_eval_losses_with_the_same_draws(pair):
    """The last validation batch (padded to B, masked) with JAX's draws."""
    jcfg, cfg, jtr = pair["jcfg"], pair["cfg"], pair["jtr"]
    ds = pair["jds"]["validation"]
    n, b = len(ds), jcfg.batch_size
    start = (n // b) * b
    idx = np.resize(np.arange(start, n), b)
    batch = {k: np.asarray(v[idx], np.float32) for k, v in ds.arrays().items()}
    batch["sample_mask"] = (np.arange(b) < n - start).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jlosses, jouts = make_eval_step(jcfg, False)(jtr.params, jtr.state, batch, key)
    inputs = jbuild_inputs(jcfg, batch, key, False, False)
    with torch.no_grad():
        out, losses = forward_and_losses(pair["tr"].net, cfg, to_torch(inputs), False, None)
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        assert abs(float(losses[k]) - float(jlosses[k])) <= 1e-5 * max(
            1.0, abs(float(jlosses[k]))), k
    np.testing.assert_allclose(out.hidden.numpy(), np.asarray(jouts["hidden"]), rtol=1e-5,
                               atol=1e-5)


def test_merge_ob_pred_and_re_norm_equal_jax(pair):
    ds, jds = pair["ds"]["validation"], pair["jds"]["validation"]
    copy = lambda d: {k: [np.array(a) for a in v] for k, v in d.items()}  # noqa: E731
    got = pair["tr"].re_norm_data(pair["tr"].merge_ob_pred(ds, copy(pair["dumps"])))
    want = pair["jtr"].re_norm_data(pair["jtr"].merge_ob_pred(jds, copy(pair["dumps"])))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # physical units: the min-max range of each channel, not the scaled input
    assert np.abs(got["ob"][:, 0]).max() > 20.0


def test_feat_dump_keys_full_and_lean(pair, tmp_path):
    """`eval()` dumps: full holds JAX's keys; lean holds what the JAX lean
    dump holds (the planes and `hidden`)."""
    full = pair["tr"].merge_ob_pred(pair["ds"]["validation"],
                                    {k: list(v) for k, v in pair["dumps"].items()})
    jfull = pair["jtr"].merge_ob_pred(pair["jds"]["validation"],
                                      {k: list(v) for k, v in pair["jdumps"].items()})
    assert sorted(full) == sorted(jfull)
    jtr, jds = pair["jtr"], pair["jds"]["validation"]
    _, jlean = jtr.eval_one_epoch("valid", jds, False,
                                  dump_keys=("hidden", "cluster_pred", "cluster_label"))
    want = sorted(jtr.merge_ob_pred(jds, jlean))
    cfg = pair["cfg"].replace(feat_dump="lean")
    tr = Trainer(cfg, {"validation": pair["ds"]["validation"]}, str(tmp_path), device="cpu")
    tr.net.load_state_dict(pair["tr"].net.state_dict())
    lean = tr.eval("validation", generate_feat=True, metric="ae_mse")
    tr.close()
    assert sorted(lean) == want and "rec_ob" not in lean
    saved = np.load(tmp_path / "out_feat" / "ae_mse" / "validation.npy", allow_pickle=True).item()
    assert sorted(saved) == want
    np.testing.assert_allclose(saved["hidden"], _cat(pair["jdumps"])["hidden"], rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port trains 2 epochs (max_epochs=3) with a rate that decays
    every epoch."""
    jcfg = JConfig(**SMALL, max_epochs=3, lr_decay_step_or_patience=1, log_train_freq=2)
    cfg = _port_cfg(jcfg)
    _, ds = _datasets(_cohorts(jcfg.num_timestamps, n_total=40), jcfg, cfg)
    exp = str(tmp_path_factory.mktemp("trained"))
    tr = Trainer(cfg, ds, exp, device="cpu")
    last = tr.train()
    tr.close()
    return dict(tr=tr, ds=ds, exp=exp, cfg=cfg, jcfg=jcfg, last=last)


def test_train_writes_checkpoints_of_improved_metrics(trained):
    tr, exp = trained["tr"], trained["exp"]
    assert tr.epoch == 3 and np.isfinite(trained["last"]["loss"])
    rows = [json.loads(x) for x in open(os.path.join(exp, "summary", "events.jsonl"))]
    assert [(r["scope"], r["step"]) for r in rows if r["scope"] in ("train", "valid")] == [
        ("train", 1), ("valid", 1), ("train", 2), ("valid", 2)]
    assert sum(r["scope"] == "train_batch" for r in rows) > 0
    for m in ("loss", "ae_mse"):
        path = os.path.join(exp, "weight", m, ckpt.CKPT_NAME)
        meta = ckpt.load_meta(path)
        # the last improvement's epoch, with the flags and the schedule then
        assert meta["epoch"] == tr.flag_dict.best_epoch[m] >= 1 and meta["metric"] == m
        assert meta["flag_dict"]["best"][m] == tr.flag_dict.best[m]
        assert meta["lr_schedule"]["num_steps"] == meta["epoch"]
        # the JAX package reads it, optimizer included
        jtr_opt = jax.tree_util.tree_map(np.asarray, _jax_opt_template(trained["jcfg"]))
        epoch, _, _, opt, _ = jckpt.load_checkpoint(path, opt_state_template=jtr_opt)
        assert epoch == meta["epoch"] and opt is not None
    assert not os.path.exists(os.path.join(exp, "weight", "delta", ckpt.CKPT_NAME))


def _jax_opt_template(jcfg):
    from deep_interpolation_clustering_tpu.models import init_net
    from deep_interpolation_clustering_tpu.train.optim import make_optimizer

    params, _ = init_net(jax.random.PRNGKey(0), jcfg)
    return make_optimizer(jcfg).init(params)


def test_restore_resumes_schedule_flags_and_optimizer(trained):
    cfg, exp, ds = trained["cfg"], trained["exp"], trained["ds"]
    meta = ckpt.load_meta(os.path.join(exp, "weight", "ae_mse", ckpt.CKPT_NAME))
    tr = Trainer(cfg.replace(restore=True, max_epochs=4), ds, exp, device="cpu")
    tr.load_weight()  # restore_metric = ae_mse
    assert tr.epoch == meta["epoch"]
    assert tr.lr_schedule.state_dict() == meta["lr_schedule"]
    assert [g["lr"] for g in tr.opt.param_groups] == [meta["lr"]]
    assert tr.flag_dict.best == trained["tr"].flag_dict.best
    assert tr.flag_dict.best_epoch == trained["tr"].flag_dict.best_epoch
    with np.load(os.path.join(exp, "weight", "ae_mse", ckpt.CKPT_NAME)) as z:
        saved = [z[k] for k in sorted(z.files) if k.startswith("opt/")]
    for got, want in zip(optimizer_to_jax(tr.opt, tr.net, tr.num_updates), saved):
        np.testing.assert_array_equal(got, want)
    # the resumed loop trains the stored epoch again (as JAX) and on to the
    # last, its schedule going on from the stored state
    tr.train()
    tr.close()
    assert tr.epoch == 4
    assert tr.lr_schedule.num_steps == meta["lr_schedule"]["num_steps"] + 4 - meta["epoch"]


# scripted validation metrics: improve, stall, improve a little, stall
SCRIPT = [2.0, 1.5, 1.5, 1.6, 1.2, 1.25, 1.3, 1.31, 1.4, 1.5, 1.6, 1.7]


@pytest.mark.parametrize("kw", [
    dict(eval_interval=1),
    dict(eval_interval=3),
    dict(eval_interval=2, lr_decay_mode="plateau", lr_decay_step_or_patience=1),
    dict(eval_interval=1, lr_decay_mode="plateau", lr_decay_step_or_patience=0,
         early_stopping=3),
    dict(eval_interval=4, lr_decay_mode="warmup", warmup_epochs=3, early_stopping=2),
], ids=["every", "every3", "plateau2", "plateau_stop", "warmup4_stop"])
def test_epoch_loop_control_matches_jax(kw, tmp_path):
    """Each package's epoch and eval replaced by the same scripted metrics:
    the rate at each epoch's start (as the float32 JAX keeps), the epochs
    evaluated, where early stop fires, and the schedule's final state are
    JAX's."""
    kw = {"lr_decay_step_or_patience": 2, **kw}
    jcfg = JConfig(**SMALL, max_epochs=12, fused_epoch=False, **kw)
    cfg = _port_cfg(jcfg)
    jds, ds = _datasets(_cohorts(jcfg.num_timestamps, n_total=30), jcfg, cfg)
    jtr = JTrainer(jcfg, jds, str(tmp_path / "jax"))
    tr = Trainer(cfg, ds, str(tmp_path / "port"), device="cpu")
    traces = {}
    for name, t, rate in (("jax", jtr, lambda: get_learning_rate(jtr.opt_state)),
                          ("port", tr, lambda: tr.opt.param_groups[0]["lr"])):
        trace = traces[name] = []
        t.train_one_epoch = lambda *a, _t=t, _tr=trace, _r=rate, **k: (
            _tr.append(("train", _t.epoch, np.float32(_r()))), {"loss": 1.0})[1]
        t.eval_one_epoch = lambda scope, *a, _t=t, _tr=trace, **k: (
            _tr.append((scope, _t.epoch)),
            ({"loss": SCRIPT[_t.epoch - 1], "ae_mse": SCRIPT[_t.epoch - 1] / 2}, {}))[1]
        t.train()
        t.close()
    assert traces["port"] == traces["jax"]
    assert tr.epoch == jtr.epoch
    assert tr.lr_schedule.state_dict() == jtr.lr_schedule.state_dict()
    assert tr.flag_dict.to_dict() == jtr.flag_dict.to_dict()
    n_evals = sum(x[0] == "valid" for x in traces["port"])
    assert 0 < n_evals <= len(SCRIPT)
