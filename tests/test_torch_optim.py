"""The port's optimizers and learning-rate schedule vs the JAX package's.

The schedule: both are plain Python on floats, so the comparison is exact
(`==`), epoch by epoch over 60 epochs, for the three modes, with the
`min_lr` clamp reached and a `state_dict` -> `load_state_dict` round trip
into a fresh schedule mid-run. Then the trainer on the CPU: after each
epoch every param group of its optimizer holds the rate the JAX schedule
gives.

SGD and RMSprop: three steps of torch's optimizer after the port's clip,
with weight decay, against the JAX `make_optimizer` (clip, decayed weights,
`trace` or `scale_by_rms` then `trace`) on the same parameters and
gradients, at 1e-5. Neither divides by a gradient's own size on its first
step the way Adam does, so no element is exempt.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_interpolation_clustering_tpu.config import Config as JConfig
from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.train.optim import LRSchedule as JLRSchedule
from deep_interpolation_clustering_tpu.train.optim import make_optimizer as jmake_optimizer
from deep_interpolation_clustering_tpu.train.steps import _make_update
from deep_interpolation_clustering_tpu.train.steps import build_inputs as jbuild_inputs
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.compat import state_dict_from_jax
from deep_interpolation_clustering_tpu_torch.data import (
    ArrayDataset,
    make_synthetic_cohorts,
    process_splits,
)
from deep_interpolation_clustering_tpu_torch.train import Trainer, make_optimizer, update
from deep_interpolation_clustering_tpu_torch.train.optim import LRSchedule, clip_grad_global_norm_
from test_torch_model import configs, jax_batch, port_net, to_torch

torch.set_num_threads(1)

EPOCHS = 60
LR_FIELDS = ("min_lr", "lr_decay_mode", "lr_decay_step_or_patience", "lr_decay_rate",
             "warmup_multiplier", "warmup_epochs")

# a validation loss that improves, stalls (plateaus longer than the
# patience), improves by less than the 1e-4 relative threshold, and worsens
_rng = np.random.RandomState(5)
PLATEAU_LOSSES = np.concatenate([
    np.linspace(2.0, 1.0, 8), np.full(9, 1.0), 1.0 - 1e-5 * np.arange(1, 8),
    np.linspace(0.9, 0.8, 5), np.full(12, 0.8), 0.8 + 0.1 * _rng.rand(19),
]).tolist()
assert len(PLATEAU_LOSSES) == EPOCHS

MODES = {
    "step": dict(),
    "step_clamped": dict(lr_decay_step_or_patience=3, min_lr=1e-6),
    "warmup": dict(lr_decay_mode="warmup", warmup_multiplier=8.0, warmup_epochs=10,
                   lr_decay_step_or_patience=5),
    "warmup_clamped": dict(lr_decay_mode="warmup", warmup_multiplier=8.0, warmup_epochs=10,
                           lr_decay_step_or_patience=5, min_lr=1e-4),
    "plateau": dict(lr_decay_mode="plateau", lr_decay_step_or_patience=3),
    "plateau_clamped": dict(lr_decay_mode="plateau", lr_decay_step_or_patience=1,
                            lr_decay_rate=0.01, min_lr=1e-5),
}


def _losses(kw):
    return PLATEAU_LOSSES if kw.get("lr_decay_mode") == "plateau" else [None] * EPOCHS


@pytest.mark.parametrize("name", sorted(MODES))
def test_schedule_equals_jax_over_60_epochs(name):
    kw = MODES[name]
    want_s, got_s = JLRSchedule(JConfig(**kw)), LRSchedule(Config(**kw))
    rates = []
    for loss in _losses(kw):
        want, got = want_s.step(loss), got_s.step(loss)
        assert got == want and got_s.lr == want_s.lr  # equal to the float
        assert got_s.state_dict() == want_s.state_dict()
        rates.append(got)
    assert len(set(rates)) > 1  # the rate moved
    if name.endswith("_clamped"):
        assert min(rates) == kw["min_lr"]


@pytest.mark.parametrize("resume_at", [7, 25])
@pytest.mark.parametrize("name", ["step", "warmup", "plateau"])
def test_state_dict_round_trip_mid_run(name, resume_at):
    """A fresh schedule that loads the state of epoch `resume_at` (through
    JSON, as a checkpoint's metadata travels) goes on as the JAX one does;
    the JAX schedule loads the port's state and the port the JAX one's."""
    kw = MODES[name]
    losses = _losses(kw)
    want_s, got_s = JLRSchedule(JConfig(**kw)), LRSchedule(Config(**kw))
    for loss in losses[:resume_at]:
        want_s.step(loss)
        got_s.step(loss)
    state = json.loads(json.dumps(got_s.state_dict()))
    assert set(state) == {"lr", "num_steps", "best", "num_bad"}
    resumed, jresumed = LRSchedule(Config(**kw)), JLRSchedule(JConfig(**kw))
    resumed.load_state_dict(json.loads(json.dumps(want_s.state_dict())))
    jresumed.load_state_dict(state)
    for loss in losses[resume_at:]:
        want = want_s.step(loss)
        assert resumed.step(loss) == want
        assert jresumed.step(loss) == want
    assert resumed.state_dict() == want_s.state_dict()


def _tiny_trainer(tmp_path, **kw):
    _, cfg = configs(**kw)
    cohorts = process_splits(
        make_synthetic_cohorts(n_total=30, max_obs=cfg.num_timestamps, seed=3),
        rng=np.random.RandomState(0),
    )
    ds = {c: ArrayDataset(cfg, d, c) for c, d in cohorts.items()}
    return cfg, Trainer(cfg, ds, str(tmp_path), device="cpu")


def _group_rates(tr):
    return [g["lr"] for g in tr.opt.param_groups]


@pytest.mark.parametrize("drive", ["train_one_epoch", "train_steps"])
def test_trainer_rate_follows_jax_schedule(drive, tmp_path):
    """`lr_decay_step_or_patience=2`: the optimizer's rate after epochs 1-5
    is the JAX schedule's, through both ways the trainer ends an epoch: the
    epoch loop `train()` (each epoch's validation row records the rate it
    set) and the `train_steps` stream."""
    cfg, tr = _tiny_trainer(tmp_path, lr_decay_step_or_patience=2, max_epochs=6)
    want_s = JLRSchedule(JConfig(lr_decay_step_or_patience=2, init_lr=cfg.init_lr))
    assert _group_rates(tr) == [cfg.init_lr]
    wants = [want_s.step(None) for _ in range(5)]
    if drive == "train_one_epoch":
        tr.train()
        tr.close()
        rows = [json.loads(line) for line in open(tmp_path / "summary" / "events.jsonl")]
        valid = [r for r in rows if r["scope"] == "valid"]
        assert [r["step"] for r in valid] == [1, 2, 3, 4, 5]
        assert [r["lr"] for r in valid] == wants
        assert tr.epoch == 6
    else:
        steps_per_epoch = len(tr._epoch_batches(1))
        for epoch, want in enumerate(wants, start=1):
            # each call streams from the start of the current epoch, and the
            # stream ends an epoch when it is asked for the next one's first
            # batch
            tr.train_steps(steps_per_epoch + 1)
            assert tr.epoch == epoch + 1
            assert _group_rates(tr) == [want] * len(tr.opt.param_groups)
    assert _group_rates(tr) == [wants[-1]] * len(tr.opt.param_groups)
    assert tr.lr_schedule.lr == wants[-1] == cfg.init_lr * 0.2 ** 2


def test_trainer_plateau_steps_on_the_given_loss(tmp_path):
    """`aly_pred` steps the schedule on the validation loss it is given."""
    cfg, tr = _tiny_trainer(tmp_path, lr_decay_mode="plateau", lr_decay_step_or_patience=1)
    want_s = JLRSchedule(JConfig(lr_decay_mode="plateau", lr_decay_step_or_patience=1,
                                 init_lr=cfg.init_lr))
    for loss in (1.0, 1.0, 1.0, 0.5):
        tr.train_one_epoch()
        tr.aly_pred("valid", {"loss": loss})
        tr.epoch += 1
        assert _group_rates(tr) == [want_s.step(loss)]
    assert tr.lr_schedule.lr == cfg.init_lr * 0.2


@pytest.mark.parametrize("drive", ["train_one_epoch", "train_steps"])
def test_trainer_plateau_without_a_loss_raises(drive, tmp_path):
    _, tr = _tiny_trainer(tmp_path, lr_decay_mode="plateau")
    with pytest.raises(ValueError, match="valid_loss"):
        if drive == "train_one_epoch":
            tr.train_one_epoch()
            tr.aly_pred("valid", {})
        else:
            tr.train_steps(len(tr._epoch_batches(1)) + 1)


# ------------------------------------------------------------ sgd, rmsprop
def _grads(seed, shapes, scale):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("grad_clip", [15.0, 0.5])
@pytest.mark.parametrize("name", ["sgd", "rmsprop"])
def test_optimizer_steps_match_jax(name, grad_clip):
    """Three steps on the same parameters and gradients: torch's optimizer
    after the port's clip against the JAX chain, every element within 1e-5
    after each step. `grad_clip=0.5` makes the clip fire at every step (the
    global norm is ~7); 15 never does."""
    kw = dict(optimizer=name, grad_clip=grad_clip, weight_decay_rate=4e-4, init_lr=3e-3)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    shapes = {"a": (7, 5), "b": (33,), "c": (4, 3, 2)}
    params = _grads(0, shapes, 1.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    joptimizer = jmake_optimizer(jcfg)
    jstate = joptimizer.init(jparams)
    opt = make_optimizer(cfg, list(tparams.values()))
    for step in range(3):
        grads = _grads(10 + step, shapes, 0.7)
        updates, jstate = joptimizer.update({k: jnp.asarray(g) for k, g in grads.items()},
                                            jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k].copy())
        clip_grad_global_norm_(tparams.values(), cfg.grad_clip)
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} step {step + 1} {k}")
        moved = np.abs(np.asarray(jparams["a"]) - params["a"]).max()
        assert moved > 1e-4  # the steps moved the parameters


def test_sgd_update_on_the_net_matches_jax():
    """Three SGD steps of the whole p1 update (forward, losses, backward,
    clip, decayed weights, nesterov momentum) against the JAX update, from
    the same weights and inputs: every parameter within 1e-5."""
    jcfg, cfg = configs(dropout=0.0, optimizer="sgd")
    params, state = init_net(jax.random.PRNGKey(11), jcfg)
    joptimizer = jmake_optimizer(jcfg)
    opt_state = joptimizer.init(params)
    jupdate = jax.jit(_make_update(jcfg, joptimizer, False))
    net = port_net(cfg, params, state)
    opt = make_optimizer(cfg, net.parameters())
    assert isinstance(opt, torch.optim.SGD)
    batch = jax_batch(jcfg)
    for step in range(3):
        key = jax.random.PRNGKey(200 + step)
        inputs = jbuild_inputs(jcfg, batch, jax.random.split(key)[0], True, False)
        params, state, opt_state, jlosses = jupdate(params, state, opt_state, batch, key)
        losses = update(net, opt, cfg, to_torch(inputs), None)
        assert abs(float(losses["loss"]) - float(jlosses["loss"])) <= 1e-5 * max(
            1.0, abs(float(jlosses["loss"])))
        want = state_dict_from_jax(params, state)
        for n, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"step {step + 1} {n}")


def test_config_from_jax_json_keeps_the_rate_fields():
    jcfg = JConfig(min_lr=1e-5, lr_decay_mode="warmup", lr_decay_step_or_patience=7,
                   lr_decay_rate=0.5, warmup_multiplier=4.0, warmup_epochs=3)
    cfg = Config.from_dict(json.loads(json.dumps(dataclasses.asdict(jcfg))))
    for name in LR_FIELDS:
        assert getattr(cfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("name", LR_FIELDS)
def test_config_rate_defaults_are_the_jax_ones(name):
    assert getattr(Config(), name) == getattr(JConfig(), name)


def test_config_rejects_an_unknown_decay_mode():
    with pytest.raises(ValueError, match="lr_decay_mode"):
        Config(lr_decay_mode="cosine")
