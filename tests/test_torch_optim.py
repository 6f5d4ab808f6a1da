"""The port's learning-rate schedule vs the JAX package's `LRSchedule`.

Both are plain Python on floats, so the comparison is exact (`==`), epoch by
epoch over 60 epochs, for the three modes, with the `min_lr` clamp reached
and a `state_dict` -> `load_state_dict` round trip into a fresh schedule
mid-run. Then the lean trainer on the CPU: after each epoch every param
group of its optimizer holds the rate the JAX schedule gives.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.config import Config as JConfig
from deep_interpolation_clustering_tpu.train.optim import LRSchedule as JLRSchedule
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.data import (
    ArrayDataset,
    make_synthetic_cohorts,
    process_splits,
)
from deep_interpolation_clustering_tpu_torch.train import Trainer
from deep_interpolation_clustering_tpu_torch.train.optim import LRSchedule
from test_torch_model import configs

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


def _tiny_trainer(**kw):
    _, cfg = configs(**kw)
    cohorts = process_splits(
        make_synthetic_cohorts(n_total=30, max_obs=cfg.num_timestamps, seed=3),
        rng=np.random.RandomState(0),
    )
    ds = {c: ArrayDataset(cfg, d, c) for c, d in cohorts.items()}
    return cfg, Trainer(cfg, ds, device="cpu")


def _group_rates(tr):
    return [g["lr"] for g in tr.opt.param_groups]


@pytest.mark.parametrize("drive", ["train_one_epoch", "train_steps"])
def test_trainer_rate_follows_jax_schedule(drive):
    """`lr_decay_step_or_patience=2`: the optimizer's rate after epochs 1-5
    is the JAX schedule's, through both ways the trainer ends an epoch."""
    cfg, tr = _tiny_trainer(lr_decay_step_or_patience=2)
    want_s = JLRSchedule(JConfig(lr_decay_step_or_patience=2, init_lr=cfg.init_lr))
    assert _group_rates(tr) == [cfg.init_lr]
    steps_per_epoch = len(tr._epoch_batches(1))
    for epoch in range(1, 6):
        if drive == "train_one_epoch":
            tr.train_one_epoch()
        else:
            # each call streams from the start of the current epoch, and the
            # stream ends an epoch when it is asked for the next one's first
            # batch
            tr.train_steps(steps_per_epoch + 1)
        want = want_s.step(None)
        assert tr.epoch == epoch + 1
        assert _group_rates(tr) == [want] * len(tr.opt.param_groups)
        assert tr.lr_schedule.lr == want
    assert want == cfg.init_lr * 0.2 ** 2


def test_trainer_plateau_steps_on_the_given_loss():
    cfg, tr = _tiny_trainer(lr_decay_mode="plateau", lr_decay_step_or_patience=1)
    want_s = JLRSchedule(JConfig(lr_decay_mode="plateau", lr_decay_step_or_patience=1,
                                 init_lr=cfg.init_lr))
    for loss in (1.0, 1.0, 1.0, 0.5):
        tr.train_one_epoch(valid_loss=loss)
        assert _group_rates(tr) == [want_s.step(loss)]
    assert tr.lr_schedule.lr == cfg.init_lr * 0.2


@pytest.mark.parametrize("drive", ["train_one_epoch", "train_steps"])
def test_trainer_plateau_without_a_loss_raises(drive):
    _, tr = _tiny_trainer(lr_decay_mode="plateau")
    with pytest.raises(ValueError, match="valid_loss"):
        if drive == "train_one_epoch":
            tr.train_one_epoch()
        else:
            tr.train_steps(len(tr._epoch_batches(1)) + 1)


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
