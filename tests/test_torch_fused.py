"""The port's one epoch body (`fused_epoch`, `train/graphs.py`) on the CPU,
where `GraphedStep` calls each step directly on its static buffers, at a
small width (B=8, T=24, H=16, a ragged tail in every cohort):

  * `train()` with `fused_epoch` on and off (`=False`: uncaptured, never
    deferred) against a stepped reference arm written here (`Trainer.step`
    over `_epoch_batches`, and each eval pass `steps.eval_step` over its
    padded batches): the parameters, BatchNorm buffers, optimizer state,
    generator state, the update count and every summary row (per-batch
    losses, epochs, validation) bit for bit, for each optimizer, under
    bfloat16, and with `eval_interval=3` deferred against `eval_interval=3`
    undeferred (the port's mirror of the JAX
    `test_eval_interval_bit_identical`);
  * an eval pass's metrics and dumps, with `fused_epoch` on and off,
    against the stepped reference's, with the dumps fetched, left on the
    device, and with the losses deferred;
  * a training cohort under one batch trains through the one body as a
    single masked tail, with the bits of the stepped reference;
  * under `fused_epoch=False` an eval pass writes its `log_valid_freq`
    lines from its one fetched table, and the run writes the summary rows,
    checkpoints and dumps of the run with the switch on;
  * the DEC loop (JAX `tests/test_dec_stopping.py:114-189`): the deferred
    cadence and `pipeline_delta`'s lagged count, with the speculative
    epoch's rollback and the stop found at an eval's top, give the stop
    epoch, delta history and weights of the unlagged loop; `pipeline_delta`
    moves the count's read one epoch later and nothing else;
  * the epoch loop's control against the JAX loop's with JAX
    `fused_epoch=True` (the deferred dispatch and drain under
    `eval_interval=3`), each package's epochs and evals replaced by the
    same script: the epochs trained, fetched and evaluated, the rates,
    early stop, the schedule's state, the flags, the checkpoints' epochs and
    the validation rows; and the DEC loop's, deferred and pipelined, with
    its label predictions scripted too: the counts dispatched and read, the
    stop epoch and reason, the rollback, the candidacy and the rows;
  * a hand kernel's call while a graph is captured counts as captured, and
    each replay adds the graph's count to its launches;
  * `Config().fused_epoch`, its flag, and `--fused_epoch false` /
    `--pipeline_delta true` reaching the trainers of `cli.p1` and `cli.p3`.
"""

import json
import logging
import os
from collections import defaultdict

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.config import Config as JConfig
from deep_interpolation_clustering_tpu.train import checkpoint as jckpt
from deep_interpolation_clustering_tpu.train.optim import get_learning_rate as jget_lr
from deep_interpolation_clustering_tpu.train.trainer import Trainer as JTrainer
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.cli import common, p1, p3
from deep_interpolation_clustering_tpu_torch.config import _IGNORED
from deep_interpolation_clustering_tpu_torch.data import (
    ArrayDataset,
    make_synthetic_cohorts,
    process_splits,
)
from deep_interpolation_clustering_tpu_torch.train import ClusterTrainer, Trainer
from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt
from deep_interpolation_clustering_tpu_torch.train import steps
from test_torch_trainer import _datasets, _port_cfg

torch.set_num_threads(1)

SMALL = dict(batch_size=8, num_timestamps=24, lstm_hidden=16, head_hidden=16,
             log_train_freq=2, log_valid_freq=2)
DEC = dict(SMALL, loss="ae_mse_sup_fake_detect_kl", cluster_number=3, kmeans_n_init=3,
           init_cluster_center="none")


@pytest.fixture(scope="module")
def cohorts():
    out = process_splits(make_synthetic_cohorts(n_total=61, max_obs=24, seed=5),
                         rng=np.random.RandomState(0))
    assert all(len(d["feat"]) % 8 for d in out.values())  # a ragged tail everywhere
    return out


def _trainer(cohorts, path, cls=Trainer, **kw):
    cfg = Config(**{**SMALL, **kw})
    ds = {c: ArrayDataset(cfg, {k: np.array(v, copy=True) for k, v in d.items()}, c)
          for c, d in cohorts.items()}
    return cls(cfg, ds, str(path), device="cpu")


def _state(tr):
    out = dict(tr.net.state_dict())
    for i, p in enumerate(tr.net.parameters()):
        out.update({f"opt.{i}.{k}": v for k, v in tr.opt.state[p].items()})
    return out


def _same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    differ = [k for k in sa if not torch.equal(torch.as_tensor(sa[k]), torch.as_tensor(sb[k]))]
    assert not differ, differ
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.num_updates == b.num_updates


def _rows(tr):
    with open(os.path.join(tr.exp_path, "summary", "events.jsonl")) as f:
        return [json.loads(x) for x in f]


def _stepped_eval(tr, scope, ds, denoise, dump_keys=None, device_dumps=False,
                  defer_losses=False):
    """The reference eval pass: `steps.eval_step` over `ds` in order, in
    batches of B, the last padded to B by repeating its real rows and
    masked to them; the metrics and dumps in `eval_one_epoch`'s form."""
    b, n = tr.cfg.batch_size, len(ds)
    data = tr.cohort_data(ds.cohort)
    losses, outs = [], defaultdict(list)
    for start in range(0, n, b):
        real = np.arange(start, min(start + b, n))
        idx = torch.as_tensor(real[np.arange(b) % len(real)])
        mask = None if len(real) == b else torch.as_tensor(
            (np.arange(b) < len(real)).astype(np.float32))
        batch_losses, out = steps.eval_step(tr.net, tr.cfg, steps.gather_batch(data, idx),
                                            tr.generator, denoise, mask, dump_keys)
        losses.append(batch_losses)
        for k, v in out.items():
            outs[k].append(v[:len(real)])
    keys = list(losses[0])
    table = torch.stack([torch.stack([batch[k] for k in keys]) for batch in losses])
    if defer_losses and device_dumps:
        metrics = {k: table[:, j] for j, k in enumerate(keys)}
    else:
        metrics = {k: float(np.mean(table[:, j].numpy(), dtype=np.float64))
                   for j, k in enumerate(keys)}
    dumps = {k: [torch.cat(v) if device_dumps else torch.cat(v).numpy()] for k, v in outs.items()}
    dumps["__index__"] = [np.arange(n)]
    return metrics, dumps


def _stepped_epoch(tr):
    """The reference epoch: `Trainer.step` over `_epoch_batches`, its losses
    as the table and names `_dispatch_fused_epoch` returns."""
    losses = [tr.step(*batch) for batch in tr._epoch_batches(tr.epoch)]
    keys = list(losses[0])
    return torch.stack([torch.stack([batch[k] for k in keys]) for batch in losses]), keys


def _stepped(tr):
    """Make `tr` the reference arm: its epochs and eval passes the loops
    above, around the trainer's step bodies."""
    tr._dispatch_fused_epoch = lambda: _stepped_epoch(tr)
    tr.eval_one_epoch = lambda *a, **k: _stepped_eval(tr, *a, **k)
    return tr


# ---------------------------------------------------------------- p1
@pytest.mark.parametrize("kw", [
    dict(),
    dict(optimizer="sgd"),
    dict(optimizer="rmsprop", lr_decay_step_or_patience=1),
    dict(compute_dtype="bfloat16"),
    dict(eval_interval=3, lr_decay_step_or_patience=1),
], ids=["adam", "sgd", "rmsprop", "bf16", "eval_interval3"])
def test_fused_train_equals_stepped(cohorts, tmp_path, kw):
    runs = {}
    for arm in ("fused", "uncaptured", "stepped"):
        tr = _trainer(cohorts, tmp_path / arm, max_epochs=4, fused_epoch=arm == "fused", **kw)
        if arm == "stepped":
            _stepped(tr)
        runs[arm] = (tr, tr.train())
        tr.close()
    ref, last_ref = runs["stepped"]
    n_batches = ref.datasets["training"].num_batches(8)
    assert ref.num_updates == 3 * n_batches and not ref._graphs
    rows = _rows(ref)
    assert [r["scope"] for r in rows].count("train_batch") == 3 * len(range(1, n_batches + 1, 2))
    for arm in ("fused", "uncaptured"):
        tr, last = runs[arm]
        assert last == last_ref, arm
        _same_state(tr, ref)
        assert _rows(tr) == rows, arm
        # the run went through the one body's steps, none captured here
        assert {k[0] for k in tr._graphs} == {"train", "eval"}, arm
        assert not any(g.capture for g in tr._graphs.values())
    assert runs["fused"][0]._graphs.keys() == runs["uncaptured"][0]._graphs.keys()


@pytest.mark.parametrize("device_dumps,defer_losses,lean", [
    (False, False, False), (True, False, False), (True, True, False), (False, False, True),
], ids=["fetched", "device", "device_deferred", "lean"])
def test_fused_eval_equals_stepped(cohorts, tmp_path, device_dumps, defer_losses, lean):
    tr = _trainer(cohorts, tmp_path, max_epochs=2)
    tr.train_one_epoch()
    keys = ("hidden", "cluster_pred", "cluster_label") if lean else None
    gen = tr.generator.get_state()
    valid = tr.datasets["validation"]
    m_ref, d_ref = _stepped_eval(tr, "valid", valid, False, keys, device_dumps, defer_losses)
    for fused in (True, False):
        tr.cfg.fused_epoch = fused
        tr.generator.set_state(gen)
        m, d = tr.eval_one_epoch("valid", valid, False, keys, device_dumps, defer_losses)
        if defer_losses:
            n_batches = valid.num_batches(8)
            assert all(isinstance(v, torch.Tensor) and v.shape == (n_batches,)
                       for v in m.values())
            assert m.keys() == m_ref.keys()
            assert all(torch.equal(m[k], m_ref[k]) for k in m_ref), fused
        else:
            assert m == m_ref, fused
        assert set(d) == set(d_ref) and (set(d) - {"__index__"} == {"hidden"} if lean else True)
        for k in d_ref:
            got, want = d[k][0], d_ref[k][0]
            if device_dumps and k != "__index__":
                assert isinstance(got, torch.Tensor) and isinstance(want, torch.Tensor)
            assert np.array_equal(np.asarray(got), np.asarray(want)), (fused, k)
    tr.close()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "uncaptured"])
def test_cohort_under_one_batch_trains_as_one_masked_tail(cohorts, tmp_path, fused):
    small = {c: ({k: v[:5] for k, v in d.items()} if c == "training" else d)
             for c, d in cohorts.items()}
    tr = _trainer(small, tmp_path / "body", max_epochs=3, fused_epoch=fused)
    ref = _stepped(_trainer(small, tmp_path / "ref", max_epochs=3, fused_epoch=fused))
    assert len(tr.datasets["training"]) == 5 and not tr._can_fuse(tr.datasets["training"])
    for _ in range(2):
        table, keys = tr._dispatch_fused_epoch()
        want, want_keys = ref._dispatch_fused_epoch()
        assert keys == want_keys and table.shape == (1, len(keys))
        assert torch.equal(table, want)
        tr.epoch += 1
        ref.epoch += 1
    assert set(tr._graphs) == {("train", True)}  # the masked tail alone
    _same_state(tr, ref)
    assert tr.num_updates == 2
    for t in (tr, ref):
        t.close()


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_uncaptured_eval_logs_from_its_table_and_writes_the_same_files(cohorts, tmp_path):
    files, logged = {}, {}
    for fused in (True, False):
        lines = _Lines()
        logging.getLogger("dicl.torch").addHandler(lines)
        try:
            tr = _trainer(cohorts, tmp_path / str(fused), max_epochs=3, fused_epoch=fused)
            tr.train()
            tr.eval("training", generate_feat=True, metric="loss")
            tr.close()
        finally:
            logging.getLogger("dicl.torch").removeHandler(lines)
        logged[fused] = [x for x in lines.lines if "%)]: " in x]  # the batch lines
        files[fused] = dict(rows=_rows(tr), feat=np.load(
            tmp_path / str(fused) / "out_feat" / "loss" / "training.npy",
            allow_pickle=True).item())
        with np.load(os.path.join(tr.exp_path, "weight", "loss", ckpt.CKPT_NAME)) as z:
            files[fused]["ckpt"] = {k: z[k] for k in z.files}
    # log_*_freq 2: batches 1, 3, ... of two epochs and their validation
    # passes, and of eval()'s pass over the training cohort
    per_pass = {c: len(range(1, tr.datasets[c].num_batches(8) + 1, 2))
                for c in ("training", "validation")}
    assert per_pass["training"] == 3
    valid = [x for x in logged[False] if "]: valid-" in x]
    assert len(valid) == 2 * per_pass["validation"]
    assert len(logged[False]) == len(valid) + 3 * per_pass["training"]
    assert logged[False] == logged[True]
    assert files[False]["rows"] == files[True]["rows"]
    a, b = files[False]["feat"], files[True]["feat"]
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    a, b = files[False]["ckpt"], files[True]["ckpt"]
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------- p3
def _dec_run(cohorts, path, **kw):
    tr = _trainer(cohorts, path, ClusterTrainer, **{**DEC, **kw})
    tr.train()
    tr.close()
    return tr


def _same_run(a, b):
    assert (a.epoch, a.delta_history) == (b.epoch, b.delta_history)
    for (n, p), (_, q) in zip(a.net.state_dict().items(), b.net.state_dict().items()):
        assert torch.equal(p, q), n


def test_dec_pipeline_delta_stop_rollback_bit_identical(cohorts, tmp_path):
    """The count rule fires at epoch 2 (the first with a previous
    prediction). With eval_interval=4 the lagged count is read inside epoch
    3, whose speculative work is rolled back; with eval_interval=3 it is
    read at epoch 3's top, before anything is dispatched."""
    kw = dict(stopping_delta=None, stopping_mode="count", stopping_count=10**9, max_epochs=6)
    ref = _dec_run(cohorts, tmp_path / "ref", eval_interval=1, **kw)
    assert ref.epoch == 2 and len(ref.delta_history) == 2
    for name, extra in {"deferred": dict(eval_interval=4),
                        "piped": dict(eval_interval=4, pipeline_delta=True),
                        "top": dict(eval_interval=3, pipeline_delta=True),
                        "stepped": dict(eval_interval=4, fused_epoch=False)}.items():
        _same_run(_dec_run(cohorts, tmp_path / name, **kw, **extra), ref)


def test_dec_deferred_cadence_delta_bit_identical(cohorts, tmp_path):
    kw = dict(stopping_delta=None, max_epochs=5)
    ref = _dec_run(cohorts, tmp_path / "cad1", eval_interval=1, **kw)
    assert len(ref.delta_history) == 4
    for name, extra in {"cad3": dict(eval_interval=3),
                        "cad3p": dict(eval_interval=3, pipeline_delta=True)}.items():
        run = _dec_run(cohorts, tmp_path / name, **kw, **extra)
        _same_run(run, ref)
        assert os.path.exists(tmp_path / name / "weight" / "delta" / ckpt.CKPT_NAME)


def test_pipeline_delta_moves_the_read_not_the_result(cohorts, tmp_path):
    kw = dict(stopping_delta=None, max_epochs=5, eval_interval=3)
    runs, orders = {}, {}
    for piped in (False, True):
        tr = _trainer(cohorts, tmp_path / str(piped), ClusterTrainer,
                      **{**DEC, **kw, "pipeline_delta": piped})
        order = orders[piped] = []
        dispatch, resolve = tr._dispatch_pred_cluster, tr._resolve_delta
        tr._dispatch_pred_cluster = lambda *a, _t=tr, _o=order, _d=dispatch, **k: (
            _o.append(("eval", _t.epoch)), _d(*a, **k))[1]
        tr._resolve_delta = lambda c, n, _t=tr, _o=order, _r=resolve: (
            _o.append(("read", _t.epoch)), _r(c, n))[1]
        tr.train()
        tr.close()
        runs[piped] = tr
    _same_run(runs[True], runs[False])
    assert orders[False] == [(w, e) for e in range(1, 5) for w in ("eval", "read")]
    # epoch 1's count is read in epoch 2, after epoch 2's eval is dispatched,
    # and epoch 2's at epoch 3's top
    assert orders[True] == [("eval", 1), ("eval", 2), ("read", 2), ("read", 3), ("eval", 3),
                            ("read", 3), ("eval", 4), ("read", 4)]


# ------------------------------------------------------- loop vs JAX
SCRIPT = [2.0, 1.5, 1.5, 1.6, 1.2, 1.25, 1.3, 1.31, 1.4, 1.5, 1.6, 1.7]


def _script(t, trace, rate):
    """Replace the trainer's epochs (stepped, dispatched, fetched) and evals
    by the script; record what the loop asks of them."""
    t.train_one_epoch = lambda *a, **k: (
        trace.append(("train", t.epoch, np.float32(rate()))), {"loss": 1.0})[1]
    t._dispatch_fused_epoch = lambda *a, **k: (
        trace.append(("dispatch", t.epoch, np.float32(rate()))), t.epoch)[1]
    t._finalize_fused_epoch = lambda e, handles, nb: (
        trace.append(("fetch", e, handles, t.epoch)), {"loss": 1.0})[1]
    t.eval_one_epoch = lambda scope, *a, **k: (
        trace.append((scope, t.epoch)),
        ({"loss": SCRIPT[t.epoch - 1], "ae_mse": SCRIPT[t.epoch - 1] / 2}, {}))[1]


@pytest.mark.parametrize("kw", [
    dict(eval_interval=1),
    dict(eval_interval=3),
    dict(eval_interval=3, lr_decay_mode="plateau", lr_decay_step_or_patience=1),
    dict(eval_interval=3, lr_decay_mode="warmup", warmup_epochs=3, early_stopping=2),
], ids=["every", "every3", "plateau3", "warmup3_stop"])
def test_fused_epoch_loop_control_matches_jax(tmp_path, kw):
    kw = {"lr_decay_step_or_patience": 2, **kw}
    jcfg = JConfig(**SMALL, dropout=0.0, max_epochs=12, fused_epoch=True, **kw)
    cfg = _port_cfg(jcfg)
    assert cfg.fused_epoch
    jds, ds = _datasets(process_splits(make_synthetic_cohorts(n_total=30, max_obs=24, seed=5),
                                       rng=np.random.RandomState(0)), jcfg, cfg)
    jtr = JTrainer(jcfg, jds, str(tmp_path / "jax"))
    tr = Trainer(cfg, ds, str(tmp_path / "port"), device="cpu")
    traces = {}
    for name, t, rate in (("jax", jtr, lambda: jget_lr(jtr.opt_state)),
                          ("port", tr, lambda: float(tr.opt.param_groups[0]["lr"]))):
        traces[name] = []
        _script(t, traces[name], rate)
        t.train()
        t.close()
    assert traces["port"] == traces["jax"]
    kinds = {x[0] for x in traces["port"]}
    assert kinds >= ({"dispatch", "fetch"} if cfg.eval_interval > 1 else {"train"})
    assert tr.epoch == jtr.epoch
    assert tr.lr_schedule.state_dict() == jtr.lr_schedule.state_dict()
    assert tr.flag_dict.to_dict() == jtr.flag_dict.to_dict()
    for m in ("loss", "ae_mse"):
        epochs = [mod.load_checkpoint(os.path.join(t.exp_path, "weight", m, mod.CKPT_NAME))[0]
                  for mod, t in ((jckpt, jtr), (ckpt, tr))]
        assert epochs[0] == epochs[1]
    valid = [[r for r in _rows(t) if r["scope"] == "valid"] for t in (jtr, tr)]
    assert valid[0] == valid[1] and valid[0]


DELTAS = [0.9, 0.5, 0.3, 0.3, 0.2, 0.05, 0.2, 0.01, 0.0, 0.0]
N_VALID = 100


def _dec_script(t, trace, rate):
    """The DEC loop's epochs and label predictions by script: epoch e's
    labels are all e, and the count it dispatches changes DELTAS[e-1] of
    the N_VALID labels."""
    t.init_centers = lambda: np.zeros(N_VALID, np.int64)
    _script(t, trace, rate)

    def dispatch(scope, ds, prev, *a, defer_losses=False, **k):
        trace.append(("pred", t.epoch, int(prev[0]), defer_losses))
        loss = SCRIPT[t.epoch - 1]
        return (int(round(DELTAS[t.epoch - 1] * N_VALID)), np.full(N_VALID, t.epoch),
                {"loss": loss, "ae_mse": loss / 2})

    t._dispatch_pred_cluster = dispatch
    candidacy, should_stop = t._ckpt_candidacy, t._should_stop
    t._ckpt_candidacy = lambda m: (trace.append(
        ("cand", t.epoch, {k: v for k, v in m.items() if k != "lr"})), candidacy(m))[1]
    t._should_stop = lambda d, n: (lambda r: (trace.append(("stop?", t.epoch, r)), r)[1])(
        should_stop(d, n))


@pytest.mark.parametrize("kw", [
    dict(eval_interval=3, stopping_delta=0.1),
    dict(eval_interval=3, stopping_delta=0.1, pipeline_delta=True),
    dict(eval_interval=4, stopping_mode="count", stopping_count=5, update_interval=2,
         pipeline_delta=True),
    dict(eval_interval=3, stopping_mode="patience", stopping_patience=2, pipeline_delta=True),
    dict(eval_interval=4, stopping_delta=0.25, pipeline_delta=True),
    dict(eval_interval=2, stopping_delta=1e-9, lr_decay_mode="plateau",
         lr_decay_step_or_patience=1, pipeline_delta=True),
], ids=["deferred_stop_at_eval", "piped_stop_at_eval", "piped_count_update2",
        "piped_patience", "piped_rollback", "piped_plateau2"])
def test_fused_dec_loop_control_matches_jax(tmp_path, kw):
    from deep_interpolation_clustering_tpu.train import ClusterTrainer as JClusterTrainer

    kw = {**DEC, "dropout": 0.0, "lr_decay_step_or_patience": 2, "max_epochs": 11,
          "fused_epoch": True, **kw}
    jcfg = JConfig(**kw)
    cfg = _port_cfg(jcfg)
    jds, ds = _datasets(process_splits(make_synthetic_cohorts(n_total=40, max_obs=24, seed=5),
                                       rng=np.random.RandomState(0)), jcfg, cfg)
    jtr = JClusterTrainer(jcfg, jds, str(tmp_path / "jax"), use_tensorboard=False)
    tr = ClusterTrainer(cfg, ds, str(tmp_path / "port"), device="cpu")
    traces = {}
    for name, t, rate in (("jax", jtr, lambda: jget_lr(jtr.opt_state)),
                          ("port", tr, lambda: float(tr.opt.param_groups[0]["lr"]))):
        traces[name] = []
        _dec_script(t, traces[name], rate)
        last = t.train()
        traces[name].append(("last", {k: v for k, v in last.items() if k != "lr"}))
        t.close()
    assert traces["port"] == traces["jax"]
    assert any(x[0] == "dispatch" for x in traces["port"])
    assert tr.epoch == jtr.epoch and tr.delta_history == jtr.delta_history
    assert tr.lr_schedule.state_dict() == jtr.lr_schedule.state_dict()
    assert tr.flag_dict.to_dict() == jtr.flag_dict.to_dict()
    rows = [[r for r in _rows(t) if r["scope"] == "valid"] for t in (jtr, tr)]
    for r in rows[1]:
        if "lr" in r and not any("lr" in j and j["step"] == r["step"] for j in rows[0]):
            r.pop("lr")
    assert rows[0] == rows[1]


def test_launches_under_capture_are_counted_a_replay(monkeypatch):
    from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb

    wrapper = cb.KERNELS[0]
    monkeypatch.setattr(wrapper, "_launch", lambda *a: "out")
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    args = [torch.empty(2, 3, device="meta") for _ in range(3)]
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    before = cb.captured_counts()
    assert wrapper(*args) == "out"
    recorded = {k: n - before[k] for k, n in cb.captured_counts().items() if n != before[k]}
    assert recorded == {wrapper.name: 1} and wrapper.launches == 0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    for _ in range(3):  # three replays
        cb.add_launches(recorded)
    assert wrapper.launches == 3
    assert wrapper(*args) == "out" and wrapper.launches == 4


# ------------------------------------------------------------ config
def test_fused_epoch_is_a_field_read_by_the_clis(tmp_path, monkeypatch):
    assert Config().fused_epoch is True and "fused_epoch" not in _IGNORED
    assert JConfig().fused_epoch is True
    jcfg = JConfig(fused_epoch=False, pipeline_delta=True)
    jcfg.save(str(tmp_path))
    cfg = Config.load(str(tmp_path / "config.json"))
    assert cfg.fused_epoch is False and cfg.pipeline_delta is True
    seen = {}

    class Stub:
        def __init__(self, cfg, datasets, exp_path, *a, **k):
            seen[type(self).__name__] = cfg

        def train(self):
            pass

        def eval(self, *a, **k):
            pass

        def close(self):
            pass

    for mod, name in ((p1, "Trainer"), (p3, "ClusterTrainer")):
        monkeypatch.setattr(mod, name, type(name, (Stub,), {}))
        monkeypatch.setattr(mod, "make_datasets", lambda cfg: {})
        monkeypatch.setattr(mod, "init_run", lambda cfg, stage: str(tmp_path / stage))
    argv = ["--fused_epoch", "false", "--pipeline_delta", "true"]
    p1.main(argv, device="cpu")
    p3.main(argv, device="cpu")
    for name in ("Trainer", "ClusterTrainer"):
        assert seen[name].fused_epoch is False and seen[name].pipeline_delta is True
    defaults = common.config_from_args(common.build_parser("p1").parse_args([]))
    assert defaults.fused_epoch is True and defaults.pipeline_delta is False
