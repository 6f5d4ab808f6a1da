"""The fused epoch on data-parallel ranks (`parallel.capturable()`; the
captured steps of `train/graphs.py` on the ranks of a group), on the CPU at
the tests' small width (B=8, T=16, H=16): two gloo ranks in one spawn, one
gloo rank in another. A training cohort of two batches and a 5-row tail
(rank 1's share of it one real row and three padded), a validation cohort
of one batch and a 5-row tail.

gloo's collectives run on the host and cannot be captured, so a gloo group
runs the one epoch body uncaptured and is never deferred. Here the ranks
also take the deferred cadence with `parallel.capturable` patched true: on
the CPU `GraphedStep` calls each step directly on its static buffers, which
is the bookkeeping of the card's NCCL ranks without the graph.

  (a) the data-parallel train, masked-tail, eval and DEC steps read nothing
      to the host: `Tensor.item`, `tolist`, `numpy`, `cpu`, `__bool__`,
      `__float__` and `__int__` raise inside each step, the capture's
      precondition (the optimizer runs unguarded: on the card it is the
      capturable one, held to the CPU's by tests/test_torch_fused_gpu.py);
  (b) `ShardedCohort.ensure` permutes each plane in place: its `data_ptr()`
      holds, and its contents are JAX `ShardedCohort`'s shard on
      `make_mesh(2)` after each relayout;
  (c) a step that reads block k through its (1,) index buffer (`block_at`)
      has the bits of `steps.train_step` over `block(k)`;
  (d) two ranks through the fused path have the bits of the uncaptured
      epochs (`fused_epoch=False`), with dropout, fake detection and
      augmentation on (p1: two epochs and an eval pass; p3: `eval_interval`
      3 with `pipeline_delta`, deferred against undeferred); and
      without random draws, from JAX's initial weights, both stay within
      the band of the JAX sharded-vs-single tests (tests/test_trainer.py:311,
      tests/test_cohort_shard.py:98) of JAX's sharded fused trainers on
      `make_mesh(2)`;
  (e) `_can_fuse`: no group and NCCL groups defer; gloo groups, and NCCL
      with blocking waits, do not, and say so once; a gloo group's steps
      are not captured;
  (f) a one-rank gloo group, whose collectives now run, has the bits of no
      group, uncaptured and through the fused path.

The band (invariant 1 of tests/test_torch_parallel.py): losses within
1e-5, parameters at most 5e-3 apart with no more than 0.1% of elements
beyond 1e-4, running statistics as `_running_band`, validation ae_mse within
5e-4, latents within 1e-4.
"""

import contextlib
import logging
import os

import jax
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.config import Config as JConfig
from deep_interpolation_clustering_tpu.data import ArrayDataset as JArrayDataset
from deep_interpolation_clustering_tpu.data import make_synthetic_cohorts, process_splits
from deep_interpolation_clustering_tpu.parallel import make_mesh
from deep_interpolation_clustering_tpu.parallel.cohort import ShardedCohort as JShardedCohort
from deep_interpolation_clustering_tpu.train import ClusterTrainer as JClusterTrainer
from deep_interpolation_clustering_tpu.train.trainer import Trainer as JTrainer
from deep_interpolation_clustering_tpu_torch import Config, parallel
from deep_interpolation_clustering_tpu_torch.compat import state_dict_from_jax
from deep_interpolation_clustering_tpu_torch.data import ArrayDataset
from deep_interpolation_clustering_tpu_torch.parallel import mesh
from deep_interpolation_clustering_tpu_torch.parallel.cohort import ShardedCohort
from deep_interpolation_clustering_tpu_torch.train import ClusterTrainer, Trainer
from deep_interpolation_clustering_tpu_torch.train.graphs import GraphedStep
from deep_interpolation_clustering_tpu_torch.train.steps import train_step
from test_torch_parallel import _params, _params_band, _running_band

torch.set_num_threads(1)

D = 2
B, T, H = 8, 16, 16
SPAWN_TIMEOUT_S = 300
N_ROWS = 21  # ShardedCohort planes: 2 full blocks of 8 and a 5-row tail
WIDTH = dict(batch_size=B, num_timestamps=T, lstm_hidden=H, head_hidden=H,
             aux_tasks={"future_vital": 0.5}, early_stopping=100)
# random draws everywhere: dropout 0.2, fake detection, augmentation
RANDOM = dict(WIDTH, aug_input=True, log_train_freq=1, log_valid_freq=1)
RANDOM_DEC = dict(RANDOM, loss="ae_mse_sup_fake_detect_kl", cluster_number=3,
                  init_cluster_center="none", stopping_delta=None, eval_interval=3,
                  pipeline_delta=True, max_epochs=5)
# no random draw: the runs JAX's trainers are held to
DET = dict(WIDTH, loss="ae_mse_sup", fake_detection=False, dropout=0.0, log_train_freq=1000,
           log_valid_freq=1000)
DET_DEC = dict(DET, loss="ae_mse_sup_kl", cluster_number=3, init_cluster_center="none",
               stopping_delta=None, eval_interval=3, pipeline_delta=True, max_epochs=5)
HOST_READS = ("item", "tolist", "numpy", "cpu", "__bool__", "__float__", "__int__")


# ------------------------------------------------------------------ helpers
def _np(t):
    return t.detach().numpy().copy()


def _state(tr):
    out = {k: _np(v) for k, v in tr.net.state_dict().items()}
    for i, p in enumerate(tr.net.parameters()):
        out.update({f"opt.{i}.{k}": _np(v) for k, v in tr.opt.state[p].items()})
    out["generator"] = tr.generator.get_state().numpy().copy()
    return out


def _datasets(cfg, cohorts):
    return {c: ArrayDataset(cfg, {k: np.array(v, copy=True) for k, v in d.items()}, c)
            for c, d in cohorts.items()}


@contextlib.contextmanager
def _fusable():
    """The ranks of this gloo group take the fused code path."""
    saved = parallel.capturable
    parallel.capturable = lambda: True
    try:
        yield
    finally:
        parallel.capturable = saved


class _HostReadGuard:
    """While on, every host read of a tensor raises; `GraphedStep` calls
    run with it on and the optimizer's step with it off. Counts the guarded
    step calls by (graph key kind, masked)."""

    def __init__(self):
        self.on = False
        self.calls = {}
        self.trainers = []

    @contextlib.contextmanager
    def patched(self):
        saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}
        guard = self

        def trap(name):
            def method(t, *a, **k):
                if guard.on:
                    raise AssertionError(f"a host read inside a step: Tensor.{name}")
                return saved[name](t, *a, **k)
            return method

        call = GraphedStep.__call__

        def guarded_call(step, rows, mask=None):
            kind = next((k for tr in guard.trainers for k, g in tr._graphs.items()
                         if g is step), None)
            tag = f"{kind[0] if kind else 'new'}:{mask is not None}"
            self.calls[tag] = self.calls.get(tag, 0) + 1
            guard.on = True
            try:
                return call(step, rows, mask)
            finally:
                guard.on = False

        for n in HOST_READS:
            setattr(torch.Tensor, n, trap(n))
        GraphedStep.__call__ = guarded_call
        try:
            yield self
        finally:
            GraphedStep.__call__ = call
            for n, f in saved.items():
                setattr(torch.Tensor, n, f)

    def watch(self, tr):
        """Count `tr`'s steps, and run its optimizer unguarded."""
        self.trainers.append(tr)
        step = tr.opt.step

        def opt_step(*a, **k):
            was, self.on = self.on, False
            try:
                return step(*a, **k)
            finally:
                self.on = was

        tr.opt.step = opt_step


def _p1(cfg, ds, exp, sd=None, epochs=2, guard=None):
    tr = Trainer(cfg, ds, exp, device="cpu")
    if sd is not None:
        tr.net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    if guard is not None:
        guard.watch(tr)
    losses = []
    for _ in range(epochs):
        losses.append(tr.train_one_epoch())
        tr.epoch += 1
    valid, dumps = tr.eval_one_epoch("valid", ds["validation"], False, ("hidden", "rec_ob"))
    out = dict(losses=losses, valid=valid, state=_state(tr), graphs=sorted(map(str, tr._graphs)),
               dumps={k: np.concatenate(v) for k, v in dumps.items()})
    tr.close()
    return out


def _p3(cfg, ds, exp, sd=None, guard=None):
    tr = ClusterTrainer(cfg, ds, exp, device="cpu")
    if sd is not None:
        tr.net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    if guard is not None:
        guard.watch(tr)
    last = tr.train()
    out = dict(epoch=tr.epoch, deltas=list(tr.delta_history), last=last, state=_state(tr),
               graphs=sorted(map(str, tr._graphs)))
    tr.close()
    return out


def _cohort_arrays():
    rng = np.random.RandomState(3)
    return {"ob": rng.randn(N_ROWS, 3, 5).astype(np.float32),
            "mask": (rng.rand(N_ROWS, 3, 5) > 0.5).astype(np.float32),
            "label": rng.rand(N_ROWS).astype(np.float32)}


def _cohort_orders():
    rng = np.random.RandomState(4)
    return [rng.permutation(N_ROWS), rng.permutation(N_ROWS)]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


# ------------------------------------------------------------ the two ranks
def _relayouts():
    """(b): the storage after each relayout, and whether every plane kept
    its address."""
    c = ShardedCohort(_cohort_arrays(), B, torch.device("cpu"))
    ptrs = {k: v.data_ptr() for k, v in c.data3.items()}
    stages, kept = [{k: _np(v) for k, v in c.data3.items()}], []
    for tgt in [c.epoch_order(o) for o in _cohort_orders()] + [c.identity_order()]:
        c.ensure(tgt)
        stages.append({k: _np(v) for k, v in c.data3.items()})
        kept.append({k: v.data_ptr() for k, v in c.data3.items()} == ptrs)
    return dict(stages=stages, kept=kept)


def _block_at_steps(cohorts, root):
    """(c): one trainer's state is stepped by `steps.train_step` over each
    batch of an epoch as `block(k)` slices it, a second from the same seed
    goes through the captured step's reader (`block_at` of the block's
    number); the losses and the state after each step, bit for bit."""
    cfg = Config(**RANDOM)
    ds = _datasets(cfg, cohorts)
    stepped = Trainer(cfg, ds, os.path.join(root, "block"), device="cpu")
    indexed = Trainer(cfg, ds, os.path.join(root, "block_at"), device="cpu")
    assert stepped.shard_cohort and indexed.shard_cohort
    blocks = indexed.cohort_blocks("training")
    out = []
    for (k, mask), (k2, mask2) in zip(stepped._epoch_batches(1), indexed._epoch_batches(1)):
        at = torch.tensor([k2])
        same_rows = all(torch.equal(blocks.block_at(at)[n], v)
                        for n, v in blocks.block(k2).items())
        batch = stepped.cohort_blocks("training").block(k)
        if mask is not None:
            batch["sample_mask"] = mask
        want = torch.stack(list(train_step(stepped.net, stepped.opt, cfg, batch,
                                           stepped.generator, cfg.denoise).values()))
        got = indexed._train_graph(mask2 is not None)(at, mask2)["losses"]
        a, b = _state(stepped), _state(indexed)
        out.append(dict(rows=same_rows, losses=torch.equal(got, want), masked=mask is not None,
                        state=[n for n in a if not np.array_equal(a[n], b[n])]))
    stepped.close()
    indexed.close()
    return out


def _gloo_decisions(cohorts, root):
    """(e) at a real gloo group: `_can_fuse` refuses, and says so once;
    the epoch's steps are not captured."""
    lines = _Lines()
    log = logging.getLogger("dicl.torch")
    log.addHandler(lines)
    try:
        tr = Trainer(Config(**RANDOM), _datasets(Config(**RANDOM), cohorts),
                     os.path.join(root, "gloo"), device="cpu")
        decisions = [tr._can_fuse(tr.datasets["training"]), tr._can_fuse()]
        tr.train_one_epoch()
        tr.close()
    finally:
        log.removeHandler(lines)
    said = [x for x in lines.lines if "uncaptured" in x]
    return dict(decisions=decisions, said=said, graphs=[g.capture for g in tr._graphs.values()])


def _two_ranks(r, address, cohorts, root, det_sd, dec_sd):
    parallel.initialize(address, D, r, "cpu", "gloo", timeout_s=SPAWN_TIMEOUT_S)
    try:
        out = dict(relayouts=_relayouts(), gloo=_gloo_decisions(cohorts, root))
        with _fusable():
            out["block_at"] = _block_at_steps(cohorts, root)
            cfg, dcfg = Config(**RANDOM), Config(**RANDOM_DEC)
            guard = _HostReadGuard()
            runs = {}
            for fused in (True, False):
                tag = "fused" if fused else "uncaptured"
                ds, dds = _datasets(cfg, cohorts), _datasets(dcfg, cohorts)
                with guard.patched() if fused else contextlib.nullcontext():
                    runs[tag] = dict(
                        p1=_p1(cfg.replace(fused_epoch=fused), ds,
                               os.path.join(root, "p1_" + tag), guard=guard if fused else None),
                        p3=_p3(dcfg.replace(fused_epoch=fused), dds,
                               os.path.join(root, "p3_" + tag), guard=guard if fused else None))
            out["random"], out["guarded_calls"] = runs, dict(guard.calls)
            det = {}
            for fused in (True, False):
                tag = "fused" if fused else "uncaptured"
                cfg, dcfg = Config(**DET, fused_epoch=fused), Config(**DET_DEC, fused_epoch=fused)
                det[tag] = dict(
                    p1=_p1(cfg, _datasets(cfg, cohorts), os.path.join(root, "det_p1_" + tag),
                           det_sd),
                    p3=_p3(dcfg, _datasets(dcfg, cohorts), os.path.join(root, "det_p3_" + tag),
                           dec_sd))
            out["det"] = det
        return out
    finally:
        parallel.shutdown()


def _one_rank(r, address, cohorts, root):
    """(f): a one-rank gloo group, uncaptured (gloo) and through the fused
    path."""
    parallel.initialize(address, 1, r, "cpu", "gloo", timeout_s=SPAWN_TIMEOUT_S)
    try:
        out = {"uncaptured": _small_runs(cohorts, os.path.join(root, "g1_uncaptured"))}
        with _fusable():
            out["fused"] = _small_runs(cohorts, os.path.join(root, "g1_fused"))
        return out
    finally:
        parallel.shutdown()


def _small_runs(cohorts, root):
    cfg = Config(**RANDOM)
    dcfg = Config(**dict(RANDOM_DEC, max_epochs=3, eval_interval=1, pipeline_delta=False))
    return dict(p1=_p1(cfg, _datasets(cfg, cohorts), os.path.join(root, "p1")),
                p3=_p3(dcfg, _datasets(dcfg, cohorts), os.path.join(root, "p3")))


# ------------------------------------------------------------------ fixture
def _jax_runs(cohorts, root):
    """JAX's sharded fused trainers on `make_mesh(2)` from their seed's
    weights: p1 two epochs and an eval pass, p3 `DET_DEC`'s run. Returns
    those weights as port state dicts and what the runs gave."""
    copy = lambda d: {k: np.array(v, copy=True) for k, v in d.items()}  # noqa: E731
    jcfg = JConfig(**DET, max_epochs=3)
    jtr = JTrainer(jcfg, {c: JArrayDataset(jcfg, copy(d), c) for c, d in cohorts.items()},
                   os.path.join(root, "jax_p1"), mesh=make_mesh(D), use_tensorboard=False)
    assert jtr._shard_cohort and jcfg.fused_epoch
    sd = lambda t: {k: _np(v) for k, v in state_dict_from_jax(  # noqa: E731
        *jax.device_get((t.params, t.state))).items()}
    det_sd = sd(jtr)
    losses = []
    for _ in range(2):
        losses.append(jtr.train_one_epoch(jtr.datasets["training"], denoise=False))
        jtr.epoch += 1
    valid, dumps = jtr.eval_one_epoch("valid", jtr.datasets["validation"], denoise=False,
                                      dump_keys=("hidden", "rec_ob"))
    p1 = dict(losses=losses, valid=valid, state=sd(jtr),
              dumps={k: np.concatenate([np.asarray(x) for x in v]) for k, v in dumps.items()})
    dcfg = JConfig(**DET_DEC)
    jct = JClusterTrainer(dcfg, {c: JArrayDataset(dcfg, copy(d), c) for c, d in cohorts.items()},
                          os.path.join(root, "jax_p3"), mesh=make_mesh(D), use_tensorboard=False)
    dec_sd = sd(jct)
    jct.train()
    p3 = dict(epoch=jct.epoch, deltas=list(jct.delta_history), state=sd(jct))
    return det_sd, dec_sd, dict(p1=p1, p3=p3)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fused_dp"))
    cohorts = process_splits(make_synthetic_cohorts(n_total=80, max_obs=T, seed=9),
                             rng=np.random.RandomState(0))
    sizes = {"training": 2 * B + 5, "validation": B + 5}
    cohorts = {c: {k: v[:n] for k, v in cohorts[c].items()} for c, n in sizes.items()}
    det_sd, dec_sd, jax_runs = _jax_runs(cohorts, root)
    ranks = parallel.spawn(_two_ranks, D, (f"127.0.0.1:{parallel.free_port()}", cohorts,
                                           root, det_sd, dec_sd), timeout_s=SPAWN_TIMEOUT_S)
    one = parallel.spawn(_one_rank, 1, (f"127.0.0.1:{parallel.free_port()}", cohorts, root),
                         timeout_s=SPAWN_TIMEOUT_S)[0]
    return dict(root=root, cohorts=cohorts, ranks=ranks, one=one, jax=jax_runs)


def _same(a, b, what):
    """Two runs' outputs (nested dicts, lists, arrays, floats) bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


# -------------------------------------------------------------------- tests
def test_steps_read_nothing_to_the_host(run):
    """(a): every guarded kind of step ran, on both ranks, and none read."""
    for o in run["ranks"]:
        calls = o["guarded_calls"]
        for tag in ("train:False", "train:True", "eval:False", "eval:True"):
            assert calls.get(tag, 0) > 0, (tag, calls)
        assert "new:False" not in calls and "new:True" not in calls  # every call kept its key
        p3 = o["random"]["fused"]["p3"]
        assert any("train" in g for g in p3["graphs"]), p3["graphs"]


def test_relayout_is_in_place_and_equals_jax(run):
    """(b)."""
    jc = JShardedCohort(make_mesh(D), _cohort_arrays(), B)
    want = [jax.device_get(jc.data3)]
    for order in _cohort_orders():
        jc.ensure(jc.epoch_order(order))
        want.append(jax.device_get(jc.data3))
    jc.ensure(jc.identity_order())
    want.append(jax.device_get(jc.data3))
    pb = B // D
    for r, o in enumerate(run["ranks"]):
        got = o["relayouts"]
        assert got["kept"] == [True] * 3
        assert len(got["stages"]) == len(want)
        for i, (g, w) in enumerate(zip(got["stages"], want)):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], np.asarray(w[k])[:, r * pb:(r + 1) * pb],
                                              err_msg=f"rank {r} stage {i} {k}")


def test_block_indexed_step_is_the_block_step(run):
    """(c): three batches, the last the masked tail."""
    for o in run["ranks"]:
        steps = o["block_at"]
        assert [s["masked"] for s in steps] == [False, False, True]
        for s in steps:
            assert s["rows"] and s["losses"] and not s["state"], s


@pytest.mark.parametrize("stage", ["p1", "p3"])
def test_fused_ranks_have_the_stepped_bits(run, stage):
    """(d), with random draws: fused against uncaptured at two ranks, both
    through the one body's steps, and the two ranks alike."""
    for o in run["ranks"]:
        fused, uncaptured = o["random"]["fused"][stage], o["random"]["uncaptured"][stage]
        assert fused["graphs"] and fused["graphs"] == uncaptured["graphs"]
        _same(fused, uncaptured, stage)
        det = o["det"]
        _same(det["fused"][stage], det["uncaptured"][stage], "det " + stage)
    a, b = run["ranks"]
    _same(a["random"]["fused"][stage]["state"], b["random"]["fused"][stage]["state"], "ranks")
    if stage == "p3":
        assert a["random"]["fused"]["p3"]["epoch"] == 5  # past the last, epoch 4
        assert len(a["random"]["fused"]["p3"]["deltas"]) == 4


def test_fused_ranks_p1_within_the_jax_band(run):
    """(d): p1 at two ranks, fused, against JAX's sharded fused trainer."""
    want = run["jax"]["p1"]
    for o in run["ranks"]:
        got = o["det"]["fused"]["p1"]
        for g, w in zip(got["losses"], want["losses"]):
            for k in w:
                assert abs(g[k] - float(w[k])) < 1e-5, k
        _params_band(_params(got["state"]), _params(want["state"]), "p1 vs jax")
        _running_band(got["state"], want["state"])
        assert abs(got["valid"]["ae_mse"] - float(want["valid"]["ae_mse"])) < 5e-4
        np.testing.assert_allclose(got["dumps"]["hidden"], want["dumps"]["hidden"], atol=1e-4)
        np.testing.assert_array_equal(got["dumps"]["__index__"], want["dumps"]["__index__"])


def test_fused_ranks_p3_within_the_jax_band(run):
    """(d): p3 under `eval_interval` 3 and `pipeline_delta` at two ranks,
    fused, against JAX's sharded fused DEC trainer: the epochs, the label
    deltas and the weights."""
    want = run["jax"]["p3"]
    for o in run["ranks"]:
        got = o["det"]["fused"]["p3"]
        assert got["epoch"] == want["epoch"] == 5  # past the last, epoch 4
        assert got["deltas"] == want["deltas"] and len(want["deltas"]) == 4
        _params_band(_params(got["state"]), _params(want["state"]), "p3 vs jax")
        _running_band(got["state"], want["state"])


def test_can_fuse_decisions(run, tmp_path, monkeypatch):
    """(e): the real gloo group of the spawn was not deferred, captured
    nothing and said so once; here no group and a NCCL group defer, and a
    NCCL group with blocking waits does not."""
    for o in run["ranks"]:
        gloo = o["gloo"]
        assert gloo["decisions"] == [False, False] and gloo["graphs"] == [False, False]
        assert len(gloo["said"]) == 1 and "gloo group of 2 ranks" in gloo["said"][0]
    cfg = Config(**RANDOM)
    tr = Trainer(cfg, _datasets(cfg, run["cohorts"]), str(tmp_path), device="cpu")
    assert tr._can_fuse(tr.datasets["training"]) and tr._can_fuse()
    monkeypatch.setattr(mesh, "grouped", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "nccl")
    monkeypatch.delenv("TORCH_NCCL_BLOCKING_WAIT", raising=False)
    monkeypatch.delenv("NCCL_BLOCKING_WAIT", raising=False)
    assert parallel.capturable() and tr._can_fuse(tr.datasets["training"]) and tr._can_fuse()
    monkeypatch.setenv("TORCH_NCCL_BLOCKING_WAIT", "1")
    assert not parallel.capturable() and not tr._can_fuse()
    monkeypatch.delenv("TORCH_NCCL_BLOCKING_WAIT")
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "gloo")
    assert not parallel.capturable() and not tr._can_fuse(tr.datasets["training"])
    assert not tr._can_fuse(ArrayDataset(cfg, {k: v[:B - 1] for k, v in
                                               run["cohorts"]["training"].items()}, "training"))
    tr.close()


def test_one_rank_gloo_group_is_no_group(run, tmp_path):
    """(f): its collectives run, and the bits are those of no group."""
    alone = _small_runs(run["cohorts"], str(tmp_path))
    assert alone["p1"]["graphs"] and alone["p3"]["graphs"]
    one = run["one"]
    assert one["fused"]["p1"]["graphs"] and one["uncaptured"]["p1"]["graphs"] == \
        one["fused"]["p1"]["graphs"]
    for how in ("uncaptured", "fused"):
        for stage in ("p1", "p3"):
            _same({k: v for k, v in one[how][stage].items() if k != "graphs"},
                  {k: v for k, v in alone[stage].items() if k != "graphs"}, f"{how} {stage}")
