"""The fused epoch on the card: epochs replayed from captured CUDA graphs
against the same epochs uncaptured, bit for bit. They need a CUDA card
and `nvcc`, so they skip elsewhere; they import neither JAX nor this
directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fused_gpu.py

Two trainers from one seed on one cohort: one replays the graphs
(`Trainer._dispatch_fused_epoch`), the other, under `fused_epoch=False`,
steps uncaptured (`Trainer.step` over `_epoch_batches`), two epochs each
with another rate for the second (the graph reads the rate tensor written
in place). Equal: the per-batch losses, the parameters, the BatchNorm
buffers, the optimizer state, the generator's state (each replay advances
Philox as the eager step does), and the hand-kernel launches of an epoch;
then a replayed eval pass's metrics and dumps against the uncaptured one's,
the same body. At the default Config (B=256, T=354) with and without a
masked tail, at the scaled configuration (B=4096, T=48, with its tail) and
under `compute_dtype="bfloat16"`.

The card's optimizer (`make_optimizer` on CUDA parameters: a tensor rate;
Adam capturable on float64 step counts, SGD fused, RMSprop capturable)
against the CPU's (torch's default
optimizers, a float rate) from the same parameters and gradients, four
steps with the rate changed by `set_learning_rate` before the third:
parameters and state within 1e-6 of the largest value after every step.

A one-rank NCCL group (`--data_parallel 1`: its collectives run, and are
captured in the graphs): p1 (two epochs and a validation pass) and p3 (DEC
under `eval_interval` 3 and `pipeline_delta`) fused, with the bits of the
same runs without a group and of the group's uncaptured runs
(`fused_epoch=False`); the epoch log lines say "(fused)" where the steps
were replayed; the collectives an uncaptured step issues are issued once
more while its graph is captured and never by a replay; the NCCL kernels
the profiler sees in a replay are those of an uncaptured step (none at one
rank: NCCL runs no kernel for an in-place sum over one rank), and the hand
kernels of a replay are the launches counted at capture.
"""

import logging

import tempfile

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu_torch import Config, parallel
from deep_interpolation_clustering_tpu_torch.data import (
    ArrayDataset,
    make_synthetic_cohorts,
    process_splits,
)
from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
from deep_interpolation_clustering_tpu_torch.train import ClusterTrainer, Trainer
from deep_interpolation_clustering_tpu_torch.train.optim import make_optimizer, set_learning_rate
from deep_interpolation_clustering_tpu_torch.utils import profiling, resolve_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the hand-written kernels")
    return resolve_device("cuda")  # TF32 off


def _datasets(cfg, n_train, n_valid, seed=11):
    n_total = n_train + n_valid
    share = (n_train + 0.5) / n_total  # int(share * n_total) = n_train
    cohorts = process_splits(
        make_synthetic_cohorts(n_total=n_total, max_obs=cfg.num_timestamps, seed=seed,
                               split=(share, 1.0 - share, 0.0)),
        rng=np.random.RandomState(0))
    ds = {k: ArrayDataset(cfg, cohorts[k], k) for k in ("training", "validation")}
    assert len(ds["training"]) == n_train
    return ds


def _launches():
    return {w.name: w.launches for w in cb.KERNELS}


def _state(tr):
    out = dict(tr.net.state_dict())
    for i, p in enumerate(tr.net.parameters()):
        out.update({f"opt.{i}.{k}": v for k, v in tr.opt.state[p].items()})
    return out


@pytest.mark.parametrize("width,n_train,dtype", [
    ("default", 2 * 256 + 60, "float32"),
    ("default", 2 * 256, "float32"),
    ("scaled", 2 * 4096 + 368, "float32"),
    ("default", 2 * 256 + 60, "bfloat16"),
    ("scaled", 2 * 4096 + 368, "bfloat16"),
], ids=["default_tail", "default_no_tail", "scaled_tail", "default_bf16", "scaled_bf16"])
def test_graph_epochs_equal_stepped_epochs(dev, width, n_train, dtype):
    cfg = Config(compute_dtype=dtype)
    if width == "scaled":
        cfg = cfg.replace(batch_size=4096, num_timestamps=48)
    ds = _datasets(cfg, n_train, 300)
    fused = Trainer(cfg, ds, tempfile.mkdtemp(), device=dev)
    stepped = Trainer(cfg.replace(fused_epoch=False), ds, tempfile.mkdtemp(), device=dev)
    n_batches = ds["training"].num_batches(cfg.batch_size)
    for epoch, lr in ((1, cfg.init_lr), (2, 1e-3)):
        for tr in (fused, stepped):
            set_learning_rate(tr.opt, lr)
        cb.reset_launch_counts()
        table, keys = fused._dispatch_fused_epoch()
        torch.cuda.synchronize()
        fused_launches = _launches()
        cb.reset_launch_counts()
        losses = [stepped.step(*b) for b in stepped._epoch_batches(stepped.epoch)]
        torch.cuda.synchronize()
        stepped_launches = _launches()
        if epoch == 2:  # the first epoch's count has the graphs' warm-up too
            assert fused_launches == stepped_launches
        # every kernel of the IPN's step, which has neither the other select
        # nor mTAN's attention pair
        assert all(n > 0 for k, n in stepped_launches.items()
                   if k != ("fake_select" if cfg.num_timestamps <= 192 else
                            "fake_select_packed") and not k.startswith("mtan_"))
        want = torch.stack([torch.stack([l[k] for k in keys]) for l in losses])
        assert table.shape == (n_batches, len(keys))
        assert torch.equal(table, want), float((table - want).abs().max())
        for tr in (fused, stepped):
            tr.epoch += 1
    got, want = _state(fused), _state(stepped)
    assert got.keys() == want.keys()
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    assert not differ, differ
    assert torch.equal(fused.generator.get_state(), stepped.generator.get_state())
    assert fused.num_updates == stepped.num_updates == 2 * n_batches
    # an eval pass: replayed against uncaptured, the dumps fetched
    valid = ds["validation"]
    m_fused, d_fused = fused.eval_one_epoch("valid", valid, False)
    m_stepped, d_stepped = stepped.eval_one_epoch("valid", valid, False)
    assert all(g.graph is not None for g in fused._graphs.values())
    assert stepped._graphs and all(g.graph is None for g in stepped._graphs.values())
    assert m_fused == m_stepped
    assert set(d_fused) == set(d_stepped)
    for k in d_stepped:
        assert np.array_equal(d_fused[k][0], d_stepped[k][0]), k
    assert torch.equal(fused.generator.get_state(), stepped.generator.get_state())
    for tr in (fused, stepped):
        tr.close()


@pytest.mark.parametrize("start", ["random", "zero"])
@pytest.mark.parametrize("optimizer", ["adam", "sgd", "rmsprop"])
def test_card_optimizer_steps_as_the_cpu_one(dev, optimizer, start):
    """From zero parameters the first step's parameters are the update
    itself, so a bias correction taken in float32 (the capturable Adam's
    1 - 0.999^t on float32 step counts, which makes every step 6.4e-6 too
    long) fails the 1e-6 bound."""
    cfg = Config(optimizer=optimizer)
    g = torch.Generator().manual_seed(0)
    shapes = [(512, 128), (128,), (6, 354)]
    init = [torch.zeros(s) if start == "zero" else torch.randn(s, generator=g) * 0.1
            for s in shapes]
    card = [torch.nn.Parameter(t.to(dev)) for t in init]
    cpu = [torch.nn.Parameter(t.clone()) for t in init]
    opt_card, opt_cpu = make_optimizer(cfg, card), make_optimizer(cfg, cpu)
    assert isinstance(opt_card.param_groups[0]["lr"], torch.Tensor)
    for step in range(4):
        if step == 2:
            for opt in (opt_card, opt_cpu):
                set_learning_rate(opt, cfg.init_lr / 7)
        for pc, pg in zip(cpu, card):
            pc.grad = torch.randn(pc.shape, generator=g)
            pg.grad = pc.grad.to(dev)
        opt_card.step()
        opt_cpu.step()
        for i, (pc, pg) in enumerate(zip(cpu, card)):
            pairs = [("param", pg.detach(), pc.detach())]
            pairs += [(k, opt_card.state[pg][k], v) for k, v in opt_cpu.state[pc].items()]
            for k, got, want in pairs:
                # compared in float64: the card's Adam counts its steps in it
                got, want = got.detach().cpu().double(), want.detach().double()
                tol = 1e-6 * float(want.abs().max())
                torch.testing.assert_close(got, want, rtol=1e-6, atol=tol,
                                           msg=lambda m: f"step {step} tensor {i} {k}: {m}")


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _runs(dev, ds, cfg, dcfg):
    """p1 (two epochs, a validation pass) and p3 from `dcfg`: their losses,
    metrics, dumps, final state and epoch log lines."""
    lines = _Lines()
    logging.getLogger("dicl.torch").addHandler(lines)
    try:
        tr = Trainer(cfg, ds, tempfile.mkdtemp(), device=dev)
        losses = []
        for _ in range(2):
            losses.append(tr.train_one_epoch())
            tr.epoch += 1
        metrics, dumps = tr.eval_one_epoch("valid", ds["validation"], False)
        p1 = dict(losses=losses, metrics=metrics, state=_state(tr),
                  dumps={k: v[0] for k, v in dumps.items()})
        tr.close()
        ct = ClusterTrainer(dcfg, ds, tempfile.mkdtemp(), device=dev)
        last = ct.train()
        p3 = dict(last=last, deltas=ct.delta_history, epoch=ct.epoch, state=_state(ct))
        ct.close()
    finally:
        logging.getLogger("dicl.torch").removeHandler(lines)
    return dict(p1=p1, p3=p3, lines=lines.lines)


def _differ(a, b, what=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        return [d for k in a for d in _differ(a[k], b[k], f"{what}/{k}")]
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _differ(x, y, f"{what}/{i}")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [what]
    if isinstance(a, np.ndarray):
        return [] if np.array_equal(a, b) else [what]
    return [] if a == b else [what]


def test_one_rank_nccl_group_fuses_with_the_bits_of_no_group(dev):
    cfg = Config(log_train_freq=1000, log_valid_freq=1000)
    dcfg = cfg.replace(loss="ae_mse_sup_fake_detect_kl", init_cluster_center="none",
                       stopping_delta=None, eval_interval=3, pipeline_delta=True, max_epochs=5)
    ds = _datasets(cfg, 2 * 256 + 60, 300)
    alone = _runs(dev, ds, cfg, dcfg)
    parallel.initialize(f"127.0.0.1:{parallel.free_port()}", 1, 0, "cuda", "nccl")
    try:
        assert parallel.grouped() and parallel.capturable()
        fused = _runs(dev, ds, cfg, dcfg)
        uncaptured = _runs(dev, ds, cfg.replace(fused_epoch=False),
                           dcfg.replace(fused_epoch=False))
        # collectives and kernels of an uncaptured step and of a replay
        tr = Trainer(cfg, ds, tempfile.mkdtemp(), device=dev)
        tr.train_steps(2)
        stream = tr._stream()
        step = lambda: tr.step(*next(stream))  # noqa: E731
        with profiling.collective_calls() as calls:
            step()
            torch.cuda.synchronize()
        per_step = dict(calls)
        replay = profiling.graphed_step(tr)
        with profiling.collective_calls() as calls:
            replay()  # warm-up, capture and a replay
            at_capture = dict(calls)
            replay()
            torch.cuda.synchronize()
        replayed = calls["eager"] + calls["captured"] - sum(at_capture.values())
        prof_step = profiling.device_profile(step, 3)
        prof_replay = profiling.device_profile(replay, 5)
        launches = tr._graphs[("train", False)].launches
        tr.close()
    finally:
        parallel.shutdown()
    for name, run in (("fused", fused), ("uncaptured", uncaptured)):
        for stage in ("p1", "p3"):
            differ = _differ(run[stage], alone[stage], f"{name} {stage}")
            assert not differ, differ[:8]
    # p1's two epochs replayed, p3's four dispatched and fetched at its evals
    epochs = {k: [x for x in run["lines"] if " trained in " in x]
              for k, run in (("fused", fused), ("uncaptured", uncaptured))}
    assert len(epochs["fused"]) == 2 and all(x.endswith("(fused)") for x in epochs["fused"])
    assert any("fetched (deferred, eval_interval 3)" in x for x in fused["lines"])
    assert len(epochs["uncaptured"]) == 6 and not any("(fused)" in x
                                                      for x in epochs["uncaptured"])
    assert per_step["eager"] > 0 and per_step["captured"] == 0
    assert at_capture["captured"] == per_step["eager"] and replayed == 0
    assert prof_replay["nccl_kernels_per_step"] == prof_step["nccl_kernels_per_step"]
    hand = lambda prof: {h["name"]: h["calls_per_step"]  # noqa: E731
                          for h in prof["hand_kernels"]}
    assert hand(prof_replay) == hand(prof_step) and hand(prof_step)
    assert set(launches) == {"fake_select", "sci_forward", "sci_backward", "rbf_push",
                             "lstm_forward", "lstm_backward", "clip_adam"}
