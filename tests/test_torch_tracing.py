"""The port's tracer (`utils/tracing.py`) on the CPU: off, it records and
allocates nothing; on, spans nest with parent and root ids, self times add
up to the root and counters add; two epochs of the toy `Trainer` (B=8,
T=24) and of the toy `ClusterTrainer` give the span tree of the trainers'
layers, with `train.steps`, `host_reads`, `kmeans.rounds` and
`checkpoint.writes` pinned exactly (counted at their call sites on the CPU
as on the card); the collectives of `parallel.mesh` are counted where they
are issued; a `train()` call under a profiler, with the tracer off,
traces itself and keeps its report for `take()`; and the tracer moves no
bit of the losses, the parameters or the checkpoints. Imports neither JAX nor the JAX package.

On the CPU a `GraphedStep` calls its step directly: there is no capture,
so the tree has no `capture` span (`test_torch_tracing_gpu.py` holds it
on the card).
"""

import itertools
import json
import os
import tracemalloc

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu_torch import Config, parallel
from deep_interpolation_clustering_tpu_torch.compat.jax_params import OPT_VECTORS
from deep_interpolation_clustering_tpu_torch.data import (
    ArrayDataset,
    make_synthetic_cohorts,
    process_splits,
)
from deep_interpolation_clustering_tpu_torch.train import ClusterTrainer, Trainer
from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt
from deep_interpolation_clustering_tpu_torch.utils import profiling, tracing

torch.set_num_threads(1)

SMALL = dict(batch_size=8, num_timestamps=24, lstm_hidden=16, head_hidden=16, dropout=0.0,
             log_train_freq=1000, log_valid_freq=1000)
DEC = dict(loss="ae_mse_sup_fake_detect_kl", cluster_number=3, kmeans_n_init=3)


@pytest.fixture(autouse=True)
def _off():
    tracing.disable()
    yield
    tracing.disable()


def _datasets(cfg):
    cohorts = process_splits(make_synthetic_cohorts(n_total=61, max_obs=cfg.num_timestamps,
                                                    seed=5), rng=np.random.RandomState(0))
    return {k: ArrayDataset(cfg, cohorts[k], k) for k in ("training", "validation")}


def _tree(report):
    """The spans as nested (name, [children]) in the order they began."""
    kids = {}
    for s in report["spans"]:
        kids.setdefault(s["parent"], []).append(s)

    def build(parent):
        return [(s["name"], build(s["id"])) for s in kids.get(parent, [])]
    return build(None)


def _peak(fn) -> int:
    fn()  # warm: any one-time allocation happens here
    tracemalloc.start()
    try:
        fn()
        tracemalloc.reset_peak()
        start = tracemalloc.get_traced_memory()[0]
        fn()
        return tracemalloc.get_traced_memory()[1] - start
    finally:
        tracemalloc.stop()


def test_off_records_nothing_and_hands_back_one_null_context():
    assert not tracing.enabled()
    assert tracing.span("eval") is tracing.NULL
    assert tracing.span("epoch", epoch=3) is tracing.span("train") is tracing.NULL
    with tracing.span("eval") as inside:
        tracing.count("host_reads")
    assert inside is None
    assert tracing.report() == {} and tracing.counter("host_reads") == 0
    repeat = lambda: itertools.repeat(None, 5000)  # noqa: E731

    def nulls():
        for _ in repeat():
            with tracing.NULL:
                pass

    def spans():
        for _ in repeat():
            with tracing.span("eval"):
                pass
            with tracing.span("epoch", epoch=7):
                pass

    def loop():
        for _ in repeat():
            pass

    def counts():
        for _ in repeat():
            tracing.count("host_reads")
            tracing.count("train.steps", 17)

    # 10,000 spans and counts allocate no more than the bare loops around them
    assert _peak(spans) <= _peak(nulls)
    assert _peak(counts) <= _peak(loop)


def test_spans_nest_self_times_add_up_and_counters_add():
    tracing.enable()
    with tracing.span("train"):
        with tracing.span("epoch", epoch=1):
            with tracing.span("train_epoch"):
                tracing.count("train.steps", 5)
            with tracing.span("eval", scope="valid"):
                tracing.count("host_reads")
        tracing.count("host_reads", 2)
    with tracing.span("train"):
        tracing.count("train.steps", 5)
    out = tracing.report()
    assert tracing.counter("train.steps") == 10
    tracing.disable()
    by_id = {s["id"]: s for s in out["spans"]}
    assert [s["name"] for s in out["spans"]] == ["train", "epoch", "train_epoch", "eval",
                                                 "train"]
    train, epoch, tep, ev, train2 = out["spans"]
    assert train["parent"] is None and epoch["parent"] == train["id"]
    assert tep["parent"] == ev["parent"] == epoch["id"]
    assert {s["root"] for s in (train, epoch, tep, ev)} == {train["id"]}
    assert train2["root"] == train2["id"] and train2["parent"] is None
    assert epoch["attrs"] == {"epoch": 1} and ev["attrs"] == {"scope": "valid"}
    assert all(s["device_ms"] is None for s in out["spans"]) and out["gaps"] == []
    for s in out["spans"]:
        assert s["host_ms"][0] <= s["host_ms"][1]
        parent = by_id.get(s["parent"])
        if parent is not None:
            assert parent["host_ms"][0] <= s["host_ms"][0] <= s["host_ms"][1] \
                <= parent["host_ms"][1]
    # each span's self time is its duration less its children's: the self
    # times of one root's spans add up to the root's duration
    whole = train["host_ms"][1] - train["host_ms"][0]
    selves = sum(s["self_ms"] for s in out["spans"] if s["root"] == train["id"])
    assert selves == pytest.approx(whole, rel=1e-9, abs=1e-9)
    assert min(s["self_ms"] for s in out["spans"]) >= 0.0
    assert out["counters"] == {"train.steps": 10, "host_reads": 3}
    assert out["by_name"]["train"]["calls"] == 2 and out["events"] == 0
    assert tracing.report() == {} and tracing.counter("train.steps") == 0


def _p1_epoch(checkpoint: bool, summaries: int = 2):
    out = [("train_epoch", [("train_epoch.plan", []), ("train_epoch.replay", [])]),
           ("fetch", [("summary", [])] * summaries),
           ("eval", [("eval.replay", []), ("eval.fetch", [])])]
    if checkpoint:
        out.append(("checkpoint", [("checkpoint.copy", []), ("checkpoint.write", [])]))
    return out + [("summary", [])]


def _eval():
    return ("eval", [("eval.replay", []), ("eval.fetch", [])])


def _checkpoint_reads(trainer) -> int:
    """What a checkpoint reads to the host: every state tensor the file
    holds (the parameters and BatchNorm moments: not the batch counts), the
    rate, each Adam step count and each moment tensor."""
    params = list(trainer.net.parameters())
    moments = sum(1 for p in params for k in OPT_VECTORS["Adam"] if k in trainer.opt.state[p])
    state = [k for k in trainer.net.state_dict() if not k.endswith("num_batches_tracked")]
    return len(state) + 1 + len(params) + moments


def test_two_p1_epochs_give_the_span_tree_and_pinned_counts(tmp_path):
    cfg = Config(**SMALL, max_epochs=3)
    ds = _datasets(cfg)
    tr = Trainer(cfg, ds, str(tmp_path / "p1"), device="cpu")
    tracing.enable("cpu")
    tr.train()
    out = tracing.report()
    tr.close()
    epochs = [("epoch", _p1_epoch(True)), ("epoch", _p1_epoch(True))]
    assert _tree(out) == [("train", epochs)]
    assert [s["attrs"] for s in out["spans"] if s["name"] == "epoch"] == [{"epoch": 1},
                                                                        {"epoch": 2}]
    n_batches = ds["training"].num_batches(cfg.batch_size)
    c = out["counters"]
    assert n_batches == 6 and c["train.steps"] == 2 * n_batches == 12
    assert c["eval.batches"] == 2 * ds["validation"].num_batches(cfg.batch_size) == 4
    assert c["checkpoint.writes"] == 4
    # an epoch: the loss table, the eval's table and each of its 3 dumps,
    # and the checkpoint's tensors (43 state tensors, the rate, 37 step
    # counts, 3 x 37 moments)
    assert _checkpoint_reads(tr) == 43 + 1 + 37 + 3 * 37 == 192
    assert c["host_reads"] == 2 * (1 + 1 + 3 + 192) == 394
    assert c["checkpoint.bytes"] > 0 and "graph.replays" not in c
    # the loop's own code is each epoch's self time: nothing unnamed at the root
    root = out["spans"][0]
    assert root["self_ms"] < 0.05 * (root["host_ms"][1] - root["host_ms"][0])


def test_a_profiled_call_traces_itself_and_keeps_its_report(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    assert tracing.call("cpu") is tracing.NULL and tracing.take() is None
    cfg = Config(**SMALL, max_epochs=3)
    tr = Trainer(cfg, _datasets(cfg), str(tmp_path / "p1"), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train()
    assert not tracing.enabled()
    out = tracing.take()
    assert tracing.take() is None  # handed over once
    epochs = [("epoch", _p1_epoch(True)), ("epoch", _p1_epoch(True))]
    assert _tree(out) == [("train", epochs)]
    assert out["counters"]["host_reads"] == 394 and out["counters"]["train.steps"] == 12
    names = {e.name for e in prof.events()}
    assert {tracing.PREFIX + n for n in out["by_name"]} <= names
    # unprofiled, or inside the caller's own recording, a call keeps nothing
    tr.cfg.max_epochs = tr.epoch + 1
    tr.train()
    tracing.enable("cpu")
    tr.cfg.max_epochs = tr.epoch + 1
    with profile(activities=[ProfilerActivity.CPU]):
        tr.train()
    tr.close()
    assert tracing.take() is None and tracing.enabled()
    assert [s["name"] for s in tracing.report()["spans"] if s["parent"] is None] == ["train"]


def test_two_dec_epochs_give_the_span_tree_and_pinned_counts(tmp_path):
    cfg = Config(**SMALL, max_epochs=2)
    ds = _datasets(cfg)
    pre = Trainer(cfg, ds, str(tmp_path / "p1"), device="cpu")
    pre.train()  # the p1 checkpoint that the centre init restores
    pre.close()
    dcfg = Config(**SMALL, **DEC, max_epochs=3)
    tr = ClusterTrainer(dcfg, ds, str(tmp_path / "p3"), pretrain_exp_path=str(tmp_path / "p1"),
                        device="cpu")
    tracing.enable()
    tr.train()
    out = tracing.report()
    tr.close()
    init = ("init", [("init.restore", []), _eval(), ("init.kmeans", []), _eval(),
                     ("init.predict", [])])
    epoch = [e for e in _p1_epoch(True) if e[0] != "eval"]
    epoch[2:2] = [("delta", [_eval()]), ("delta", [])]
    assert _tree(out) == [("train", [init, ("epoch", epoch), ("epoch", epoch)])]
    c = out["counters"]
    assert c["train.steps"] == 12 and c["eval.batches"] == 6 + 2 + 2 + 2
    assert c["kmeans.rounds"] == 5 and c["checkpoint.writes"] == 6
    reads = _checkpoint_reads(tr)
    assert reads == 44 + 1 + 38 + 3 * 38 == 197  # the centres: one more parameter
    # init: the live state read for the partial restore (44 tensors), the
    # two eval passes' loss tables, a k-means flag read a round and the one
    # that ends the loop; an epoch: the loss table, the label pass's loss
    # table, the count, and the checkpoint
    assert c["host_reads"] == 44 + 2 + (5 + 1) + 2 * (1 + 1 + 1 + reads) == 452


@pytest.mark.parametrize("job", ["p1", "p3"])
def test_the_tracer_moves_no_bit(tmp_path, job):
    cfg = Config(**SMALL, max_epochs=3)
    ds = _datasets(cfg)
    if job == "p3":
        pre = Trainer(cfg, ds, str(tmp_path / "p1"), device="cpu")
        pre.train()
        pre.close()

    def run(name, on):
        if on:
            tracing.enable("cpu")
        if job == "p1":
            tr = Trainer(cfg, ds, str(tmp_path / name), device="cpu")
        else:
            tr = ClusterTrainer(cfg.replace(**DEC), ds, str(tmp_path / name),
                                pretrain_exp_path=str(tmp_path / "p1"), device="cpu")
        tr.train()
        tracing.disable()
        state = {k: v.clone() for k, v in tr.net.state_dict().items()}
        opt = [v.clone() for p in tr.net.parameters() for _, v in sorted(tr.opt.state[p].items())]
        tr.close()
        with open(tmp_path / name / "summary" / "events.jsonl") as f:
            rows = [json.loads(line) for line in f]
        files = {}
        for m, d in tr.weight_paths.items():
            path = os.path.join(d, ckpt.CKPT_NAME)
            if os.path.exists(path):
                with np.load(path) as z:
                    files[m] = {k: z[k] for k in z.files}
        return state, opt, rows, files

    on, off = run("on", True), run("off", False)
    assert on[0].keys() == off[0].keys()
    assert all(torch.equal(on[0][k], off[0][k]) for k in on[0])
    assert len(on[1]) == len(off[1]) and all(torch.equal(a, b) for a, b in zip(on[1], off[1]))
    assert on[2] == off[2] and on[2]
    assert on[3].keys() == off[3].keys() and on[3]
    for m in on[3]:
        assert on[3][m].keys() == off[3][m].keys()
        for k in on[3][m]:
            np.testing.assert_array_equal(on[3][m][k], off[3][m][k], err_msg=f"{m} {k}")


def test_collectives_are_counted_where_they_are_issued():
    parallel.initialize(f"127.0.0.1:{parallel.free_port()}", 1, 0, "cpu", "gloo")
    try:
        a, b = torch.ones(3), torch.zeros(2)
        with profiling.collective_calls() as calls:
            assert tracing.enabled()
            parallel.all_sum(a)
            during = dict(calls)
            parallel.broadcast_([a, b])
        assert not tracing.enabled()
        assert during == {"eager": 1, "captured": 0}
        assert dict(calls) == {"eager": 3, "captured": 0}
        # inside a recording that is already on: counted against its start,
        # and the recording stays on
        tracing.enable()
        parallel.all_sum(a)
        with profiling.collective_calls() as calls:
            parallel.all_sum_grads_([torch.nn.Parameter(torch.ones(2))])  # no gradient: none
            parallel.all_max(a)
        assert tracing.enabled() and dict(calls) == {"eager": 1, "captured": 0}
        assert tracing.counter("collective.eager") == 2
    finally:
        parallel.shutdown()
    parallel.all_sum(a)  # no group: no collective
    assert tracing.counter("collective.eager") == 2
