"""The tracer (`utils/tracing.py`) on the card. They need a CUDA card and
`nvcc`, so they skip elsewhere; they import neither JAX nor this
directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_tracing_gpu.py

  * A traced `train()` call of a trainer whose graphs were captured with
    the tracer off: its spans appear as `dicl.` ranges in a
    `torch.profiler` trace taken over it, every span has a device interval,
    none begins on the card before its host span began, and a span that
    ends in a host read ends on the card before it ends on the host.
  * Spans that end in a synchronise lie on the card inside their host
    spans.
  * A span opened while a stream is being captured records no event.
  * Graphs captured with the tracer on count their replays on the card:
    `graph.replays_unrun` is 0, `graph.replays` the host's count, and each
    capture is a `capture` span; graphs captured with it off carry no
    counter.
"""

import tempfile

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.data import (
    ArrayDataset,
    make_synthetic_cohorts,
    process_splits,
)
from deep_interpolation_clustering_tpu_torch.train import Trainer
from deep_interpolation_clustering_tpu_torch.utils import resolve_device, tracing

pytestmark = pytest.mark.gpu

# the card's clock against the host's: the anchor's host time is the middle
# of its record and its synchronise
TOL_MS = 0.05


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the hand-written kernels")
    tracing.disable()
    yield resolve_device("cuda")  # TF32 off
    tracing.disable()


def _trainer(dev, eval_interval=1):
    cfg = Config(batch_size=64, num_timestamps=48, log_train_freq=1000, log_valid_freq=1000,
                 eval_interval=eval_interval, max_epochs=2)
    cohorts = process_splits(make_synthetic_cohorts(n_total=300, max_obs=cfg.num_timestamps,
                                                    seed=11), rng=np.random.RandomState(0))
    ds = {k: ArrayDataset(cfg, cohorts[k], k) for k in ("training", "validation")}
    return Trainer(cfg, ds, tempfile.mkdtemp(), device=dev)


def test_a_traced_call_is_in_the_device_trace_on_one_clock(dev):
    from torch.profiler import ProfilerActivity, profile

    tr = _trainer(dev)
    tr.train()  # the graphs captured, the tracer off
    assert tr._graphs and all(g.device_replays is None for g in tr._graphs.values())
    tr.cfg.max_epochs = tr.epoch + 2
    tracing.enable(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.train()
        torch.cuda.synchronize()
    out = tracing.report()
    tracing.disable()
    tr.close()
    names = {e.name for e in prof.events()}
    assert {"train", "epoch", "train_epoch", "train_epoch.plan", "train_epoch.replay", "fetch",
            "eval", "eval.replay", "eval.fetch", "summary"} <= set(out["by_name"])
    for name in out["by_name"]:  # a checkpoint's too, where a metric improved
        assert tracing.PREFIX + name in names, name
    assert "capture" not in out["by_name"] and "graph.replays_unrun" not in out["counters"]
    assert out["counters"]["graph.replays"] > 0
    assert out["events"] == 2 * len(out["spans"])
    for s in out["spans"]:
        (h0, h1), (d0, d1) = s["host_ms"], s["device_ms"]
        assert h0 - TOL_MS <= d0 <= d1, s
        if s["name"] in ("fetch", "eval.fetch", "train"):  # a host read ends them
            assert d1 <= h1 + TOL_MS, s
    steps = out["counters"]["train.steps"]
    step_ms = sum(s["device_ms"][1] - s["device_ms"][0] for s in out["spans"]
                  if s["name"] == "train_epoch") / steps
    assert 0.0 < step_ms


def test_spans_that_end_in_a_synchronise_lie_inside_their_host_spans(dev):
    a = torch.randn(1024, 1024, device=dev)
    tracing.enable(dev)
    for _ in range(5):
        with tracing.span("work"):
            for _ in range(20):
                a = torch.tanh(a @ a)
            torch.cuda.synchronize()
    out = tracing.report()
    assert len(out["spans"]) == 5
    for s in out["spans"]:
        (h0, h1), (d0, d1) = s["host_ms"], s["device_ms"]
        assert h0 - TOL_MS <= d0 < d1 <= h1 + TOL_MS, s
        assert d1 - d0 > 0.5 * (h1 - h0) - TOL_MS, s  # the card was busy through it
    # the card idles between them while the host leaves one span and enters
    # the next: a gap begins as a span ends on the card, its host span still
    # open (its synchronise returning) or already closed
    assert all(g[2] > 0 for g in out["gaps"]) and len(out["gaps"]) <= 4
    assert {g[0] for g in out["gaps"]} <= {"work", "outside"}


def test_a_span_inside_a_capture_records_no_event(dev):
    x = torch.zeros(4, device=dev)
    tracing.enable(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1)  # warm-up on the side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with tracing.span("inside"):
            x.add_(1)
    for _ in range(3):
        graph.replay()
    out = tracing.report()
    assert [s["name"] for s in out["spans"]] == ["inside"]
    assert out["spans"][0]["device_ms"] is None and out["events"] == 0
    assert x.tolist() == [4.0] * 4


@pytest.mark.parametrize("eval_interval", [1, 3])
def test_graphs_captured_under_the_tracer_count_their_replays(dev, eval_interval):
    tr = _trainer(dev, eval_interval)
    tr.cfg.max_epochs = 4
    tracing.enable(dev)
    tr.train()  # warm-up and capture of every graph, then their replays
    out = tracing.report()
    tracing.disable()
    graphs = list(tr._graphs.values())
    c = out["counters"]
    assert graphs and all(g.device_replays is not None for g in graphs)
    assert c["graph.captures"] == len(graphs) == out["by_name"]["capture"]["calls"]
    assert c["graph.replays"] == sum(g.replays for g in graphs) > 0
    assert c["graph.replays_unrun"] == 0
    assert all(int(g.device_replays.item()) == g.replays for g in graphs)
    tr.close()
