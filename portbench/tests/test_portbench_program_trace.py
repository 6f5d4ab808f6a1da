"""The metrics that read the program's own tracer
(`portbench/program_readers.py`). A traced run's profiled `train()` call
traces itself in the program; a rehearsal makes no profiled call, so here a
traced rehearsal runs under a CPU profiler, whose last `train()` call (the
window) then traces itself: the line prints `host_reads.*` and
`checkpoint_ms.*` (the CPU has no device interval, so no
`step_device_ms.*` and no other device metric). A traced rehearsal without
a profiler, and a program whose tracer is hidden, as on a commit that has
none, give readers that return None and a line that still prints; an
untraced run reads nothing."""

import json
import sys

import pytest
import torch

from portbench.tests.helpers import CELLS, core, rehearse

from portbench import program_readers

TAGS = {"ipn_t354_b256.p1": "p1", "ipn_t48_b4096.p1": "p1", "ipn_t354_b256.p3": "p3"}


def _device_metrics() -> set:
    bench = core.benchmark()
    return {m["name"] for m in bench["per_layer"] if m["source"] == "device_trace"} | {
        "step_device_ms.p1", "step_device_ms.p3"}


def _profiled_rehearsal(cell: str, seed: int):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        return rehearse(cell, seed=seed, trace=1)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_rehearsal_prints_the_program_s_counts(cell):
    run = _profiled_rehearsal(cell, seed=2147000123)
    tag = TAGS[cell]
    line = json.loads(json.dumps(core.result(run, "cpu (rehearsal)")))
    trace = run.readings["program_trace"]
    assert trace["counters"]["host_reads"] > 0 and trace["counters"]["train.steps"] > 0
    assert [s["name"] for s in trace["spans"] if s["parent"] is None] == ["train"]
    metrics = line["rehearsal_metrics"]
    assert {f"host_reads.{tag}", f"checkpoint_ms.{tag}"} <= set(metrics)
    assert not set(metrics) & _device_metrics(), metrics
    epochs = sum(s["name"] == "epoch" for s in trace["spans"])
    assert metrics[f"host_reads.{tag}"]["value"] == trace["counters"]["host_reads"] / epochs
    ckpt_ms = sum(s["host_ms"][1] - s["host_ms"][0] for s in trace["spans"]
                  if s["name"] == "checkpoint")
    assert metrics[f"checkpoint_ms.{tag}"]["value"] == ckpt_ms / epochs


def test_a_rehearsal_without_a_profiler_reads_no_program_trace():
    from deep_interpolation_clustering_tpu_torch.utils import tracing

    run = rehearse("ipn_t354_b256.p3", seed=2147000126, trace=1)
    assert not tracing.enabled() and tracing.take() is None
    line = core.result(run, "cpu (rehearsal)")
    assert not {"host_reads.p3", "checkpoint_ms.p3"} & set(line["rehearsal_metrics"])
    assert run.readings["program_trace"] is None
    assert "step_ms.p3" in line["rehearsal_metrics"]


def test_without_the_program_s_tracer_the_readers_return_none(monkeypatch):
    import deep_interpolation_clustering_tpu_torch.train  # noqa: F401 (the program, imported)

    monkeypatch.setitem(sys.modules, program_readers.PROGRAM_TRACER, None)
    assert program_readers.program_tracer() is None
    run = rehearse("ipn_t354_b256.p1", seed=2147000124, trace=1)
    for name in ("step_device_ms", "host_reads", "checkpoint_ms"):
        assert getattr(program_readers, name)(run, "p1") is None
    line = core.result(run, "cpu (rehearsal)")
    assert line["correct"] is True
    assert not {"host_reads.p1", "checkpoint_ms.p1"} & set(line["rehearsal_metrics"])
    assert "step_ms.p1" in line["rehearsal_metrics"]


def test_an_untraced_run_reads_no_program_trace():
    """Even where a profiler made the program keep a report."""
    from deep_interpolation_clustering_tpu_torch.utils import tracing

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run = rehearse("ipn_t48_b4096.p1", seed=2147000125, trace=0)
    assert program_readers.host_reads(run, "p1") is None
    assert "program_trace" not in run.readings
    assert tracing.take() is not None  # kept, and left unread
