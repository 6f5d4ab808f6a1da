"""The p1 pretraining job for mTAN (`Config.model = "mtan"`): the program's
`Trainer.train()`, one call a window, as `jobs/p1.py` drives the IPN.

Set-up makes the cohort and the starting weights from the seed (mTAN's
inits, `reference/mtan.init_weights`), builds the trainer, and runs its
first epoch and validation pass through `train()` (every CUDA graph
captured there); its first three steps are recorded with the standard
normal draw `eps` that each of them takes from the program's generator (a
copy of the generator's state before the step, drawn at the step's shape).
A second call times a steady epoch, from which the window's epoch count is
set. The window is one call; its rate is every training encounter of its
epochs over its whole wall time.

The readers of the p1 cells read this cell too (`tag` "p1";
`flops_per_step` from `mtan_work.model_flops`). A traced run profiles one
more call and sums the device seconds of the encoder attention's kernels
(`MTAN_KERNELS`) and their bound over the call's steps and eval batches
(`mtan_work`), for `mtan_attn_roofline.p1` and `mtan_attn_share.p1`.

After the window the program's eval pass runs once more at the run's
starting weights; then (the program freed) `reference/mtan.py` makes its
own three steps from the run's weights with the same batches and `eps`,
and its own eval pass at the starting weights; `correct` holds the gaps
against the cell's limits, among them the worst leaf's first gradient
and change and the first gradient of the leaves the encoder attention
alone reaches. A program without mTAN (no `Config.model`)
stops at once, before the cohort is made.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterator

import torch

from portbench import mtan_work, trace
from portbench.reference import compare
from portbench.reference import mtan as reference
from portbench.training import (CONTROL_READINGS, RECORDED_STEPS, StepRecorder, fields,
                                make_cohort, release, set_weights, sync, weights_of,
                                wrap_layers)

# the rehearsal's mTAN widths (the CPU, beside `core.REHEARSAL`'s batch and slots)
REHEARSAL = {"mtan_ref_points": 8, "mtan_embed_time": 16, "mtan_rec_hidden": 16,
             "mtan_gen_hidden": 8, "mtan_latent_dim": 4}
# the numbers that decide `correct` (`reference/mtan.train_numbers`)
FEW_LEAVES = ("grad_worst", "change_worst", "attn_grad_gap")
HELD = ("loss1_gap", "loss_gap", "grad_gap", "change_gap") + FEW_LEAVES + ("eval_gap",
                                                                         "start_gap")
# the names of the encoder attention's kernels (csrc/mtan.cu)
MTAN_KERNELS = ("mtan_attn_fwd_kernel", "mtan_attn_bwd_kernel", "mtan_dq_sum_kernel")


def run(run) -> None:
    from deep_interpolation_clustering_tpu_torch.config import Config
    from deep_interpolation_clustering_tpu_torch.data.loader import ArrayDataset

    logging.getLogger("dicl.torch").setLevel(logging.WARNING)
    dev = run.device
    ref_cfg = fields(run)
    if run.rehearse:
        ref_cfg.update(REHEARSAL)
    cfg = Config(**ref_cfg, max_epochs=2)
    run.stage("imports")
    raw = make_cohort(run, cfg)
    run.stage("cohort")
    datasets = {k: ArrayDataset(cfg, v, k) for k, v in raw.items()}
    run.stage("datasets")
    trainer, init, fresh = make_trainer(run, cfg, datasets)
    run.stage("trainer")
    recorder = StepRecorder(trainer, RECORDED_STEPS)
    eps = record_eps(trainer, cfg, RECORDED_STEPS)
    trainer.train()  # epoch 1 and its eval: every graph captured
    recorder.remove()
    run.stage("first call")
    t0 = time.perf_counter()
    cfg.max_epochs = trainer.epoch + 1
    trainer.train()
    sync(dev)
    n_epochs = max(1, round(run.args.seconds / (time.perf_counter() - t0)))
    run.stage("timed epoch")
    run.end_to_end["setup_s"] = time.perf_counter() - run.t_start

    last_valid = window(run, trainer, cfg, raw, n_epochs)
    prog = recorder.readings()
    final, _ = weights_of(trainer)
    set_weights(trainer, init, fresh)
    seed_valid, _ = trainer.eval_one_epoch("valid", trainer.datasets["validation"],
                                           trainer.cfg.denoise)
    release(trainer)
    check(run, ref_cfg, init, raw, prog, eps, final, last_valid, seed_valid)


def make_trainer(run, cfg, datasets):
    """The program's trainer, its parameters replaced by the run's starting
    weights; returns both, and a copy of the trainer's buffers as it made
    them (the KL weight before training)."""
    from deep_interpolation_clustering_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, datasets, f"{run.work}/{run.cell.traffic['job']}", device=run.device)
    named = dict(trainer.net.named_parameters())
    init = reference.init_weights({k: tuple(p.shape) for k, p in named.items()},
                                  2 * run.seed + 1, run.device)
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(init[name])
    fresh = {k: v.detach().clone() for k, v in trainer.net.named_buffers()}
    return trainer, init, fresh


def record_eps(trainer, cfg, n: int) -> list:
    """The `eps` of the first `n` train steps, as the program draws them: a
    standard normal (B, R, L) from its generator's state before the step.
    Wraps the trainer's captured train step (over `StepRecorder`'s, which
    `remove` takes off with it)."""
    inner, drawn = trainer._train_graph, []
    shape = (cfg.batch_size, cfg.mtan_ref_points, cfg.mtan_latent_dim)

    def graph(masked):
        step = inner(masked)

        def call(rows, mask=None):
            if len(drawn) < n:
                gen = torch.Generator(device=trainer.device)
                gen.set_state(trainer.generator.get_state())
                drawn.append(torch.randn(shape, generator=gen, device=trainer.device))
            return step(rows, mask)
        return call

    trainer._train_graph = graph
    return drawn


def window(run, trainer, cfg, raw, n_epochs: int):
    """The timed call (`training.window`'s, with mTAN's work counts): the
    rate, the spans of a traced run and its profiled call, the memory
    peak. Returns the last call's validation metrics."""
    dev, traffic = run.device, run.cell.traffic
    train = trainer.datasets["training"]
    spans = trace.Spans(dev, sync=bool(run.args.trace))
    if run.args.trace:
        wrap_layers(spans, trainer, cfg.batch_size)
    cfg.max_epochs = trainer.epoch + n_epochs
    t0 = time.perf_counter()
    last_valid = trainer.train()
    sync(dev)
    call_s = time.perf_counter() - t0
    spans.remove()
    run.attempted = n_epochs * train.num_batches(cfg.batch_size)
    run.end_to_end[traffic["rate_metric"]] = n_epochs * len(train) / call_s
    s = mtan_work.shapes(cfg, raw)
    run.readings.update(tag="p1", call_s=call_s, train_s=spans.total("train_epoch"),
                        steps=spans.counts["train_epoch"],
                        flops_per_step=mtan_work.model_flops(s),
                        spans={k: [sum(v), len(v)] for k, v in spans.seconds.items()},
                        epochs_s=[round(t, 4) for t in spans.seconds.get("train_epoch", [])])
    if run.args.trace and dev.type == "cuda":
        last_valid = profile_call(run, trainer, cfg, s, int(traffic["profile_epochs"]))
    elif run.args.trace:  # a rehearsal: the spans' reading, no device trace
        run.profile = {"busy_s": 0.0, "window_s": call_s, "device_ops": [], "idle_gaps": []}
    sync(dev)
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return last_valid


@contextlib.contextmanager
def profiled(device) -> Iterator[dict]:
    """`trace.profiled`, the profile also holding `mtan_attn_s`: the device
    seconds of `MTAN_KERNELS`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    box: dict = {}
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield box
        torch.cuda.synchronize(device)
        box["window_s"] = time.perf_counter() - t0
    box.update(trace.device_profile(prof))
    box["mtan_attn_s"] = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
        and any(k in e.name for k in MTAN_KERNELS)) / 1e6


def profile_call(run, trainer, cfg, s: mtan_work.Shapes, epochs: int):
    """A `train()` call of `epochs` epochs under the profiler, its spans
    marked in the trace; the bound of the encoder attention's pair over the
    steps and eval batches it ran. Returns the call's validation metrics."""
    spans = trace.Spans(run.device, sync=False)
    wrap_layers(spans, trainer, cfg.batch_size)
    cfg.max_epochs = trainer.epoch + epochs
    with profiled(run.device) as prof:
        last_valid = trainer.train()
    spans.remove()
    run.profile = prof
    run.readings["mtan_attn_bound_s"] = (
        spans.counts["train_epoch"] * mtan_work.attention_step_ms(s)
        + spans.counts["eval"] * mtan_work.bound_ms(mtan_work.attention_forward_work(s))) / 1e3
    return last_valid


def check(run, ref_cfg, init, raw, prog, eps, final, last_valid, seed_valid) -> None:
    """The reference's three steps and eval pass from the run's weights
    against the program's; with `--control`, the TF32 reference's against
    the float32 one's. The reference's eval pass at the program's final
    weights against the window's last is printed, not held."""
    ref = reference.train_steps(ref_cfg, init, raw["training"], eps)
    numbers = reference.train_numbers(prog, ref, init)
    numbers["start_gap"] = compare.start_gap(prog["states"][0], init)
    ref_eval = reference.eval_losses(ref_cfg, init, raw["validation"])
    numbers.update(reference.eval_numbers(seed_valid, ref_eval))
    for k in HELD:
        run.hold(k, numbers[k])
    final_ref = reference.eval_losses(ref_cfg, final, raw["validation"])
    leaves = {k: v for k, v in numbers.items() if k.startswith("_") or k == "quiet_leaves"}
    leaves["_final_eval_gap"] = max(compare.rel_gap(last_valid[k], final_ref[k])
                                    for k in ("ae_mse", "nll", "kl", "future_vital"))
    run.readings["check_leaves"] = leaves
    if run.args.control:
        ctl = reference.train_steps(ref_cfg, init, raw["training"], eps, "tf32")
        c = reference.train_numbers(ctl, ref, init)
        c.update(reference.eval_numbers(
            reference.eval_losses(ref_cfg, init, raw["validation"], "tf32"), ref_eval))
        run.control.update({k: c[k] for k in CONTROL_READINGS + FEW_LEAVES})
