"""What the training jobs share: the step recorder, the spans around the
trainer's layers, the program's configuration and trainer built from the
cell's files, the shapes the work counts take, and the comparison's
diagnostics."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import cohort, trace, weights, work
from portbench.reference import compare
from portbench.reference import train as reference

RECORDED_STEPS = 3
# what a control run prints of the TF32 reference's readings
CONTROL_READINGS = ("loss1_gap", "loss_gap", "grad_gap", "change_gap", "eval_gap", "_loss_gaps",
                    "_grad_worst", "_change_worst")


class StepRecorder:
    """Records the first `n` train steps that `train()` replays: the
    generator's state before the first, the parameters before each, each
    step's losses, the optimizer's first moments after the first step and
    the parameters after the last (device copies, queued around each
    step)."""

    def __init__(self, trainer, n: int):
        self.trainer, self.n = trainer, n
        self.losses, self.moments, self.params = [], None, None
        self.states: list = []  # the parameters before each recorded step
        self.generator_state = None
        inner = trainer._train_graph

        def graph(masked):
            step = inner(masked)

            def call(rows, mask=None):
                if len(self.states) < self.n:
                    if not self.states:
                        self.generator_state = trainer.generator.get_state()
                    self.states.append({name: p.detach().clone()
                                        for name, p in trainer.net.named_parameters()})
                out = step(rows, mask)
                self._record(out["losses"])
                return out
            return call

        trainer._train_graph = graph

    def _record(self, losses: torch.Tensor) -> None:
        k = len(self.losses)
        if k >= self.n:
            return
        self.losses.append(losses.detach().clone())
        named = dict(self.trainer.net.named_parameters())
        if k == 0:
            # a moment the optimizer has not made (no step taken) is zero
            self.moments = {name: self.trainer.opt.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p)).detach().clone() for name, p in named.items()}
        if k == self.n - 1:
            self.params = {name: p.detach().clone() for name, p in named.items()}

    def remove(self) -> None:
        del self.trainer._train_graph

    def readings(self) -> dict:
        """Each step's losses by name, the first gradient as the optimizer
        took it (its first moment over 1 - beta1) and the parameters."""
        keys = self.trainer._loss_keys[("train", False)]
        beta1 = self.trainer.opt.param_groups[0]["betas"][0]
        return {"losses": [dict(zip(keys, l.cpu().tolist())) for l in self.losses],
                "grad": {k: v.double() / (1.0 - beta1) for k, v in self.moments.items()},
                "params": self.params, "states": self.states,
                "generator_state": self.generator_state}


def fields(run) -> dict:
    """The program's configuration: the configuration file's model fields,
    the traffic's program fields and the run's seed."""
    out = run.model_config()
    out.update(run.cell.traffic.get("program", {}))
    out["seed"] = run.program_seed()
    return out


def shapes(run, cfg, raw) -> work.Shapes:
    mask = raw["training"]["padding_mask"]
    triplet = cfg.triple_margin != 0.0 and "triplet" in cfg.loss
    return work.Shapes(b=cfg.batch_size, c=cfg.num_variables, t=cfg.num_timestamps,
                       r=cfg.ref_points, hidden=cfg.lstm_hidden, head_hidden=cfg.head_hidden,
                       streams=3 if triplet else 2,
                       obs_per_encounter=float(mask.sum(dtype=np.float64)) / mask.shape[0],
                       clusters=cfg.cluster_number if "_kl" in cfg.loss else 0)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def wrap_layers(spans: trace.Spans, trainer, batch_size: int) -> None:
    """Spans around what `train()` calls: the train epochs (dispatch to the
    end of their device work, their steps counted), their loss fetch, the
    eval passes (their batches counted), checkpoints, summary rows and a
    DEC trainer's centre init."""
    spans.wrap(trainer, "_dispatch_fused_epoch", "train_epoch",
               lambda out, *a, **k: int(out[0].shape[0]))
    spans.wrap(trainer, "_finalize_fused_epoch", "fetch")
    spans.wrap(trainer, "eval_one_epoch", "eval",
               lambda out, scope, ds, *a, **k: ds.num_batches(batch_size))
    spans.wrap(trainer, "_ckpt_candidacy", "checkpoint")
    spans.wrap(trainer.summary, "add_summary", "summary")
    if hasattr(trainer, "init_centers"):  # DEC: the centre init of each call
        spans.wrap(trainer, "init_centers", "init")


def make_trainer(run, cfg, datasets, cls=None, **kwargs):
    """The program's trainer (`cls`, p1's `Trainer` by default), its
    parameters replaced by the run's starting weights (made from the seed by
    their names and shapes); returns both, and a copy of the trainer's
    buffers as it made them (the BatchNorm moments before training)."""
    from deep_interpolation_clustering_tpu_torch.train.trainer import Trainer

    trainer = (cls or Trainer)(cfg, datasets, f"{run.work}/{run.cell.traffic['job']}",
                               device=run.device, **kwargs)
    named = dict(trainer.net.named_parameters())
    init = weights.make({k: tuple(p.shape) for k, p in named.items()}, 2 * run.seed + 1,
                        run.device)
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(init[name])
    fresh = {k: v.detach().clone() for k, v in trainer.net.named_buffers()}
    return trainer, init, fresh


def set_weights(trainer, params, buffers) -> None:
    """The trainer's parameters and buffers overwritten in place, where its
    captured graphs read them (after the window: the eval pass checked at
    weights that the program did not make)."""
    with torch.no_grad():
        for k, p in trainer.net.named_parameters():
            p.copy_(params[k])
        for k, b in trainer.net.named_buffers():
            b.copy_(buffers[k])


def make_cohort(run, cfg):
    """The cell's training and validation cohorts, made on the device from
    the seed; the device's peak is counted from here on."""
    conf = run.cell.config
    raw = cohort.make(run.encounters(), (conf["train_share"], conf["valid_share"]),
                      cfg.num_timestamps, 2 * run.seed, run.device, cfg.hours_from_admission,
                      conf["min_obs"], cfg.holdout_frac)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.device)
    return raw


def profile_call(run, trainer, cfg, s: work.Shapes, epochs: int):
    """A `train()` call of `epochs` epochs under the profiler, its spans
    marked in the trace: the device's busy and idle time, the hand kernels'
    seconds and their bound over the steps and eval batches the call ran.
    Returns the call's validation metrics."""
    spans = trace.Spans(run.device, sync=False)
    wrap_layers(spans, trainer, cfg.batch_size)
    cfg.max_epochs = trainer.epoch + epochs
    with trace.profiled(run.device) as prof:
        last_valid = trainer.train()
    spans.remove()
    run.profile = prof
    run.readings["hand_bound_s"] = (
        spans.counts["train_epoch"] * work.bound_ms(work.hand_step_work(s))
        + spans.counts["eval"] * work.bound_ms(work.hand_forward_work(s))) / 1e3
    return last_valid


def window(run, trainer, cfg, raw, n_epochs: int):
    """The timed call: `train()` for `n_epochs` epochs, its rate the
    training encounters of those epochs over the call's wall time. A traced
    run wraps the call's layers in spans (synchronised) and profiles one
    more call. Reads the device's memory peak after. Returns the last
    call's validation metrics."""
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
    s = shapes(run, cfg, raw)
    run.readings.update(tag=traffic["job"], call_s=call_s, train_s=spans.total("train_epoch"),
                        steps=spans.counts["train_epoch"], flops_per_step=work.model_flops(s),
                        spans={k: [sum(v), len(v)] for k, v in spans.seconds.items()},
                        epochs_s=[round(t, 4) for t in spans.seconds.get("train_epoch", [])])
    if run.args.trace and dev.type == "cuda":
        last_valid = profile_call(run, trainer, cfg, s, int(traffic["profile_epochs"]))
    elif run.args.trace:  # a rehearsal: the spans' reading, no device trace
        run.profile = {"busy_s": 0.0, "window_s": call_s, "device_ops": [], "idle_gaps": []}
    sync(dev)
    run.memory_peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return last_valid


def weights_of(trainer):
    """Copies of the program's parameters and buffers."""
    return ({k: v.detach().clone() for k, v in trainer.net.named_parameters()},
            {k: v.detach().clone() for k, v in trainer.net.named_buffers()})


def release(trainer) -> None:
    """The trainer closed and its device memory freed for the reference."""
    trainer.close()
    trainer.__dict__.clear()  # the recorders hold the trainer too
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def diagnostics(ref_cfg, start, raw, prog, final, buffers, last_valid, **kwargs) -> dict:
    """Readings that no limit holds: the reference's steps at the program's
    points (`states`), and its eval pass at the program's final weights and
    buffers against the window's last one."""
    lock = compare.train_numbers(prog, reference.train_steps(
        ref_cfg, start, raw["training"], RECORDED_STEPS, states=prog["states"], **kwargs), start)
    out = {f"_lockstep_{k}": lock[k] for k in ("loss_gap", "change_gap")}
    out["_final_eval_gap"] = compare.eval_numbers(
        last_valid, reference.eval_losses(ref_cfg, final, buffers, raw["validation"]))["eval_gap"]
    return out
