"""The p3 DEC job: the program's `ClusterTrainer.train()`, one call a window,
its centre init included.

Set-up makes the cohort and the starting weights from the seed and writes
them as the p1 checkpoint that the trainer restores (the program's own
checkpoint format); the first call captures every graph and its first
three DEC steps are recorded. A second call of one epoch times an epoch
beside its centre init, from which the window's epoch count is set (two at
least). The rate is every training encounter of the window call's DEC
epochs over the call's whole wall time: the centre init (an eval pass over
the training cohort and k-means), the delta passes and the checkpoints
included.

The reference cannot draw the program's k-means: its restarts, and the
generator's draws of the eval passes before the first step, are the
program's. So its own three steps start from the run's weights with the
program's centres, its generator moved on to the program's offset (the
seed is its own), and the skipped stage is checked by itself: the
program's centres must be a fixed point of Lloyd's step over the
reference's latents of the training cohort at the run's weights. After
the window the program's label pass (`generate_pred_cluster`) runs once
more at that start, its buffers its own starting ones; its losses and
labels are held against the reference's eval pass and argmax there, and
its changed-label count against its labels. Nothing else the reference
computes starts from the program's weights.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from portbench import trace
from portbench.reference import compare
from portbench.reference import train as reference
from portbench.training import (CONTROL_READINGS, RECORDED_STEPS, StepRecorder, diagnostics,
                                fields, make_cohort, make_trainer, release, set_weights, sync,
                                weights_of, window)


def write_pretrain(run, trainer) -> None:
    """The run's starting weights as the p1 checkpoint that the trainer's
    centre init restores."""
    from deep_interpolation_clustering_tpu_torch.compat import jax_from_state_dict
    from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt

    params, state = jax_from_state_dict(trainer.net.state_dict())
    ckpt.save_checkpoint(f"{trainer.pretrain_exp_path}/weight/{trainer.cfg.restore_metric}/"
                         f"{ckpt.CKPT_NAME}", 0, params, state)


def run(run) -> None:
    from deep_interpolation_clustering_tpu_torch.config import Config
    from deep_interpolation_clustering_tpu_torch.data.loader import ArrayDataset
    from deep_interpolation_clustering_tpu_torch.train.cluster_trainer import ClusterTrainer

    logging.getLogger("dicl.torch").setLevel(logging.WARNING)
    dev = run.device
    ref_cfg = fields(run)
    cfg = Config(**ref_cfg, max_epochs=2)
    run.stage("imports")
    raw = make_cohort(run, cfg)
    run.stage("cohort")
    datasets = {k: ArrayDataset(cfg, v, k) for k, v in raw.items()}
    run.stage("datasets")
    trainer, init, fresh = make_trainer(run, cfg, datasets, ClusterTrainer,
                                        pretrain_exp_path=f"{run.work}/p1")
    write_pretrain(run, trainer)
    run.stage("trainer")
    recorder = StepRecorder(trainer, RECORDED_STEPS)
    trainer.train()  # centre init and DEC epoch 1: every graph captured
    recorder.remove()
    run.stage("first call")
    timing = trace.Spans(dev, sync=True)
    timing.wrap(trainer, "init_centers", "init")
    t0 = time.perf_counter()
    cfg.max_epochs = trainer.epoch + 1
    trainer.train()
    sync(dev)
    timing.remove()
    init_s = timing.total("init")
    epoch_s = time.perf_counter() - t0 - init_s
    n_epochs = max(2, round((run.args.seconds - init_s) / epoch_s))
    run.stage("timed epoch")
    run.end_to_end["setup_s"] = time.perf_counter() - run.t_start

    last_valid = window(run, trainer, cfg, raw, n_epochs)
    prog = recorder.readings()
    final, buffers = weights_of(trainer)
    at_start = start_labels(trainer, prog["states"][0], fresh)
    release(trainer)
    check(run, ref_cfg, init, raw, prog, final, buffers, last_valid, at_start)


def start_labels(trainer, start, fresh):
    """The program's label pass over the validation cohort at its state at
    the first DEC step (the run's weights and its centres) and its own
    starting buffers, against all-zero previous labels: (delta, labels,
    metrics, previous labels)."""
    set_weights(trainer, start, fresh)
    ds = trainer.datasets["validation"]
    prev = torch.zeros(len(ds), dtype=torch.long, device=trainer.device)
    delta, _, labels, metrics = trainer.generate_pred_cluster("valid", ds, prev)
    return delta, labels.detach().clone(), metrics, prev


def check(run, ref_cfg, init, raw, prog, final, buffers, last_valid, at_start) -> None:
    """The reference's three DEC steps from the run's weights with the
    program's centres, its Lloyd step from those centres, and its eval pass
    and labels at that start, against the program's; with `--control`, the
    TF32 reference's against the float32 one's, and the readings of two
    faults."""
    start = prog["states"][0]
    centres_key = "cluster_assignment.cluster_centers"
    ref = reference.train_steps(ref_cfg, start, raw["training"], RECORDED_STEPS,
                                generator_state=prog["generator_state"])
    numbers = compare.train_numbers(prog, ref, start)
    latents = reference.latents(ref_cfg, init, raw["training"])
    numbers["kmeans_residual"] = compare.lloyd_residual(latents, start[centres_key])
    fresh = reference.initial_buffers(start)
    ref_eval = reference.eval_losses(ref_cfg, start, fresh, raw["validation"])
    delta, labels, metrics, prev = at_start
    numbers.update(compare.eval_numbers(metrics, ref_eval))
    ref_labels = reference.labels(ref_cfg, start, raw["validation"])
    labels = labels.to(ref_labels.device)
    numbers["label_gap"] = float(torch.mean((ref_labels != labels).double()))
    numbers["delta_gap"] = abs(delta - int(torch.sum(labels != prev.to(labels.device)))
                               / labels.shape[0])
    # the start is the run's weights but for the centres that the program fitted
    numbers["start_gap"] = compare.start_gap(start, init, skip=(centres_key,))
    for k in ("loss1_gap", "loss_gap", "grad_gap", "change_gap", "eval_gap", "kmeans_residual",
              "label_gap", "delta_gap", "start_gap"):
        run.hold(k, numbers[k])
    run.readings["check_leaves"] = dict(
        {k: v for k, v in numbers.items() if k.startswith("_") or k == "quiet_leaves"},
        **diagnostics(ref_cfg, start, raw, prog, final, buffers, last_valid,
                      generator_state=prog["generator_state"]))
    if run.args.control:
        ctl = reference.train_steps(ref_cfg, start, raw["training"], RECORDED_STEPS, "tf32",
                                    generator_state=prog["generator_state"])
        c = compare.train_numbers(ctl, ref, start)
        c.update(compare.eval_numbers(
            reference.eval_losses(ref_cfg, start, fresh, raw["validation"], "tf32"), ref_eval))
        ctl_labels = reference.labels(ref_cfg, start, raw["validation"], "tf32")
        c["label_gap"] = float(torch.mean((ctl_labels != ref_labels).double()))
        rows = np.random.RandomState(run.program_seed()).choice(
            len(latents), start[centres_key].shape[0], replace=False)
        run.control.update({k: c[k] for k in CONTROL_READINGS + ("label_gap",)})
        # faults, read at the cell's size: k-means left at a k-means++-like
        # start (its state unchanged), and every label moved to the next
        # cluster (an answer altered where it is produced)
        run.control["fault_kmeans_residual"] = compare.lloyd_residual(latents, latents[rows])
        moved = (labels + 1) % start[centres_key].shape[0]
        run.control["fault_label_gap"] = float(torch.mean((ref_labels != moved).double()))
