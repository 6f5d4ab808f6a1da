"""The p1 pretraining job: the program's `Trainer.train()`, one call a window.

Set-up makes the cohort and the starting weights from the seed, builds the
trainer, and runs its first epoch and validation pass through `train()`
(every CUDA graph captured there); its first three steps are recorded for
the comparison. A second call times a steady epoch, from which the
window's epoch count is set so that one call lasts about `--seconds`. The
window is that one call: the rate is every training encounter of its
epochs over its whole wall time, evals, checkpoints and summaries
included.

After the window the program's eval pass runs once more, its weights and
buffers set back to the run's starting ones; then (the memory peak read
and the program freed) the reference makes its own three steps from the
run's weights with the same batches and draws, and its own eval pass at
the starting weights; `correct` holds the gaps against the cell's limits.
Nothing the reference computes starts from weights the program made. The
reference's steps at the program's points and its eval pass at the
program's final weights are printed as diagnostics, not held.
"""

from __future__ import annotations

import logging
import time

from portbench.reference import compare
from portbench.reference import train as reference
from portbench.training import (CONTROL_READINGS, RECORDED_STEPS, StepRecorder, diagnostics,
                                fields, make_cohort, make_trainer, release, set_weights, sync,
                                weights_of, window)


def run(run) -> None:
    from deep_interpolation_clustering_tpu_torch.config import Config
    from deep_interpolation_clustering_tpu_torch.data.loader import ArrayDataset

    logging.getLogger("dicl.torch").setLevel(logging.WARNING)
    dev = run.device
    ref_cfg = fields(run)
    cfg = Config(**ref_cfg, max_epochs=2)
    run.stage("imports")
    raw = make_cohort(run, cfg)
    run.stage("cohort")
    datasets = {k: ArrayDataset(cfg, v, k) for k, v in raw.items()}
    run.stage("datasets")
    trainer, init, fresh = make_trainer(run, cfg, datasets)
    run.stage("trainer")
    recorder = StepRecorder(trainer, RECORDED_STEPS)
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
    final, buffers = weights_of(trainer)
    seed_valid = seed_eval(trainer, init, fresh)
    release(trainer)
    check(run, ref_cfg, init, raw, prog, final, buffers, last_valid, seed_valid)


def seed_eval(trainer, init, fresh):
    """The program's eval pass over the validation cohort at the run's
    starting weights and its own starting buffers."""
    set_weights(trainer, init, fresh)
    metrics, _ = trainer.eval_one_epoch("valid", trainer.datasets["validation"],
                                        trainer.cfg.denoise)
    return metrics


def check(run, ref_cfg, init, raw, prog, final, buffers, last_valid, seed_valid) -> None:
    """The reference's three steps and eval pass from the run's weights
    against the program's; with `--control`, the TF32 reference's against
    the float32 one's."""
    ref = reference.train_steps(ref_cfg, init, raw["training"], RECORDED_STEPS)
    numbers = compare.train_numbers(prog, ref, init)
    numbers["start_gap"] = compare.start_gap(prog["states"][0], init)
    fresh = reference.initial_buffers(init)
    ref_eval = reference.eval_losses(ref_cfg, init, fresh, raw["validation"])
    numbers.update(compare.eval_numbers(seed_valid, ref_eval))
    for k in ("loss1_gap", "loss_gap", "grad_gap", "change_gap", "eval_gap", "start_gap"):
        run.hold(k, numbers[k])
    run.readings["check_leaves"] = dict(
        {k: v for k, v in numbers.items() if k.startswith("_") or k == "quiet_leaves"},
        **diagnostics(ref_cfg, init, raw, prog, final, buffers, last_valid))
    if run.args.control:
        ctl = reference.train_steps(ref_cfg, init, raw["training"], RECORDED_STEPS, "tf32")
        c = compare.train_numbers(ctl, ref, init)
        c.update(compare.eval_numbers(
            reference.eval_losses(ref_cfg, init, fresh, raw["validation"], "tf32"), ref_eval))
        run.control.update({k: c[k] for k in CONTROL_READINGS})
