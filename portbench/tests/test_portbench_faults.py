"""A run whose timed path is broken underneath comes out not correct: once
for each fault a one-chip training cell can have (`portbench/faults.py`:
its state left unchanged, half of the batch left out with the mean over the
rest, an answer altered where it is produced). There is no exchange between
chips to leave out. Two more faults show that the reference takes no
weights from the program."""

import pytest
import torch

from portbench.tests.helpers import core, rehearse

from portbench.faults import FAULTS


@pytest.mark.parametrize("cell", ["ipn_t354_b256.p1", "ipn_t354_b256.p3"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(fault, cell, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    run = rehearse(cell, seed=13)
    assert core.result(run, "cpu")["correct"] is False
    assert any(c["value"] > c["limit"] for c in run.checks.values()), run.checks


def drifting_weights(setattr) -> None:
    """Every update followed by each parameter scaled by 1.01: the program
    trains on weights that its own steps did not make."""
    from deep_interpolation_clustering_tpu_torch.train import steps

    inner = steps.update

    def update(net, *args, **kwargs):
        losses = inner(net, *args, **kwargs)
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(1.01)
        return losses
    setattr(steps, "update", update)


def altered_eval(setattr) -> None:
    """The eval pass's losses moved by one part in a thousand where they
    are produced."""
    from deep_interpolation_clustering_tpu_torch.train import trainer

    inner = trainer.eval_step

    def eval_step(*args, **kwargs):
        losses, outputs = inner(*args, **kwargs)
        return {k: v * (1.0 + 1e-3) for k, v in losses.items()}, outputs
    setattr(trainer, "eval_step", eval_step)


@pytest.mark.parametrize("cell", ["ipn_t354_b256.p1", "ipn_t354_b256.p3"])
@pytest.mark.parametrize("fault, caught_by", [(drifting_weights, "loss_gap"),
                                              (altered_eval, "eval_gap")])
def test_the_reference_takes_no_weights_from_the_program(fault, caught_by, cell, monkeypatch):
    """The reference steps and evaluates from the run's weights on its own:
    weights that the program corrupts between its steps show in the later
    steps' losses, and a wrong eval pass in the eval gap."""
    fault(monkeypatch.setattr)
    run = rehearse(cell, seed=14)
    assert core.result(run, "cpu")["correct"] is False
    c = run.checks[caught_by]
    assert c["value"] > c["limit"], run.checks
