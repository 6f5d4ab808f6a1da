"""The reference against the program's plain path (the CPU, toy sizes): a
p1 or p3 run whose first three steps the reference makes on its own from
the run's weights, and whose eval pass it makes at those weights (at p3
also the k-means centres' Lloyd step and the labels at the first DEC
step), and the lower-precision control (the reference in TF32, emulated on
the CPU by rounding each product's operands) that the comparison must
fail."""

import pytest

from portbench.tests.helpers import CELLS, core, rehearse


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_plain_path(cell):
    run = rehearse(cell, seed=11)
    assert set(run.checks) == set(run.cell.limits)
    for name, c in run.checks.items():
        assert c["value"] < 1e-5, (name, c)
    assert core.result(run, "cpu")["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_fails(cell):
    run = rehearse(cell, seed=12, control=True)
    assert core.result(run, "cpu")["correct"] is True
    failed = [k for k, v in run.control.items() if k in run.cell.limits and v > run.cell.limits[k]]
    assert failed, (run.control, run.cell.limits)
