"""`step_ms.p1`: see `portbench/readers.py` `step_ms`."""

from portbench import readers


def read(run):
    return readers.step_ms(run, "p1")
