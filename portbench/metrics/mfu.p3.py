"""`mfu.p3`: see `portbench/readers.py` `mfu`."""

from portbench import readers


def read(run):
    return readers.mfu(run, "p3")
