"""`idle_share.p1`: see `portbench/readers.py` `idle_share`."""

from portbench import readers


def read(run):
    return readers.idle_share(run, "p1")
