"""`trainer_share.p1`: see `portbench/readers.py` `trainer_share`."""

from portbench import readers


def read(run):
    return readers.trainer_share(run, "p1")
