"""`trainer_share.p3`: see `portbench/readers.py` `trainer_share`."""

from portbench import readers


def read(run):
    return readers.trainer_share(run, "p3")
