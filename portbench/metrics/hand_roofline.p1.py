"""`hand_roofline.p1`: see `portbench/readers.py` `hand_roofline`."""

from portbench import readers


def read(run):
    return readers.hand_roofline(run, "p1")
