"""`hand_roofline.p3`: see `portbench/readers.py` `hand_roofline`."""

from portbench import readers


def read(run):
    return readers.hand_roofline(run, "p3")
