"""`checkpoint_ms.p3`: see `portbench/program_readers.py` `checkpoint_ms`."""

from portbench import program_readers


def read(run):
    return program_readers.checkpoint_ms(run, "p3")
