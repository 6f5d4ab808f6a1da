"""`step_device_ms.p1`: see `portbench/program_readers.py` `step_device_ms`."""

from portbench import program_readers


def read(run):
    return program_readers.step_device_ms(run, "p1")
