"""`host_reads.p3`: see `portbench/program_readers.py` `host_reads`."""

from portbench import program_readers


def read(run):
    return program_readers.host_reads(run, "p3")
