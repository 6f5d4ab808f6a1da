"""Shared by the benchmark's CPU tests: the repo root on the path and a
rehearsal of a cell in this process."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import core  # noqa: E402

CELLS = ("ipn_t354_b256.p1", "ipn_t48_b4096.p1", "ipn_t354_b256.p3")


def rehearse(cell: str, seed: int = 7, control: bool = False, trace: int = 0):
    """The cell's run on the CPU at the rehearsal's toy size."""
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace),
            "--rehearse"] + (["--control"] if control else [])
    return core.run_cell(core.parse(argv), time.perf_counter())
