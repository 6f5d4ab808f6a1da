"""The readings that the limits of `limits/<cell>.json` are set from: one
process runs the cell on many seeds, each with the lower-precision control
(the reference in TF32), and prints a line a seed; `--fault` plants one of
`faults.py` in the program first. Not a benchmark run.

    python3 portbench/calibrate.py --workload <cell> --seconds 2 --seeds 11 12 13 ...
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import core  # noqa: E402
from portbench.faults import FAULTS  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rehearse", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS), help="plant this fault in the program")
    p.add_argument("--plain", action="store_true",
                   help="a witness: the program with its kernels' plain versions on the card")
    a = p.parse_args()
    if a.fault:
        FAULTS[a.fault](setattr)
    if a.plain:
        from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
        cb.KernelWrapper.__call__ = lambda self, *args: self.plain(*args)
    for seed in a.seeds:
        argv = ["--workload", a.workload, "--seed", str(seed), "--seconds", str(a.seconds),
                "--control"] + (["--rehearse"] if a.rehearse else [])
        run = core.run_cell(core.parse(argv), time.perf_counter())
        print(json.dumps({"seed": seed, "fault": a.fault, "plain": a.plain,
                          "checks": {k: c["value"] for k, c in run.checks.items()},
                          "control": run.control, "leaves": run.readings.get("check_leaves"),
                          "metrics": run.end_to_end}), flush=True)
        del run
        gc.collect()


if __name__ == "__main__":
    main()
