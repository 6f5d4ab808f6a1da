"""The harness: one cell of `BENCHMARK.json` run once.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`

The cell names a configuration file (`configs/`) and a traffic file
(`traffic/`); the traffic names the job (`jobs/<job>.py`) that drives the
program's own entry for the window. With `--trace 0` the result holds the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, each
read by `metrics/<name>.py` from the run's readings. The numbers that
decide `correct` are held against `limits/<cell>.json`.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file of its own that the harness finds by name: a later cell, metric
or configuration adds files and entries and edits none.

`--rehearse` (never a benchmark run) drives the same path on the CPU at a
toy size, with the kernels' plain versions, and prints no metric under a
device metric's name.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that may not be loaded in the process that prints the result,
# compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "deep_interpolation_clustering_tpu")
# the toy sizes of a rehearsal on the CPU
REHEARSAL = {"batch_size": 8, "num_timestamps": 24, "lstm_hidden": 16, "head_hidden": 16}
REHEARSAL_ENCOUNTERS = 60


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the harness's folders, loaded from its file (metric
    names hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}".replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """A workload of `BENCHMARK.json` with its configuration, traffic, metric
    entries and limits."""

    def __init__(self, name: str, root: Path = ROOT):
        bench = benchmark(root)
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json; "
                             f"have {[w['name'] for w in bench['workloads']]}")
        self.name, self.entry = name, found[0]
        config = [c for c in bench["configs"] if c["name"] == self.entry["config"]][0]
        self.config = load_json(root / config["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])

        def mine(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
        limits = HERE / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.exists() else {}


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--list", action="store_true", help="print the cells and exit")
    p.add_argument("--workload")
    p.add_argument("--seed", type=int)
    p.add_argument("--seconds", type=float)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="the CPU at a toy size; prints no device metric")
    p.add_argument("--control", action="store_true",
                   help="also read the lower-precision control (not a benchmark run)")
    args = p.parse_args(argv)
    if not args.list and None in (args.workload, args.seed, args.seconds):
        p.error("--workload, --seed and --seconds are required")
    return args


class Run:
    """One run's arguments, cell, device and what the job read."""

    def __init__(self, args: argparse.Namespace, cell: Cell, t_start: float):
        import torch

        self.args, self.cell, self.t_start = args, cell, t_start
        self.rehearse = args.rehearse
        self.device = torch.device("cpu" if self.rehearse else "cuda")
        self.seed = args.seed
        self.readings: Dict[str, object] = {}
        self.end_to_end: Dict[str, float] = {}
        self.checks: Dict[str, Dict[str, float]] = {}
        self.control: Dict[str, float] = {}
        self.attempted = 0
        self.memory_peak_bytes = 0
        self.profile: Optional[dict] = None
        self.work = ""  # what the program writes: a directory under the run's TMPDIR
        self.stages: List[tuple] = []  # (set-up stage, seconds since the run began)

    def stage(self, name: str) -> None:
        """Mark the end of a set-up stage (printed on standard error)."""
        self.stages.append((name, time.perf_counter() - self.t_start))

    def model_config(self) -> dict:
        """The configuration file's model fields, shrunk in a rehearsal."""
        fields = dict(self.cell.config["model"])
        if self.rehearse:
            fields.update(REHEARSAL)
        return fields

    def encounters(self) -> int:
        return REHEARSAL_ENCOUNTERS if self.rehearse else int(self.cell.config["n_encounters"])

    def program_seed(self) -> int:
        """The seed the program's config takes: the run's seed folded into
        what NumPy's legacy generator accepts after the epoch is added."""
        return self.seed % 2_000_000_000

    def hold(self, name: str, value: float) -> None:
        """A number that decides `correct`, beside its limit."""
        limit = self.cell.limits.get(name)
        self.checks[name] = {"value": value, "limit": limit}


def check_devices(chips: int) -> str:
    """The card's name; exits without a result unless `chips` cards are
    there."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device; a run needs the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} visible")
    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer(run: Run) -> Dict[str, dict]:
    out = {}
    for m in run.cell.per_layer:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(args: argparse.Namespace, t_start: float) -> Run:
    """Drive the cell's job once; the returned `Run` holds its metrics and
    checks."""
    cell = Cell(args.workload)
    if not args.rehearse:
        check_devices(cell.chips)
    run = Run(args, cell, t_start)
    job = load_module(HERE / "jobs" / f"{cell.traffic['job']}.py")
    run.work = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        job.run(run)
    finally:
        shutil.rmtree(run.work, ignore_errors=True)
    return run


def result(run: Run, device_name: str) -> dict:
    """The result line's object."""
    correct = bool(run.checks) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in run.checks.values())
    device = {"platform": "cpu" if run.rehearse else "gpu", "kind": device_name,
              "count": run.cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": correct, "attempted": run.attempted, "failed": 0}
    if run.args.trace:
        metrics = per_layer(run)
        device.update(busy_s=run.profile["busy_s"], window_s=run.profile["window_s"])
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    else:
        missing = [m["name"] for m in run.cell.end_to_end if m["name"] not in run.end_to_end]
        if missing:
            raise RuntimeError(f"the job read no {missing}")
        metrics = {m["name"]: {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in run.cell.end_to_end}
    if run.rehearse:
        out["rehearsal_metrics"] = metrics
    else:
        out["metrics"] = metrics
    out["device"] = device
    if run.control:
        out["control"] = run.control
    out["checks"] = run.checks
    return out


def main(t_start: float, argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    if args.list:
        for w in benchmark()["workloads"]:
            print(w["name"])
        return 0
    run = run_cell(args, t_start)
    loaded = forbidden_loaded()
    if loaded:
        print(f"portbench: the process loaded {loaded}; no result", file=sys.stderr)
        return 3
    name = "cpu (rehearsal)" if args.rehearse else check_devices(run.cell.chips)
    out = result(run, name)
    print(f"card: {'none' if args.rehearse else power_limit()}", file=sys.stderr)
    print("set-up: " + ", ".join(f"{n} at {t:.2f} s" for n, t in run.stages), file=sys.stderr)
    if run.readings.get("spans"):
        print(f"spans (seconds, calls) of the window: {run.readings['spans']}", file=sys.stderr)
        print(f"train epochs (s): {run.readings.get('epochs_s')}", file=sys.stderr)
    print(f"leaves: {run.readings.get('check_leaves')}", file=sys.stderr)
    for k, v in run.control.items():
        print(f"control {k}={v!r}", file=sys.stderr)
    for k, c in run.checks.items():
        print(f"check {k}={c['value']!r} limit={c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
