"""A cell is added by files and an entry alone: a copy of the harness with
one more traffic file and workload lists the cell and rehearses it on the
CPU, with no file of the harness edited."""

import json
import os
import shutil
import subprocess
import sys

from portbench.tests.helpers import ROOT


def test_a_new_cell_needs_no_edit(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    traffic = json.loads((ROOT / "portbench" / "traffic" / "p1_eval1.json").read_text())
    traffic["program"] = dict(traffic["program"], eval_interval=2)
    (tmp_path / "portbench" / "traffic" / "p1_eval2.json").write_text(json.dumps(traffic))
    bench["workloads"].append({"name": "ipn_t354_b256.p1_eval2", "config": "ipn_t354_b256",
                               "traffic": "p1_eval2", "chips": 1, "why": "a test's cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "ipn_t354_b256.p1" in m["workloads"]:
            m["workloads"].append("ipn_t354_b256.p1_eval2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    limits = tmp_path / "portbench" / "limits"
    shutil.copy(limits / "ipn_t354_b256.p1.json", limits / "ipn_t354_b256.p1_eval2.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT))  # the program, beside the copy
    run = lambda *a: subprocess.run([sys.executable, "portbench/run.py", *a], cwd=tmp_path,
                                    capture_output=True, text=True, timeout=600, env=env)
    listed = run("--list")
    assert "ipn_t354_b256.p1_eval2" in listed.stdout.split()
    out = run("--workload", "ipn_t354_b256.p1_eval2", "--seed", "31", "--seconds", "0.5",
              "--rehearse")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["rehearsal_metrics"]) == {"p1_enc_per_s", "setup_s"}


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ipn_t354_b256.p1",
                          "--seed", "1", "--seconds", "1", "--rehearse"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode != 0 and not out.stdout.strip()
