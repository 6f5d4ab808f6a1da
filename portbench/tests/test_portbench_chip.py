"""Each cell on the card, once, short: `correct` and every metric of its
line. Skips without a CUDA card (decided inside the test)."""

import json
import subprocess
import sys

import pytest
import torch

from portbench.tests.helpers import ROOT, core


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_each_cell_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = core.benchmark()
    for w in bench["workloads"]:
        out = subprocess.run([sys.executable, "portbench/run.py", "--workload", w["name"],
                              "--seed", "41", "--seconds", "2", "--trace", str(trace)],
                             cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line["checks"]
        cell = core.Cell(w["name"])
        want = cell.per_layer if trace else cell.end_to_end
        assert set(line["metrics"]) == {m["name"] for m in want}
