"""What a run imports: no module whose whole top-level name is `jax`,
`jaxlib`, `flax` or the JAX package (the port's name begins with the JAX
package's, so names are compared whole), and nothing of the program in the
reference."""

import ast
import json
import os
import subprocess
import sys

from portbench.tests.helpers import ROOT

from portbench import core

DRIVE = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench import core
run = core.run_cell(core.parse({argv!r}), time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_modules(code: str) -> list:
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_rehearsed_run_loads_no_jax():
    argv = ["--workload", "ipn_t354_b256.p1", "--seed", "21", "--seconds", "0.5", "--trace",
            "1", "--rehearse"]
    loaded = _top_modules(DRIVE.format(root=str(ROOT), argv=argv))
    assert "deep_interpolation_clustering_tpu_torch" in loaded
    assert not set(loaded) & set(core.FORBIDDEN), loaded


def test_the_reference_imports_nothing_of_the_program():
    program = "deep_interpolation_clustering_tpu_torch"
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in (program,) + core.FORBIDDEN, (path, name)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import portbench.reference.train, portbench.reference.compare; "
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    loaded = _top_modules(code)
    assert program not in loaded and not set(loaded) & set(core.FORBIDDEN), loaded
