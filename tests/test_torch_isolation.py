"""The port stands alone: it imports nothing of JAX or of the JAX package,
runs on the card unless told otherwise, and its kernel wrappers take the
plain versions only for tensors on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import deep_interpolation_clustering_tpu_torch as port
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
from deep_interpolation_clustering_tpu_torch.ops import cuda_interp, cuda_lstm, cuda_mtan, cuda_optim, cuda_select  # noqa: F401 (registers the kernels)
from deep_interpolation_clustering_tpu_torch.train import Trainer

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "optax", "deep_interpolation_clustering_tpu")


def _port_files():
    return sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__"):
            yield from (a.value for a in node.args[:1] if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), str(path))
    bad = [n for n in _imported_names(tree) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_imports_with_jax_blocked():
    """Import every module of the port and chip_smoke in a fresh process
    whose import system raises on the forbidden names."""
    modules = sorted(
        "deep_interpolation_clustering_tpu_torch." + ".".join(
            p.relative_to(PORT_DIR).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_DIR.rglob("*.py")
    )
    code = f"""
import importlib, sys
FORBIDDEN = {FORBIDDEN!r}
for name in list(sys.modules):
    if name.split(".")[0] in FORBIDDEN:
        del sys.modules[name]
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError("forbidden import: " + name)
sys.meta_path.insert(0, Block())
for m in {modules!r} + ["chip_smoke"]:
    importlib.import_module(m)
leaked = [n for n in sys.modules if n.split(".")[0] in FORBIDDEN]
assert not leaked, leaked
print("ok", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_trainer_without_device_raises_when_no_card(monkeypatch, tmp_path):
    """No device given means the card; without one the trainer raises and
    does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(batch_size=2, num_timestamps=8, lstm_hidden=4, head_hidden=4), {},
                str(tmp_path))


def _fake_cuda_args(wrapper):
    """Arguments of the wrapper's kernel as CUDA tensors without a card."""
    rows, c, t, r = 12, 6, 40, 6
    b, h = 5, 16
    with FakeTensorMode():
        plane = lambda: torch.zeros(rows, t, device="cuda")
        ref_t = torch.linspace(0.0, 6.0, r, device="cuda")
        alpha = torch.ones(c, device="cuda")
        if wrapper.name in ("fake_select", "fake_select_packed"):
            vec = lambda: torch.ones(rows, dtype=torch.int32, device="cuda")
            return (torch.zeros(rows, t, dtype=torch.int32, device="cuda"), vec(), vec())
        if wrapper.name.startswith("lstm_"):
            xg = lambda: torch.zeros(r, b, 4 * h, device="cuda")
            state = lambda: torch.zeros(2, b, h, device="cuda")
            w_hhT, b_hh = torch.zeros(2, h, 4 * h, device="cuda"), torch.zeros(2, 4 * h, device="cuda")
            if wrapper.name == "lstm_forward":
                return (xg(), xg(), w_hhT, b_hh, state(), state())
            seq = lambda: torch.zeros(r, b, h, device="cuda")
            return (xg(), xg(), w_hhT, torch.zeros(2, 4 * h, h, device="cuda"), b_hh,
                    state(), state(), *(seq() for _ in range(8)))
        if wrapper.name == "clip_adam":
            leaf = tuple(torch.zeros(b, h, device="cuda") for _ in range(5)) + (
                torch.zeros((), dtype=torch.float64, device="cuda"),)
            return (torch.zeros((), device="cuda"), [leaf], torch.tensor(1e-3, device="cuda"),
                    (15.0, 0.0, 0.9, 0.999, 1e-8))
        if wrapper.name.startswith("mtan_"):
            q, k = torch.zeros(r, 8, device="cuda"), torch.zeros(rows, t, 8, device="cuda")
            if wrapper.name == "mtan_attn_fwd":
                return (q, k, plane(), plane(), 0.25)
            vec = lambda: torch.zeros(rows, r, device="cuda")
            return (q, k, plane(), plane(), vec(), vec(), vec(), vec(), vec(), 0.25)
        if wrapper.name == "sci_forward":
            return (plane(), plane(), plane(), alpha, ref_t)
        if wrapper.name == "sci_backward":
            g = torch.zeros(rows // c, r, 3 * c, device="cuda")
            return (plane(), plane(), plane(), alpha, ref_t, g, True)
        return (plane(), plane(), torch.zeros(rows, r, device="cuda"), alpha, ref_t)


def _no_plain(*_):
    raise AssertionError("the plain version ran for a CUDA tensor")


KERNEL_NAMES = ["fake_select", "fake_select_packed", "sci_forward", "sci_backward",
                "rbf_push", "lstm_forward", "lstm_backward", "clip_adam", "mtan_attn_fwd",
                "mtan_attn_bwd"]


def test_every_kernel_is_covered():
    assert sorted(w.name for w in cb.KERNELS) == sorted(KERNEL_NAMES)


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_wrapper_launches_for_cuda_tensors(monkeypatch, name):
    """A CUDA tensor goes to the kernel's launch (and is counted), never to
    the plain version."""
    wrapper = next(w for w in cb.KERNELS if w.name == name)
    called = []
    monkeypatch.setattr(wrapper, "plain", _no_plain)
    monkeypatch.setattr(wrapper, "_launch", lambda *a: called.append(a) or "out")
    monkeypatch.setattr(wrapper, "launches", 0)
    assert wrapper(*_fake_cuda_args(wrapper)) == "out"
    assert len(called) == 1 and wrapper.launches == 1


@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_wrapper_raises_without_cuda(monkeypatch, name):
    """Without a card and a toolkit the launch raises: no fallback, no count."""
    wrapper = next(w for w in cb.KERNELS if w.name == name)
    monkeypatch.setattr(wrapper, "plain", _no_plain)
    monkeypatch.setattr(wrapper, "launches", 0)
    with pytest.raises((RuntimeError, AssertionError, ValueError)) as err:
        wrapper(*_fake_cuda_args(wrapper))
    assert "plain version ran" not in str(err.value)
    assert wrapper.launches == 0


def test_wrapper_rejects_mixed_devices():
    wrapper = next(w for w in cb.KERNELS if w.name == "rbf_push")
    args = list(_fake_cuda_args(wrapper))
    args[0] = torch.zeros(12, 40)  # one plane on the CPU
    with pytest.raises(ValueError, match="expected all on the CPU"):
        wrapper(*args)


def test_wrapper_takes_plain_version_on_cpu():
    wrapper = next(w for w in cb.KERNELS if w.name == "rbf_push")
    t = torch.rand(12, 40) * 6.0
    m = (torch.rand(12, 40) > 0.3).float()
    proj = torch.randn(12, 6)
    beta, ref_t = torch.ones(6), torch.linspace(0.0, 6.0, 6)
    before = wrapper.launches
    torch.testing.assert_close(wrapper(t, m, proj, beta, ref_t),
                               cuda_interp._rbf_plain(t, m, proj, beta, ref_t),
                               rtol=0, atol=0)
    assert wrapper.launches == before  # a CPU call is not a launch
