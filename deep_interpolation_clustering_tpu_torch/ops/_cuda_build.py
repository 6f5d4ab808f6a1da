"""Build, load and wrap the port's hand-written CUDA kernels.

Each `csrc/*.cu` file has a plain C interface. At first use every source is
compiled by its own `nvcc` (all started together) into a shared library for
`sm_90a`, under `build/torch_kernels/<hash of the sources and flags>/` in
the checkout, and loaded with `ctypes`. Nothing is built when a module is
imported, so the package imports on a machine without CUDA.

`KernelWrapper` is the single entry of one kernel: a tensor on the CPU takes
the kernel's plain PyTorch version; a tensor on a CUDA device launches the
kernel on PyTorch's current stream or raises. It counts its launches. A
call made while a CUDA graph is being captured launches nothing: it counts
in `captured`, and the graph (`train/graphs.py`) adds the launches it
recorded to `launches` on each replay (`captured_counts`, `add_launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"
SOURCES = ("fake_select.cu", "sci.cu", "rbf.cu", "lstm.cu", "optim.cu", "mtan.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[str, Callable] = {}
build_log: Dict[str, str] = {}  # nvcc's output per source (ptxas register use), kept beside the .so
build_seconds: Optional[float] = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile (if not cached) and load every kernel library; returns them
    keyed by source stem."""
    global build_seconds
    if _libs:
        return _libs
    out_dir = BUILD_ROOT / _digest()
    missing = [n for n in SOURCES if not (out_dir / (Path(n).stem + ".so")).exists()]
    nvcc = nvcc_path() if missing else None
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in missing:
        so = out_dir / (Path(name).stem + ".so")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, err = proc.communicate()
        build_log[name] = out + err
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}{err}")
        else:
            so.with_suffix(".log").write_text(build_log[name])
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    for name in SOURCES:
        stem = Path(name).stem
        log = out_dir / (stem + ".log")
        if name not in build_log and log.exists():  # built by an earlier process
            build_log[name] = log.read_text()
        _libs[stem] = ctypes.CDLL(str(out_dir / (stem + ".so")))
    return _libs


def c_function(lib: str, symbol: str, n_ptr: int, n_int: int, n_double: int = 0) -> Callable:
    """The C entry `symbol` of library `lib`: `n_ptr` pointer arguments,
    then `n_int` int arguments, then `n_double` double arguments, then the
    stream; returns a CUDA error code."""
    if symbol not in _functions:
        fn = getattr(build_all()[lib], symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_double] * n_double + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _functions[symbol] = fn
    return _functions[symbol]


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {t.device}, but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, t: torch.Tensor, dtype: torch.dtype,
          shape: Optional[Sequence[int]] = None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and `shape`)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


class KernelWrapper:
    """One hand-written kernel: `plain(*args)` for CPU tensors,
    `launch(*args)` for CUDA tensors, and the count of launches."""

    def __init__(self, name: str, source: str, replaces: str,
                 plain: Callable, launch: Callable):
        self.name = name
        self.source = source  # path in the repo
        self.replaces = replaces  # file:line of the TPU kernel
        self.plain = plain
        self._launch = launch
        self.launches = 0
        self.captured = 0  # calls recorded into a CUDA graph being captured

    def __call__(self, *args):
        devices = {a.device.type for a in args if isinstance(a, torch.Tensor)}
        if devices == {"cpu"}:
            return self.plain(*args)
        if devices != {"cuda"}:
            raise ValueError(f"{self.name}: tensors on {sorted(devices)}; "
                             "expected all on the CPU or all on one CUDA device")
        out = self._launch(*args)
        if torch.version.cuda is not None and torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return out


KERNELS: List[KernelWrapper] = []


def register(w: KernelWrapper) -> KernelWrapper:
    KERNELS.append(w)
    return w


def reset_launch_counts() -> None:
    for w in KERNELS:
        w.launches = 0


def captured_counts() -> Dict[str, int]:
    """Each kernel's calls recorded into CUDA graphs so far."""
    return {w.name: w.captured for w in KERNELS}


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches of one replay of a graph that recorded `counts`."""
    for w in KERNELS:
        w.launches += counts.get(w.name, 0)
