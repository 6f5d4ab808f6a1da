"""Rows-per-block sweep of the biLSTM backward kernel B7 on the card.

    python -m deep_interpolation_clustering_tpu_torch.utils.lstm_rows_sweep [--rows 4 8 16]

`csrc/lstm.cu` fixes the batch rows per block of the recurrence backward as
the constant `kBwdRows` (`cuda_lstm.BWD_ROWS` in the wrapper). This script
builds a copy of the source for each value asked for (one `nvcc` each, all
started together, under `build/torch_kernels/rows_sweep/`), then, at the
encoder's shape (T=6, B=512, H=128, no state) and the decoder's (B=256,
seeded with h0/c0), checks each build's whole B7 call against the plain
version (1e-4 of each output's largest element) and times it as
`chip_smoke.py` does (`utils/cuda_timing.time_ms`: median of 50 calls, L2
flushed before each). It prints ptxas's line for `lstm_bwd_kernel` of each
build, one JSON object per (rows, shape), and the card's name and power
limit. It needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import numpy as np
import torch

from ..ops import _cuda_build as cb
from ..ops import cuda_lstm as cl
from .cuda_timing import time_ms
from .device import resolve_device

H, T_REF = 128, 6  # Config().lstm_hidden; the R=6 reference points
SHAPES = (("encoder", 512, False), ("decoder", 256, True))
_ROWS_LINE = re.compile(r"constexpr int kBwdRows = \d+;")


def build(rows_list):
    """One library per rows value -> {rows: (dicl_lstm_bwd, ptxas line)}."""
    out_dir = cb.BUILD_ROOT / "rows_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (cb.CSRC_DIR / "lstm.cu").read_text()
    if not _ROWS_LINE.search(src):
        raise RuntimeError("csrc/lstm.cu has no `constexpr int kBwdRows = N;` line")
    procs = {}
    for rows in rows_list:
        cu = out_dir / f"lstm_rows{rows}.cu"
        cu.write_text(_ROWS_LINE.sub(f"constexpr int kBwdRows = {rows};", src))
        so = cu.with_suffix(".so")
        procs[rows] = (subprocess.Popen([cb.nvcc_path(), *cb.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), so)
    libs = {}
    for rows, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for kBwdRows = {rows}:\n{err}")
        lines = err.splitlines()
        at = next((i for i, ln in enumerate(lines)
                   if "lstm_bwd_kernel" in ln and "Compiling" in ln), len(lines))
        regs = next((ln.split("ptxas info    : ")[-1] for ln in lines[at:] if "registers" in ln),
                    "no ptxas line")
        fn = ctypes.CDLL(str(so)).dicl_lstm_bwd
        fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[rows] = (fn, regs)
    return libs


def inputs(b, with_state, gen, dev):
    """The forward's inputs and outputs and random cotangents, as the
    backward takes them."""
    bnd = 1.0 / np.sqrt(H)
    uni = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bnd
    xgf, xgb = (torch.randn((T_REF, b, 4 * H), generator=gen, device=dev) for _ in range(2))
    w_hhT, b_hh = uni(2, H, 4 * H), uni(2, 4 * H)
    state = [torch.randn((2, b, H), generator=gen, device=dev) * 0.5 if with_state
             else torch.zeros((2, b, H), device=dev) for _ in range(2)]
    ins = [xgf, xgb, w_hhT, b_hh, *state]
    outs = cl.lstm_forward(*ins)
    cots = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
    return (*ins[:3], w_hhT.transpose(1, 2).contiguous(), *ins[3:], *outs, *cots)


def backward_with(fn, rows, args):
    """The wrapper's launch of B7 through the build `fn` with `rows` rows."""
    t_len, b, four_h = args[0].shape
    hidden = four_h // 4
    geo = cl.backward_geometry(t_len, b, hidden, rows)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=args[0].device)
    res = [new(t_len, b, four_h), new(t_len, b, four_h), new(2, hidden, four_h),
           new(2, four_h), new(2, b, hidden), new(2, b, hidden)]
    scratch = [new(geo.nsplit, 2, hidden, four_h), new(geo.nsplit, 2, four_h)]
    cb.raise_on_error("lstm_backward", fn(
        *(cb.ptr(a) for a in (*args, *res, *scratch)),
        t_len, b, hidden, rows, geo.threads, geo.nsplit, geo.chunk, cb.stream_of(args[0])))
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 8, 16])
    rows_list = ap.parse_args().rows
    if not torch.cuda.is_available():
        raise SystemExit("lstm_rows_sweep: no CUDA device")
    dev = resolve_device("cuda")  # TF32 off
    libs = build(rows_list)
    for rows, (_, regs) in libs.items():
        print(f"[ptxas] kBwdRows={rows} lstm_bwd_kernel: {regs}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, b, with_state in SHAPES:
        args = inputs(b, with_state, gen, dev)
        want = cl._recurrence_bwd_plain(*args)
        for rows, (fn, _) in libs.items():
            got = backward_with(fn, rows, args)
            again = backward_with(fn, rows, args)
            rel = max(float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                      for a, w in zip(got, want))
            same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
            if not (rel <= 1e-4 and same):
                raise AssertionError(f"rows={rows} {tag}: rel err {rel}, repeat equal {same}")
            geo = cl.backward_geometry(T_REF, b, H, rows)
            print(json.dumps({
                "rows": rows, "shape": tag, "T": T_REF, "B": b, "H": H,
                "blocks": geo.blocks, "threads": geo.threads, "smem_bytes": geo.smem_bytes,
                "max_rel_err": rel, "ms": time_ms(lambda: backward_with(fn, rows, args)),
            }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
