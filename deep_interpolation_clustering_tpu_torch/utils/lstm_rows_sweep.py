"""Rows-per-block sweep of the biLSTM kernels B6 and B7 on the card.

    python -m deep_interpolation_clustering_tpu_torch.utils.lstm_rows_sweep [--rows 4 8 16] [--t_len 6]

`csrc/lstm.cu` fixes the batch rows per block of the recurrence as the
constants `kRows` (forward; `cuda_lstm.FWD_ROWS` in the wrapper) and
`kBwdRows` (backward; `cuda_lstm.BWD_ROWS`). This script builds a copy of
the source for each value asked for, with both constants set to it (one
`nvcc` each, all started together, under `build/torch_kernels/rows_sweep/`),
then, at the encoder's shape (T=6, B=512, H=128, no state) and the decoder's
(B=256, seeded with h0/c0), checks each build's B6 call (1e-5) and whole B7
call (1e-4 of each output's largest element) against the plain versions,
checks that two runs give the same bits, and times both as `chip_smoke.py`
does (`utils/cuda_timing.time_ms`: median of 50 calls, L2 flushed before
each). It prints ptxas's lines for `lstm_fwd_kernel` and `lstm_bwd_kernel`
of each build, one JSON object per (rows, shape), and the card's name and
power limit. `--t_len` changes the number of steps (the main path's is 6):
two values of it split a kernel's time into its start and its cost per
step. It needs a CUDA card and `nvcc`.
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
_ROWS_LINES = {name: re.compile(rf"constexpr int {name} = \d+;") for name in ("kRows", "kBwdRows")}


def _ptxas_lines(log, kernel):
    """ptxas's register lines for every instance of `kernel` in nvcc's log."""
    lines = log.splitlines()
    found = []
    for i, ln in enumerate(lines):
        if kernel in ln and "Compiling" in ln:
            found += [x.split("ptxas info    : ")[-1] for x in lines[i:i + 4] if "registers" in x]
    return found or ["no ptxas line"]


def build(rows_list):
    """One library per rows value -> {rows: (dicl_lstm_fwd, dicl_lstm_bwd,
    {kernel: ptxas lines})}."""
    out_dir = cb.BUILD_ROOT / "rows_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (cb.CSRC_DIR / "lstm.cu").read_text()
    for name, line in _ROWS_LINES.items():
        if len(line.findall(src)) != 1:
            raise RuntimeError(f"csrc/lstm.cu has no single `constexpr int {name} = N;` line")
    procs = {}
    for rows in rows_list:
        cu = out_dir / f"lstm_rows{rows}.cu"
        text = src
        for name, line in _ROWS_LINES.items():
            text = line.sub(f"constexpr int {name} = {rows};", text)
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[rows] = (subprocess.Popen([cb.nvcc_path(), *cb.NVCC_FLAGS, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), so)
    libs = {}
    for rows, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {rows} rows:\n{err}")
        lib = ctypes.CDLL(str(so))
        fwd, bwd = lib.dicl_lstm_fwd, lib.dicl_lstm_bwd
        fwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fwd.restype = bwd.restype = ctypes.c_int
        libs[rows] = (fwd, bwd, {k: _ptxas_lines(err, k)
                                 for k in ("lstm_fwd_kernel", "lstm_bwd_kernel")})
    return libs


def inputs(t_len, b, with_state, gen, dev):
    """The forward's inputs (the first three and the three after `w_hh`),
    its outputs and random cotangents, as the backward takes them."""
    bnd = 1.0 / np.sqrt(H)
    uni = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bnd
    xgf, xgb = (torch.randn((t_len, b, 4 * H), generator=gen, device=dev) for _ in range(2))
    w_hhT, b_hh = uni(2, H, 4 * H), uni(2, 4 * H)
    state = [torch.randn((2, b, H), generator=gen, device=dev) * 0.5 if with_state
             else torch.zeros((2, b, H), device=dev) for _ in range(2)]
    ins = [xgf, xgb, w_hhT, b_hh, *state]
    outs = cl.lstm_forward(*ins)
    cots = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
    return (*ins[:3], w_hhT.transpose(1, 2).contiguous(), *ins[3:], *outs, *cots)


def forward_with(fn, rows, ins):
    """The wrapper's launch of B6 through the build `fn` with `rows` rows."""
    t_len, b, four_h = ins[0].shape
    hidden = four_h // 4
    geo = cl.forward_geometry(b, hidden, rows)
    outs = [torch.empty((t_len, b, hidden), dtype=torch.float32, device=ins[0].device)
            for _ in range(4)]
    cb.raise_on_error("lstm_forward", fn(
        *(cb.ptr(a) for a in (*ins, *outs)), t_len, b, hidden, rows, geo.threads,
        geo.smem_bytes, cb.stream_of(ins[0])))
    return outs


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
    ap.add_argument("--t_len", type=int, default=T_REF)
    opts = ap.parse_args()
    rows_list, t_len = opts.rows, opts.t_len
    if not torch.cuda.is_available():
        raise SystemExit("lstm_rows_sweep: no CUDA device")
    dev = resolve_device("cuda")  # TF32 off
    libs = build(rows_list)
    for rows, (_, _, regs) in libs.items():
        for kernel, lines in regs.items():
            print(f"[ptxas] rows={rows} {kernel}: {' | '.join(lines)}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, b, with_state in SHAPES:
        args = inputs(t_len, b, with_state, gen, dev)
        ins = (*args[:3], *args[4:7])
        want_f = cl.recurrence_plain(*ins)
        want = cl._recurrence_bwd_plain(*args)
        for rows, (fwd, bwd, _) in libs.items():
            outs, outs2 = forward_with(fwd, rows, ins), forward_with(fwd, rows, ins)
            err_f = max(float((a - w).abs().max()) for a, w in zip(outs, want_f))
            got, again = backward_with(bwd, rows, args), backward_with(bwd, rows, args)
            rel = max(float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                      for a, w in zip(got, want))
            same = all(torch.equal(a, a2) for a, a2 in zip((*outs, *got), (*outs2, *again)))
            if not (err_f <= 1e-5 and rel <= 1e-4 and same):
                raise AssertionError(f"rows={rows} {tag}: forward err {err_f}, backward rel "
                                     f"err {rel}, repeat equal {same}")
            fgeo = cl.forward_geometry(b, H, rows)
            geo = cl.backward_geometry(t_len, b, H, rows)
            print(json.dumps({
                "rows": rows, "shape": tag, "T": t_len, "B": b, "H": H,
                "forward": {"blocks": fgeo.blocks, "threads": fgeo.threads,
                            "smem_bytes": fgeo.smem_bytes, "resident_rows": fgeo.resident_rows,
                            "max_abs_err": err_f,
                            "ms": time_ms(lambda: forward_with(fwd, rows, ins))},
                "backward": {"blocks": geo.blocks, "threads": geo.threads,
                             "smem_bytes": geo.smem_bytes, "max_rel_err": rel,
                             "ms": time_ms(lambda: backward_with(bwd, rows, args))},
            }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
