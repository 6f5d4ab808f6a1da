#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; a failing phase raises and the exit code is
not 0):
  1. device  - require CUDA, print the card, TF32 off
  2. build   - compile the kernels in csrc/ with nvcc for sm_90a
  3. kernels - each kernel against its plain PyTorch version at the p1
               step's shapes (B=256, C=6, T=354, R=6), timed with CUDA events
  4. main    - the p1 trainer at the default Config width takes 8 steps and
               one eval forward on a synthetic T=354 cohort; the kernels'
               launch counters must show the path went through them
  5. plain   - one train step with the kernels and one with their plain
               versions, from the same weights and draws, must agree
Then a `{"kernels": [...]}` line, the card's name and power limit from
nvidia-smi, and as the last line `{"ok": true, "device": {...}}`.

Imports nothing of JAX. Needs one card; builds under build/torch_kernels/.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside the
# tensor cores. The expf rate is the SFU's (16 results per clock per SM on
# compute capability 9.0, CUDA C Programming Guide throughput table) x 132
# SMs x the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
EXPF_PER_S = 16 * 132 * 1.98e9
L2_FLUSH_BYTES = 64 << 20  # more than the card's 50 MB L2
SPIN_CYCLES = 4_000_000  # ~2 ms at the boost clock

B, C, T, R = 256, 6, 354, 6
N_TRAIN = 2048
STEPS = 8


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def time_ms(fn, reps: int = 50, warmup_s: float = 0.2) -> float:
    """Median over `reps` calls of `fn`, each between two CUDA events and
    each after the L2 cache was flushed (the bound counts device-memory
    bytes). Before each start event the card spins for about 2 ms, so the
    host has queued all of `fn`'s launches before the card reaches them:
    the events then time the device's work, not the host's launch
    overhead. A warm-up of `warmup_s` seconds first brings the card's clocks
    up from idle."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < warmup_s:
        flush.zero_()
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(n_bytes: float, n_flop: float, n_expf: float):
    """Least time in ms: the bytes at the HBM rate, or the float32
    operations and the expf at their peak rates, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_flop / FP32_FLOP_PER_S, n_expf / EXPF_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main() -> None:
    import torch

    # ---------------------------------------------------------------- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import deep_interpolation_clustering_tpu_torch as port

    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        raise SystemExit(f"chip_smoke: the port was imported from {port.__file__}, "
                         f"not from this checkout")
    from deep_interpolation_clustering_tpu_torch import Config
    from deep_interpolation_clustering_tpu_torch.data import (
        ArrayDataset, make_synthetic_cohorts, process_splits,
    )
    from deep_interpolation_clustering_tpu_torch.data.loader import draw_bits
    from deep_interpolation_clustering_tpu_torch.models import Net
    from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
    from deep_interpolation_clustering_tpu_torch.ops import cuda_interp as ci
    from deep_interpolation_clustering_tpu_torch.ops import cuda_select as cs
    from deep_interpolation_clustering_tpu_torch.ops.interpolation import reference_times
    from deep_interpolation_clustering_tpu_torch.train import (
        Trainer, build_inputs, gather_batch, make_optimizer, update,
    )
    from deep_interpolation_clustering_tpu_torch.utils import resolve_device

    dev = resolve_device("cuda")  # TF32 off
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("device", name=repr(kind), count=torch.cuda.device_count(),
        tf32=torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32,
        torch=torch.__version__, cuda=torch.version.cuda)

    # ----------------------------------------------------------------- 2. build
    cb.build_all()
    regs = [ln.split("ptxas info    : ")[-1] for log in cb.build_log.values()
            for ln in log.splitlines() if "registers" in ln]
    say("build", seconds=f"{cb.build_seconds:.1f}", sources=len(cb.SOURCES),
        ptxas=json.dumps(regs))

    # ------------------------------------------------------- 3. kernels vs plain
    cfg = Config()
    cohorts = process_splits(
        make_synthetic_cohorts(n_total=int(np.ceil(N_TRAIN / 0.7)) + 1,
                               max_obs=T, seed=cfg.seed),
        rng=np.random.RandomState(0),
    )
    assert cohorts["training"]["feat"].shape[1:] == (C, T)
    datasets = {k: ArrayDataset(cfg, d, k) for k, d in cohorts.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {k: torch.as_tensor(v, device=dev) for k, v in datasets["training"].arrays().items()}
    batch = gather_batch(data, torch.arange(B, device=dev))
    rows = B * C
    x2 = (batch["ob"] * batch["padding_mask"]).reshape(rows, T).contiguous()
    m2 = batch["padding_mask"].reshape(rows, T).contiguous()
    t2 = batch["timestamp"].reshape(rows, T).contiguous()
    n_valid = m2.sum(1).to(torch.int32)
    k_sel = torch.where(n_valid > 0, torch.clamp(n_valid // 2, min=1),
                        torch.zeros_like(n_valid))
    n_obs = float(m2.sum())
    bits = draw_bits((rows, T), gen, dev)
    alpha = torch.rand(C, generator=gen, device=dev) + 0.5
    ref_t = reference_times(R, cfg.hours_from_admission, device=dev)
    g = torch.randn((B, R, 3 * C), generator=gen, device=dev)
    proj = torch.randn((rows, R), generator=gen, device=dev)
    f32 = 4
    report = {}

    # K1: bit-identical
    got, want = cs.fake_select(bits, n_valid, k_sel), cs._select_sort(bits, n_valid, k_sel)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"fake_select differs from the sort oracle at "
                             f"{int((got != want).sum())} slots")
    if not torch.equal(got.sum(1).to(torch.int32), k_sel):
        raise AssertionError("fake_select did not take exactly k per row")
    report["fake_select"] = dict(
        max_abs_err=0.0, tolerance="bit-identical",
        ms=time_ms(lambda: cs.fake_select(bits, n_valid, k_sel)),
        plain_ms=time_ms(lambda: cs._select_sort(bits, n_valid, k_sel)),
        library_ms=time_ms(lambda: torch.sort(bits, dim=-1)),
        # integer work only: the bits in, n_valid and k in, the mask out
        bytes=rows * T * (4 + 1) + rows * 8, flop=0, expf=0,
    )

    # K2: forward within 1e-5 max abs
    got = ci.sci_fwd(x2, t2, m2, alpha, ref_t)
    want = ci._sci_fwd_plain(x2, t2, m2, alpha, ref_t)
    err = float((got - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"sci_forward max abs err {err} > 1e-5")
    report["sci_forward"] = dict(
        max_abs_err=err, tolerance=1e-5,
        ms=time_ms(lambda: ci.sci_fwd(x2, t2, m2, alpha, ref_t)),
        plain_ms=time_ms(lambda: ci._sci_fwd_plain(x2, t2, m2, alpha, ref_t)),
        library_ms=None,
        # per observed slot and r: ~12 float32 operations and 2 expf
        bytes=3 * rows * T * f32 + B * R * 3 * C * f32, flop=12 * R * n_obs,
        expf=2 * R * n_obs,
    )

    # K3: each cotangent within 1e-4 of its max |value|; dm where mask = 1
    got = ci.sci_bwd(x2, t2, m2, alpha, ref_t, g, True)
    want = ci._sci_bwd_plain(x2, t2, m2, alpha, ref_t, g, True)
    obs = m2 > 0
    errs, rels = [], []
    for name, a, b_ in zip(("dx", "dt", "dm", "dalpha"), got, want):
        if name == "dm":
            a, b_ = a[obs], b_[obs]
        e = float((a - b_).abs().max())
        rel = e / max(float(b_.abs().max()), 1e-30)
        errs.append(e)
        rels.append(rel)
        if not rel <= 1e-4:
            raise AssertionError(f"sci_backward {name}: err {e} is {rel:.2e} of max|{name}|")
    report["sci_backward"] = dict(
        max_abs_err=max(errs), tolerance="1e-4 x max|grad| per output",
        max_rel_err=max(rels),
        # timed as the train step calls it: dalpha only
        ms=time_ms(lambda: ci.sci_bwd(x2, t2, m2, alpha, ref_t, g, False)),
        plain_ms=time_ms(lambda: ci._sci_bwd_plain(x2, t2, m2, alpha, ref_t, g, False)),
        library_ms=None,
        # the forward's work plus ~11 operations for the cotangent sums
        bytes=3 * rows * T * f32 + B * R * 3 * C * f32 + rows * f32,
        flop=23 * R * n_obs, expf=2 * R * n_obs,
    )

    # K4: forward within 1e-5 max abs
    beta = alpha + 0.25
    got = ci.rbf_push_k(t2, m2, proj, beta, ref_t)
    want = ci._rbf_plain(t2, m2, proj, beta, ref_t)
    err = float((got - want).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"rbf_push max abs err {err} > 1e-5")
    report["rbf_push"] = dict(
        max_abs_err=err, tolerance=1e-5,
        ms=time_ms(lambda: ci.rbf_push_k(t2, m2, proj, beta, ref_t)),
        plain_ms=time_ms(lambda: ci._rbf_plain(t2, m2, proj, beta, ref_t)),
        library_ms=None,
        # per observed slot and r: ~7 float32 operations and 1 expf
        bytes=3 * rows * T * f32 + rows * R * f32, flop=7 * R * n_obs, expf=R * n_obs,
    )
    for name, r in report.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flop"), r.pop("expf"))
        say("kernels", name=name, max_abs_err=f"{r['max_abs_err']:.3g}",
            ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"])

    # ------------------------------------------------------------ 4. main path
    trainer = Trainer(cfg, {"training": datasets["training"],
                            "validation": datasets["validation"]}, device=dev)
    before = {n: p.detach().clone() for n, p in trainer.net.named_parameters()}
    cb.reset_launch_counts()
    losses = trainer.train_steps(2)  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += trainer.train_steps(STEPS - 2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    latent = trainer.eval_batch("validation")
    torch.cuda.synchronize()
    launches = {w.name: w.launches for w in cb.KERNELS}
    for step_losses in losses:
        for k, v in step_losses.items():
            if not torch.isfinite(v):
                raise AssertionError(f"loss {k} is not finite: {float(v)}")
    if tuple(latent.shape) != (B, cfg.dim_enc_hidden) or not torch.isfinite(latent).all():
        raise AssertionError(f"eval latents: shape {tuple(latent.shape)}, "
                             f"finite {bool(torch.isfinite(latent).all())}")
    unchanged = [n for n, p in trainer.net.named_parameters() if torch.equal(p, before[n])]
    if unchanged:
        raise AssertionError(f"parameters unchanged after {STEPS} steps: {unchanged}")
    need = {"fake_select": STEPS, "sci_forward": 2 * STEPS,
            "sci_backward": 2 * STEPS, "rbf_push": STEPS}
    short = {k: (launches[k], n) for k, n in need.items() if launches[k] < n}
    if short:
        raise AssertionError(f"kernel launches below the path's count: {short}")
    steps_per_s = (STEPS - 2) / dt
    say("main", steps=STEPS, batch=B, T=T, loss=f"{float(losses[-1]['loss']):.5f}",
        steps_per_s=f"{steps_per_s:.2f}", encounters_per_s=f"{steps_per_s * B:.1f}",
        latent=tuple(latent.shape), launches=json.dumps(launches), card=repr(smi))

    # ------------------------------------------------- 5. main path vs plain
    cfg0 = cfg.replace(dropout=0.0)
    net_k = Net(cfg0, generator=torch.Generator().manual_seed(1)).to(dev)
    net_p = copy.deepcopy(net_k)
    draws = {
        "fake_bits": draw_bits((B, C, T), gen, dev),
        "fake_noise": torch.rand((B, C, T), generator=gen, device=dev),
        "perm": torch.randperm(2 * B, generator=gen, device=dev),
    }
    out = {}
    for use_kernels, net in ((True, net_k), (False, net_p)):
        inputs = build_inputs(cfg0, batch, None, True, False, draws, use_kernels)
        out[use_kernels] = update(net, make_optimizer(cfg0, net.parameters()), cfg0,
                                  inputs, None, use_kernels)
    for k in out[True]:
        a, b_ = float(out[True][k]), float(out[False][k])
        if not abs(a - b_) <= 1e-5 * max(1.0, abs(b_)):
            raise AssertionError(f"loss {k}: kernels {a} vs plain {b_}")
    # the repo's parameter-parity rule after an Adam step: elements with
    # |grad| near Adam's eps move by lr*g/(|g|+eps), so a few may differ by
    # more than 1e-5; at most 0.01% of them, each below 1e-3
    n_viol = n_tot = 0
    worst = 0.0
    plain_params = {n: p.detach() for n, p in net_p.named_parameters()}
    for n, p in net_k.named_parameters():
        p = p.detach()
        d = (p - plain_params[n]).abs()
        worst = max(worst, float(d.max()))
        n_viol += int((d > 1e-5 + 1e-5 * plain_params[n].abs()).sum())
        n_tot += d.numel()
    if worst >= 1e-3 or n_viol > max(1, n_tot // 10_000):
        raise AssertionError(f"params after one step: max diff {worst}, "
                             f"{n_viol}/{n_tot} beyond 1e-5")
    say("plain", max_param_diff=f"{worst:.3g}", beyond_1e5=f"{n_viol}/{n_tot}",
        loss=f"{float(out[True]['loss']):.6f}")

    kernels = []
    for w in cb.KERNELS:
        r = report[w.name]
        kernels.append({
            "name": w.name, "route": "cuda", "source": w.source, "replaces": w.replaces,
            "launches": launches[w.name], "max_abs_err": r["max_abs_err"],
            "tolerance": r["tolerance"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
