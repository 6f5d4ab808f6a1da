#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints one line; a failing phase raises and the exit code is
not 0):
  1. device  - require CUDA, print the card, TF32 off
  2. build   - compile the kernels in csrc/ with nvcc for sm_90a
  3. kernels - each kernel against its plain PyTorch version at the p1
               step's shapes (B=256, C=6, T=354, R=6; the biLSTMs at R=6,
               H=128, the encoder's B=512, the decoder's B=256 with h0/c0
               and the encoder's B=768 of p3's triplet stream
               (`triplet_ms`); the packed select, the SCI forward and backward and
               the RBF push at the scaled B=4096, T=48 too), timed with CUDA
               events beside a PyTorch library call; the select also at
               T = 256, 354, 512, 1024, 2048 and 4096 (the last two walked
               by a block of 8 warps) and the packed select at T = 16, 48,
               96 and 192 (`by_t`, each beside `torch.sort` of its bits);
               both selects on 16-bit keys (`bits16`: the select at T=354,
               the packed one at T=48, as `rng_draw_bits=16` draws them);
               the selects, the SCI forward and the RBF push also on one
               encounter's rows (`few_rows_ms`, a call's fixed cost); the
               SCI forward and the biLSTM kernels must repeat bit for bit;
               the optimizer tail's kernel pair at the Net's 37 leaves
               against the clip and the card's Adam (`optim_kernels`), the
               pair and that plain tail also replayed from CUDA graphs
               (`pair_ms`, `plain_tail_ms`); mTAN's encoder attention pair
               at the mtan_t354_b256 cell's shapes (`mtan_kernels`: 1,536
               heads of 354 slots, counts uniform on 4..354, R = D = 128)
               against its plain version and its bound
  4. main    - the p1 trainer at the default Config width takes 8 steps and
               one eval forward on a synthetic T=354 cohort; the kernels'
               launch counters must show the path went through them; then
               the bare step's ms with `fused_heads` and with
               `rng_draw_bits=16` beside the default, in turns
  5. scaled  - the trainer at B=4096, T=48 (the 100k-encounter scale
               configuration) runs two epochs of a cohort with a ragged
               368-encounter tail, fused (the default: replays of captured
               CUDA graphs); the second is timed and counted
  6. plain   - one train step with the kernels and one with their plain
               versions, from the same weights and draws, must agree; so
               must one masked tail step at the scaled configuration, one
               DEC step (the p3 loss, with the KL term and the centres), one
               DEC step with the triplet stream on, whose encoder runs
               B6/B7 at 3 x 256 rows, one step with `fused_heads` and one
               with 16-bit draws; and the fused kernel step's forward must
               give the unfused one's reconstruction, heads and BatchNorm
               statistics (1e-5)
  7. p0      - the p0 entry point (`cli.p0.main --synthetic 3000
               --synthetic_max_obs 354`) writes the p1 phase's pickles
               (2,100 / 450 / 450 encounters), array-equal to the generator
               and the p0 tail run here; a second call is a cache hit (no
               file rewritten), `--holdout_frac 0.3` reuses the raw slices
               (same feat, another drop_mask), the default again restores
               the first pickles; `--raw_dir` on a raw-format cohort of
               3,000 encounters where pandas is installed (pickles with the
               future-vital and outcome columns, the aux CSV), and without
               pandas an ImportError naming it
  8. p0_scale - the 100k configuration's p0 (`--synthetic 100000
               --synthetic_max_obs 48`) into a temporary directory: the
               first call, the hit and a hold-out re-run timed, the bytes
               on disk
  9. p1      - the p1 entry point (`cli.p1.main`) at the default Config on
               the p0 phase's pickles of 2,100 training encounters (each
               epoch ends in a 52-row masked tail step): two epochs with
               validation, the best checkpoints of loss and ae_mse, the six
               feature dumps (every encounter once, finite) and their
               `viz_feat` embeddings (projector files, or without
               tensorboardX a log line each), a restore into
               a fresh Trainer that gives the dump's latents again (1e-6),
               and a resume from the stored epoch and rate (--restore true
               --max_epochs 4); the launch counters must show B1 and B3-B7
               (the epochs and eval passes are fused: each launch a graph
               replays counts once)
  9m. mtan_p1 - the mtan_t354_b256 cell's path (`mtan_p1_phase`):
               `Trainer.train()` with `model="mtan"` at mTAN's published
               widths (B 256, T 354, R 128) on the p0 phase's pickles, fused
               epoch on, two epochs with validation; the launch counters,
               zeroed just before, must show M1's pair and O1; finite
               validation losses, and the 256-d `hidden` dump of the
               restored ae_mse checkpoint
  9a. fused  - the fused epoch (`fused_phase`): two epochs replayed from
               captured CUDA graphs against two stepped, bit for bit in the
               per-batch losses, parameters, BatchNorm buffers, optimizer
               and generator state, at the default Config on the p0
               phase's 2,100 encounters (the 52-row masked tail; a fused
               validation pass's dumps equal too) and at B=4096, T=48 (the
               368-row tail), in float32 and bfloat16, the hand-kernel
               launches of a replayed epoch equal to the stepped epoch's;
               p3 with `eval_interval=3` and `pipeline_delta` (a stop found
               one epoch late, the speculative epoch rolled back) against
               `eval_interval=1`: the same stop epoch, deltas, weights and
               optimizer state, and five epochs deferred, pipelined and
               stepped against undeferred; the stepped and the replayed
               step in turns at both widths and in bf16 (ms, device-busy
               ms, device operations, idle share, capture seconds, graph
               memory, the peak memory at B=4096), `cli.p1 --fused_epoch
               false` against the default, three epochs each
  9b. bf16   - `compute_dtype="bfloat16"` (`bf16_phase`): each kernel
               through its bf16 boundary against its plain version on the
               p0 phase's first batch (forwards within one bfloat16 ulp + 1e-5,
               gradients within 1e-4 of the largest plus an ulp, the JAX
               output types); a bf16 step against the float32 step from the
               same weights and draws at the default Config and at the
               scaled one (B2 on its path): losses within 5e-2 relative,
               finite gradients, float32 parameters and Adam state, the
               same launches; the bf16 and float32 bare steps in turns (ms,
               encounters/s, device-busy ms); `cli.p1 --compute_dtype
               bfloat16` for two epochs beside the p1 phase's
  9c. dp     - data-parallel and multi-process runs through the entry points
               at the default Config on the p0 phase's pickles (`dp_phase`):
               `cli.p1.main --data_parallel 1` (one NCCL rank, its epochs
               replayed from graphs that hold the group's collectives), the
               same under `--fused_epoch false`, and p1 under torchrun
               (env://) bit for bit against one process, and p3 at
               `--data_parallel 1` fused and stepped against p3 alone; one
               NCCL rank's replayed step against its stepped step and a
               replay without a group, in turns (ms, device-busy ms, idle
               share, NCCL kernels and ms, the collectives issued stepped,
               at capture and by replays, capture seconds, pool bytes); two ranks sharing the card over gloo
               for one step and the masked tail (within invariant 1's band,
               the ranks' parameters the same bits), then for two p1 epochs
               and three p3 epochs (held to the band or to 10x the drift of
               one process nudged by 2^-24, which the trajectory amplifies
               alike), every rank's launch counts showing B1 and B3-B7 and
               every file written once; the two-rank p1 run row-sharded
               (`shard_cohort`, the default) against `--shard_cohort false`
               bit for bit, each rank's cohort bytes both ways and each
               epoch's relayout seconds, p3 sharded too; two NCCL ranks,
               fused and stepped, where there are two cards (else
               `"nccl_2": "skipped: 1 card"`); p2 and p4 at
               `--num_processes 2` as two processes on the card, the CSVs
               and labels those of one process; `cli.p2 --data_parallel 2`
               (two gloo ranks, the latents row-sharded) against one
               process: the suggestions and k identical, the float columns
               within 1e-5 relative (`ref_s`, a spread of nearly equal logs,
               within 1e-5 of `ref`); each run's epoch seconds and
               encounters/s
 10. convert - the converter (`cli.convert.main`) on the p1 run's weight
               root: `to_torch` in directory mode, each tar into a fresh Net
               on the card (strict) whose validation latents equal the
               dump's (1e-6) and whose optimizer state loads into the
               amsgrad Adam; `to_jax` of the tars gives the checkpoints'
               params and state back bit for bit
 11. p2      - the p2 entry point (`cli.p2.main`) at the default Config
               (k_max 10, n_init 10, gap_b 10) on the p1 run's latents of
               metrics ae_mse and loss: elbow and gap tables for k = 2..10,
               all finite, the suggestions in range, the fingerprint
               sidecar, every k-means fit on the card; a second call
               (`--select_opt_k '["gap_sts"]'`) reloads the tables with no
               fit; then `--cluster_algo dbscan`: the k-distance graph (256
               neighbours) and the 9-value eps sweep
 12. p2_scale - 70,000 x 256 synthetic latents (the 100k configuration's
               training cohort at the latent width; four blobs and uniform
               noise on a grid of 1/16, where every squared distance is
               exact in float32): silhouette, inertia_v1 and the Dunn index
               at K=4, the 255th-neighbour distance and one DBSCAN
               (min_samples 257, eps at the k-distance knee), each timed, at
               blocks of 1,024 and 4,096 rows (DBSCAN labels identical,
               scores within 1e-5 relative); on the first 4,000 rows each
               held against a dense float64 evaluation on the card; the
               peak memory
 13. p3      - the p3 entry point (`cli.p3.main`) at the default Config from
               the p1 run: the partial restore takes every p1 leaf bit for
               bit, k-means (20 restarts, K=4) runs on the card and its
               labels are `kmeans_predict` of its centres, 3 DEC epochs with
               their label deltas (`--stopping_delta 0`: no early stop), checkpoints of loss, ae_mse and delta,
               nine dumps (every encounter once, finite, `cluster_pred` rows
               summing to 1 within 1e-5); the launch counters must show B1
               and B3-B7
 14. p4      - the p4 entry point (`cli.p4.main`) on the p3 run with the
               kmeans path (on the card), the dl path and the dbscan path
               (on the card, at an `--opt_eps` where every cohort has a
               cluster): kmeans and dl labels in [0, K), dbscan labels in
               [-1, n_clusters), the kmeans and dbscan training clusters in
               descending mean SBP, the dl labels the argmax of the dumps'
               `cluster_pred`
Then a `{"kernels": [...]}` line (`launches`: the p1 phase's count, the
scaled phase's for the packed select, the mtan_p1 phase's for M1; `launches_p3`: the p3 phase's;
`launches_bf16_step` and `launches_bf16_p1`: phase `bf16`'s;
`launches_fused_epoch`: one replayed epoch's, phase `fused`), the
card's name and power limit from nvidia-smi, and as the last line
`{"ok": true, "device": {...}}`.

Imports nothing of JAX. Needs one card; builds under build/torch_kernels/;
the trainers' run directories are temporary ones under build/.
"""

from __future__ import annotations

import copy
import csv
import gc
import json
import logging
import os
import subprocess
import sys
import tempfile
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

B, C, T, R = 256, 6, 354, 6
N_TRAIN = 2048
STEPS = 8
# timed steps of each bare-step option run (fused heads, 16-bit draws)
OPTION_STEPS = 20
H = 128  # Config().lstm_hidden
# the scaled configuration (benchmarks/scale_100k.py, cli/p0.py
# --synthetic_max_obs 48): three full batches and the 368-encounter tail
# that the 100k cohort's training split leaves (70,000 mod 4,096)
SCALED_B, SCALED_T = 4096, 48
SCALED_TRAIN = 3 * SCALED_B + 368
# row lengths at which the packed select (T <= 192) and the select are held
# against the sort oracle and timed, each on enough rows for 2^20 slots
PACKED_T = (16, 48, 96, 192)
SELECT_T = (256, 354, 512, 1024, 2048, 4096)
# the p1 phase: 2,100 training encounters, 8 full batches and a 52-row tail
P1_TRAIN = 2100
P1_TOTAL = 3000
# the p2_scale phase: the 100k configuration's training cohort (70,000 of
# 100,000 encounters) at the latent width, and its first rows held against
# a dense float64 evaluation
P2_SCALE_N = 70_000
P2_DENSE_N = 4_000
# the p0_scale phase: the 100k configuration's cohort
P0_SCALE_N = 100_000
# the p0 phase's raw-format cohort (`--raw_dir`, where pandas is installed)
RAW_ENCOUNTERS = 3000


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def bound(n_bytes: float, n_flop: float, n_expf: float):
    """Least time in ms: the bytes at the HBM rate, or the float32
    operations and the expf at their peak rates, whichever is longer."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(n_flop / FP32_FLOP_PER_S, n_expf / EXPF_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def lstm_work(t_len: int, b: int, hidden: int, backward: bool):
    """(bytes, flop, transcendentals) of one B6 or B7 call on both
    directions: each input read once and each output written once; the
    recurrent products (one per step forward; gate recompute, dh and dW
    backward) at 2 flop per FMA plus ~14 (forward) or ~30 (backward)
    operations and 5 or 6 expf/tanhf per (direction, t, row, unit)."""
    f32 = 4
    units = 2 * t_len * b * hidden
    gates, seqs = 2 * t_len * b * 4 * hidden, t_len * b * hidden
    weights = 2 * hidden * 4 * hidden + 2 * 4 * hidden
    states = 2 * 2 * b * hidden
    fma = units * 4 * hidden
    if not backward:  # xg in; ys, cs out
        return f32 * (gates + weights + states + 4 * seqs), 2 * fma + 14 * units, 5 * units
    # xg, w, h0/c0, ys/cs and their cotangents in; dxg, dW, db, dh0/dc0 out
    n_bytes = f32 * (gates + weights + states + 4 * seqs + 4 * seqs + gates + weights + states)
    return n_bytes, 3 * 2 * fma + 30 * units, 6 * units


def same_bits(a, b) -> bool:
    """Equal bit for bit (NaN of a row without observations included)."""
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def params_agree(net_k, net_p, lr):
    """The repo's parameter-parity rule after an Adam step at rate `lr`:
    elements with |grad| near Adam's eps move by lr*g/(|g|+eps), so a few
    may differ by more than 1e-5; at most 0.01% of them, each by no more
    than Adam can move an element in one step, 2*lr. Returns (max
    difference, elements beyond 1e-5, elements)."""
    n_viol = n_tot = 0
    worst = 0.0
    plain_params = {n: p.detach() for n, p in net_p.named_parameters()}
    for n, p in net_k.named_parameters():
        d = (p.detach() - plain_params[n]).abs()
        worst = max(worst, float(d.max()))
        n_viol += int((d > 1e-5 + 1e-5 * plain_params[n].abs()).sum())
        n_tot += d.numel()
    if worst > 2 * lr or n_viol > max(1, n_tot // 10_000):
        raise AssertionError(f"params after one step: max diff {worst} (limit {2 * lr}), "
                             f"{n_viol}/{n_tot} beyond 1e-5")
    return worst, n_viol, n_tot


def _pickles(folder: str) -> dict:
    """The three cohort pickles of a p0 output folder."""
    import pickle

    from deep_interpolation_clustering_tpu_torch.info import COHORTS

    out = {}
    for cohort in COHORTS:
        with open(os.path.join(folder, f"{cohort}.pickle"), "rb") as f:
            out[cohort] = pickle.load(f)
    return out


def _splits_equal(got: dict, want: dict) -> list:
    """Keys whose arrays differ (or are missing) between two p0 outputs."""
    bad = []
    for cohort, d in want.items():
        for k, v in d.items():
            g, v = got.get(cohort, {}).get(k), np.asarray(v)
            same = (g is not None and np.asarray(g).dtype == v.dtype and np.array_equal(
                np.asarray(g), v, equal_nan=v.dtype.kind == "f"))
            if not same:
                bad.append(f"{cohort}/{k}")
        bad += [f"{cohort}/{k} (extra)" for k in set(got.get(cohort, {})) - set(d)]
    return bad


def _timed_p0(argv) -> float:
    from deep_interpolation_clustering_tpu_torch.cli import p0

    t0 = time.perf_counter()
    p0.main(argv)
    return time.perf_counter() - t0


def _mtimes(folder: str) -> dict:
    return {f: os.path.getmtime(os.path.join(folder, f)) for f in sorted(os.listdir(folder))}


def p0_phase(root: str, smi: str) -> dict:
    """Drive `cli.p0.main --synthetic 3000 --synthetic_max_obs 354` into the
    p1 phase's `Data/` (2,100 / 450 / 450 encounters) and hold its pickles
    against the synthetic generator and the p0 tail computed here; a second
    call is a cache hit, a `--holdout_frac 0.3` call reuses the raw slices
    (same `feat`, another `drop_mask`), a call at the default restores the
    first pickles; `--raw_dir` without pandas raises an ImportError naming
    it. Returns the processed cohorts."""
    from deep_interpolation_clustering_tpu_torch import Config
    from deep_interpolation_clustering_tpu_torch.data import make_synthetic_cohorts, process_splits

    base = os.path.join(root, "Data")
    argv = ["--synthetic", str(P1_TOTAL), "--synthetic_max_obs", str(T),
            "--num_timestamps", str(T), "--base_path", base]
    processed = os.path.join(base, "model_data", "split_processed")
    org = os.path.join(base, "model_data", "split_org")
    seconds = {"first": _timed_p0(argv)}
    first = _pickles(processed)
    cfg = Config()
    want = process_splits(make_synthetic_cohorts(n_total=P1_TOTAL, max_obs=T, seed=cfg.seed),
                          rng=np.random.RandomState(cfg.seed))
    bad = _splits_equal(first, want)
    if bad:
        raise AssertionError(f"p0 pickles differ from the generator and the p0 tail: {bad}")
    sizes = {c: len(d["encounter_id"]) for c, d in first.items()}
    if sizes["training"] != P1_TRAIN or first["training"]["feat"].shape[1:] != (C, T):
        raise AssertionError(f"p0 cohorts: {sizes}, feat {first['training']['feat'].shape}")

    before, before_org = _mtimes(processed), _mtimes(org)
    seconds["hit"] = _timed_p0(argv)
    if _mtimes(processed) != before or _mtimes(org) != before_org:
        raise AssertionError("p0 second call rewrote its outputs")
    seconds["holdout_0.3"] = _timed_p0(argv + ["--holdout_frac", "0.3"])
    held = _pickles(processed)
    if _mtimes(org) != before_org:
        raise AssertionError("p0 --holdout_frac 0.3 rewrote the raw slices")
    for cohort, d in held.items():
        if not np.array_equal(d["feat"], first[cohort]["feat"]) or np.array_equal(
                d["drop_mask"], first[cohort]["drop_mask"]):
            raise AssertionError(f"p0 --holdout_frac 0.3 {cohort}: feat changed or drop_mask "
                                 f"did not")
    seconds["restore_default"] = _timed_p0(argv)
    bad = _splits_equal(_pickles(processed), first)
    if bad:
        raise AssertionError(f"p0 back at the default differs from its first call: {bad}")

    with tempfile.TemporaryDirectory(dir=root) as tmp:
        raw_argv = ["--raw_dir", tmp, "--base_path", os.path.join(tmp, "Data")]
        try:
            import pandas as pd
        except ImportError:
            try:
                _timed_p0(raw_argv)
            except ImportError as e:
                if "pandas" not in str(e):
                    raise AssertionError(f"p0 --raw_dir: ImportError {e!r} does not name pandas")
                raw = f"ImportError: {e}"
            else:
                raise AssertionError("p0 --raw_dir ran without pandas")
        else:
            n_rows = _raw_fixture(tmp, pd)
            seconds["raw_dir"] = _timed_p0(raw_argv)
            tr = _pickles(os.path.join(tmp, "Data", "model_data", "split_processed"))["training"]
            n_tr = len(tr["encounter_id"])
            if (tr["future_vital"].shape != (n_tr, C) or tr["AKI_overall"].shape != (n_tr,)
                    or tr["time_step"].max() > 6.0 or not os.path.exists(
                        os.path.join(tmp, "Data", "next_hour_abnormal_norm_val.csv"))):
                raise AssertionError(f"p0 --raw_dir: training {tr['feat'].shape}, future_vital "
                                     f"{tr['future_vital'].shape}")
            raw = (f"pandas {pd.__version__}: {RAW_ENCOUNTERS} encounters, {n_rows} records, "
                   f"training feat {tr['feat'].shape}")
    say("p0", encounters=json.dumps(sizes), T=T,
        seconds=json.dumps({k: round(v, 4) for k, v in seconds.items()}),
        raw_dir=repr(raw), card=repr(smi))
    return first


def _raw_fixture(folder: str, pd) -> int:
    """The reference's raw format for `--raw_dir` (as tests/test_p0_raw.py
    writes it), RAW_ENCOUNTERS encounters with 2-60 records a vital over 7.5
    hours; returns the number of records."""
    import pickle

    from deep_interpolation_clustering_tpu_torch.info import USE_FEATURES

    rng = np.random.RandomState(5)
    n = RAW_ENCOUNTERS
    ids = np.array([f"e{i:05d}" for i in range(n)])
    pd.DataFrame({"encounter_deiden_id": ids, "AKI_overall": rng.randint(0, 2, n),
                  "mort_status_30d": rng.randint(0, 2, n)}).to_csv(
        os.path.join(folder, "encounter.csv"), index=False)
    vitals, n_rows = {}, 0
    for v in USE_FEATURES:
        counts = rng.randint(2, 61, n)
        enc = np.repeat(ids, counts)
        t = rng.rand(len(enc)) * 7.5
        order = np.lexsort((t, enc))  # by encounter, then time
        vitals[v] = pd.DataFrame({"encounter_deiden_id": enc[order], "time_stamp": t[order],
                                  "measurement": rng.rand(len(enc)) * 50 + 60})
        n_rows += len(enc)
    with open(os.path.join(folder, "vitals.pickle"), "wb") as f:
        pickle.dump(vitals, f)
    n_tr, n_va = int(0.7 * n), int(0.15 * n)
    with open(os.path.join(folder, "split_ids.pickle"), "wb") as f:
        pickle.dump({"training": list(ids[:n_tr]), "validation": list(ids[n_tr:n_tr + n_va]),
                     "testing": list(ids[n_tr + n_va:])}, f)
    return n_rows


def p0_scale_phase(smi: str) -> None:
    """The 100k configuration's own p0 (`--synthetic 100000
    --synthetic_max_obs 48`) into a temporary directory under build/: the
    first call, the cache hit and a `--holdout_frac 0.3` re-run timed, and
    the bytes each stage leaves on disk."""
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        base = os.path.join(tmp, "Data")
        argv = ["--synthetic", str(P0_SCALE_N), "--synthetic_max_obs", str(SCALED_T),
                "--num_timestamps", str(SCALED_T), "--base_path", base]
        seconds = {"first": _timed_p0(argv), "hit": _timed_p0(argv),
                   "holdout_0.3": _timed_p0(argv + ["--holdout_frac", "0.3"])}
        disk = {}
        for stage in ("split_org", "split_processed"):
            folder = os.path.join(base, "model_data", stage)
            disk[stage] = sum(os.path.getsize(os.path.join(folder, f))
                              for f in os.listdir(folder))
        train = _pickles(os.path.join(base, "model_data", "split_processed"))["training"]
        if train["feat"].shape != (P2_SCALE_N, C, SCALED_T) or not np.isfinite(
                train["feat"]).all():
            raise AssertionError(f"p0_scale training feat {train['feat'].shape}")
    say("p0_scale", encounters=P0_SCALE_N, T=SCALED_T,
        seconds=json.dumps({k: round(v, 4) for k, v in seconds.items()}),
        bytes=json.dumps(disk), card=repr(smi))


def p1_phase(root: str, cohorts: dict, smi: str) -> dict:
    """Drive `cli.p1.main` at the default Config on the p0 phase's T=354
    pickles under `root` (`cohorts`), check what it wrote, that `viz_feat`
    ran, restore and resume; returns the kernels' launch counts of the
    phase."""
    import torch

    from deep_interpolation_clustering_tpu_torch import Config
    from deep_interpolation_clustering_tpu_torch.cli import p1
    from deep_interpolation_clustering_tpu_torch.cli.common import (
        build_parser, config_from_args, make_datasets,
    )
    from deep_interpolation_clustering_tpu_torch.compat import optimizer_to_jax
    from deep_interpolation_clustering_tpu_torch.info import COHORTS
    from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
    from deep_interpolation_clustering_tpu_torch.train import Trainer
    from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt
    from deep_interpolation_clustering_tpu_torch.train.optim import LRSchedule
    from deep_interpolation_clustering_tpu_torch.train.summary import Summary

    base, results = os.path.join(root, "Data"), os.path.join(root, "Results")
    width = ["--batch_size", str(B), "--num_timestamps", str(T), "--lstm_hidden", str(H),
             "--head_hidden", str(H), "--base_path", base, "--results_path", results]
    cfg = config_from_args(build_parser("p1").parse_args(width))

    # seconds of each trained epoch and of each cohort's eval (restore,
    # forward, dump), each ended by a synchronise
    epoch_s, eval_s = [], {}
    train_one_epoch, evaluate = Trainer.train_one_epoch, Trainer.eval

    def timed_epoch(self):
        t0 = time.perf_counter()
        out = train_one_epoch(self)
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        return out

    def timed_eval(self, cohort, *args, **kw):
        t0 = time.perf_counter()
        out = evaluate(self, cohort, *args, **kw)
        torch.cuda.synchronize()
        eval_s.setdefault(cohort, []).append(time.perf_counter() - t0)
        return out

    # viz_feat: each dump's latents go to the projector, or (without
    # tensorboardX) to one log line
    embedded, add_embedding = [], Summary.add_embedding

    def recorded_embedding(self, features, step, tag):
        embedded.append((tag, step, tuple(features.shape), self._tb is not None))
        return add_embedding(self, features, step, tag)

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    lines = Lines()
    port_log = logging.getLogger("dicl.torch")
    Trainer.train_one_epoch, Trainer.eval = timed_epoch, timed_eval
    Summary.add_embedding = recorded_embedding
    port_log.addHandler(lines)
    cb.reset_launch_counts()
    try:
        exp = p1.main(width + ["--max_epochs", "3"])
        torch.cuda.synchronize()
    finally:
        Trainer.train_one_epoch, Trainer.eval = train_one_epoch, evaluate
        Summary.add_embedding = add_embedding
        port_log.removeHandler(lines)
    launches = {w.name: w.launches for w in cb.KERNELS}
    n_batches = -(-P1_TRAIN // B)
    if len(epoch_s) != 2:
        raise AssertionError(f"p1 trained {len(epoch_s)} epochs, expected 2")
    want_tags = [c for _ in ("loss", "ae_mse") for c in COHORTS]
    if [e[0] for e in embedded] != want_tags or any(
            e[2] != (len(cohorts[e[0]]["encounter_id"]), 2 * H) for e in embedded):
        raise AssertionError(f"p1 viz_feat: embedded {embedded}")
    if embedded[0][3]:
        missing = [(tag, step) for tag, step, _, _ in embedded if not os.path.exists(
            os.path.join(exp, "summary", f"{step:05d}", tag, "tensors.tsv"))]
        if missing:
            raise AssertionError(f"p1 viz_feat: no projector tensors for {missing}")
        viz = f"projector: {len(embedded)} embeddings"
    else:
        said = [ln for ln in lines.lines if "tensorboardX is not installed" in ln]
        if len(said) != len(embedded):
            raise AssertionError(f"p1 viz_feat without tensorboardX: {len(said)} log lines")
        viz = f"no tensorboardX: {len(said)} log lines"

    events = os.path.join(exp, "summary", "events.jsonl")
    with open(events) as f:
        rows = [json.loads(line) for line in f]
    got = [(r["scope"], r["step"]) for r in rows if r["scope"] in ("train", "valid")]
    if got != [("train", 1), ("valid", 1), ("train", 2), ("valid", 2)]:
        raise AssertionError(f"p1 summary rows: {got}")
    for r in rows:
        if not all(np.isfinite(v) for k, v in r.items() if k not in ("scope", "step")):
            raise AssertionError(f"p1 summary row not finite: {r}")
    # a fresh trainer over the same run directory: each checkpoint loads
    # with its optimizer state
    fresh = Trainer(cfg, make_datasets(cfg), exp, device="cuda")
    metas = {}
    for m in ("loss", "ae_mse"):
        path = os.path.join(exp, "weight", m, ckpt.CKPT_NAME)
        metas[m] = ckpt.load_meta(path)
        epoch, _, _, leaves, _ = ckpt.load_checkpoint(
            path, optimizer_to_jax(fresh.opt, fresh.net, 0))
        if leaves is None or epoch not in (1, 2) or metas[m]["metric"] != m:
            raise AssertionError(f"p1 checkpoint {m}: epoch {epoch}, optimizer "
                                 f"{'missing' if leaves is None else 'present'}")
    dumps = {}
    for m in ("loss", "ae_mse"):
        for cohort in COHORTS:
            d = np.load(os.path.join(exp, "out_feat", m, f"{cohort}.npy"),
                        allow_pickle=True).item()
            ids = list(cohorts[cohort]["encounter_id"])
            n = len(ids)
            if list(d["encounter_id"]) != ids or len(set(d["encounter_id"])) != n:
                raise AssertionError(f"p1 dump {m}/{cohort}: not every encounter once")
            for k, shape in (("hidden", (n, 2 * H)), ("rec_ob", (n, C, T))):
                if d[k].shape != shape or not np.isfinite(d[k]).all():
                    raise AssertionError(f"p1 dump {m}/{cohort} {k}: shape {d[k].shape}, "
                                         f"finite {bool(np.isfinite(d[k]).all())}")
            dumps[m, cohort] = d

    # the ae_mse checkpoint restored into the fresh trainer gives the dump's
    # validation latents again
    again = fresh.eval("validation", metric="ae_mse")
    fresh.close()
    restore_err = float(np.abs(again["hidden"] - dumps["ae_mse", "validation"]["hidden"]).max())
    if not restore_err <= 1e-6:
        raise AssertionError(f"p1 restore: hidden differs from the dump by {restore_err}")

    # resume from the ae_mse checkpoint: the stored epoch, the stored rate
    with open(events) as f:
        n_rows = len(f.readlines())
    stored = metas["ae_mse"]
    exp2 = p1.main(width + ["--max_epochs", "4", "--restore", "true"])
    torch.cuda.synchronize()
    launches = {w.name: w.launches for w in cb.KERNELS}
    with open(events) as f:
        resumed = [json.loads(line) for line in f][n_rows:]
    want_epochs = list(range(stored["epoch"], 4))
    sched = LRSchedule(cfg)
    sched.load_state_dict(stored["lr_schedule"])
    want_lr = [sched.step(None) for _ in want_epochs]
    got_train = [r["step"] for r in resumed if r["scope"] == "train"]
    got_lr = [r["lr"] for r in resumed if r["scope"] == "valid"]
    if exp2 != exp or got_train != want_epochs or got_lr != want_lr:
        raise AssertionError(f"p1 resume from epoch {stored['epoch']}: trained {got_train}, "
                             f"rates {got_lr}, expected {want_epochs}, {want_lr}")

    need = ("fake_select", "sci_forward", "sci_backward", "rbf_push", "lstm_forward",
            "lstm_backward", "clip_adam")
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"p1: kernels never launched on the path: {missing}")
    mean_epoch = float(np.mean(epoch_s))
    say("p1", batch=B, T=T, train_encounters=P1_TRAIN, steps_per_epoch=n_batches,
        epoch_s=json.dumps([round(x, 4) for x in epoch_s]),
        encounters_per_s=f"{P1_TRAIN / mean_epoch:.1f}",
        eval_s=json.dumps({k: [round(x, 4) for x in v] for k, v in eval_s.items()}),
        restore_err=f"{restore_err:.3g}", resumed_from=stored["epoch"], viz_feat=repr(viz),
        launches=json.dumps(launches), card=repr(smi))
    return launches, dict(exp=exp, width=width, cohorts=cohorts, results=results,
                          epoch_s=epoch_s)


def _bf16_ulp(t):
    """One bfloat16 ulp at each value of `t` (8 significant bits); the
    smallest normal bfloat16 at 0."""
    import torch

    a = t.detach().float().abs()
    ulp = torch.ldexp(torch.ones_like(a), torch.frexp(a).exponent - 8)
    return torch.where(a > 0, ulp, torch.full_like(a, torch.finfo(torch.bfloat16).tiny))


class _PlainKernels:
    """While entered, every kernel wrapper runs its plain version on the
    card's tensors too (its launch count still counts the calls)."""

    def __enter__(self):
        from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb

        self.saved = [(w, w._launch) for w in cb.KERNELS]
        for w, _ in self.saved:
            w._launch = w.plain
        return self

    def __exit__(self, *exc):
        for w, launch in self.saved:
            w._launch = launch


def _step_draws(gen, dev, b: int, t_len: int, width: int = 32) -> dict:
    """The fake stream's draws and the permutation of one step at (b, C, T)."""
    import torch

    from deep_interpolation_clustering_tpu_torch.data.loader import draw_bits, draw_dtype

    return {"fake_bits": draw_bits((b, C, t_len), gen, dev, width),
            "fake_noise": torch.rand((b, C, t_len), generator=gen, device=dev,
                                     dtype=draw_dtype(width)),
            "perm": torch.randperm(2 * b, generator=gen, device=dev)}


def bf16_phase(run: dict, sdata, smi: str) -> dict:
    """`compute_dtype="bfloat16"` on the card, on the p0 phase's pickles at
    the default Config (B=256, T=354, H=128) and at the scaled one (B=4096,
    T=48, `sdata`'s first batch) so that B2 is on the path:
      * each kernel through its bf16 boundary (`cuda_interp.sci`,
        `cuda_interp.rbf_push`, `cuda_lstm.bilstm_recurrence`) on bfloat16
        inputs against the same boundary around the plain versions: the
        outputs in the JAX types, forwards within one bfloat16 ulp of the
        output plus 1e-5 (both round float32 values at most the kernels'
        1e-5 apart; near 0, where an ulp is tiny, the 1e-5 is what is left),
        gradients within 1e-4 of the largest element plus an ulp, in each
        input's type;
      * a bf16 train step against the float32 step from the same weights,
        draws and dropout generator: every loss within 5e-2 relative (JAX's
        bar), gradients finite, parameters and Adam state float32, each
        kernel launched as often as in the float32 step;
      * the bf16 and float32 bare steps in turns (20 timed after 2 of
        warm-up, twice each): ms a step, encounters/s, device-busy ms
        (`utils.profiling.device_profile`);
      * `cli.p1 --compute_dtype bfloat16` for two epochs: epoch seconds
        beside the p1 phase's, float32 dumps, finite losses.
    Returns what it measured."""
    import torch

    from deep_interpolation_clustering_tpu_torch import Config
    from deep_interpolation_clustering_tpu_torch.cli import p1
    from deep_interpolation_clustering_tpu_torch.data import ArrayDataset
    from deep_interpolation_clustering_tpu_torch.info import COHORTS
    from deep_interpolation_clustering_tpu_torch.models import Net
    from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
    from deep_interpolation_clustering_tpu_torch.ops import cuda_interp as ci
    from deep_interpolation_clustering_tpu_torch.ops import cuda_lstm as cl
    from deep_interpolation_clustering_tpu_torch.train import (
        Trainer, build_inputs, gather_batch, make_optimizer, update,
    )
    from deep_interpolation_clustering_tpu_torch.train.steps import cast_batch
    from deep_interpolation_clustering_tpu_torch.utils.profiling import device_profile

    dev = torch.device("cuda")
    bf = torch.bfloat16
    cfg = Config()
    gen = torch.Generator(device=dev).manual_seed(13)
    ds = ArrayDataset(cfg, run["cohorts"]["training"], "training")
    data = {k: torch.as_tensor(v, device=dev) for k, v in ds.arrays().items()}
    batch = gather_batch(data, torch.arange(B, device=dev))

    # ---- each kernel through its bf16 boundary against its plain version
    def boundary(name, fn, inputs, grad_of, want_dtype):
        cots, res = None, {}
        for plain in (False, True):
            ins = [a.detach().clone().requires_grad_(i in grad_of)
                   for i, a in enumerate(inputs)]
            cb.reset_launch_counts()
            if plain:
                with _PlainKernels():
                    outs = fn(*ins)
            else:
                outs = fn(*ins)
            outs = outs if isinstance(outs, tuple) else (outs,)
            if cots is None:
                cots = [torch.randn(o.shape, generator=gen, device=dev).to(o.dtype)
                        for o in outs]
            torch.autograd.backward(outs, cots)
            torch.cuda.synchronize()
            launched = {w.name: w.launches for w in cb.KERNELS if w.launches}
            res[plain] = (outs, [ins[i].grad for i in grad_of], launched)
        (k_outs, k_grads, launched), (p_outs, p_grads, _) = res[False], res[True]
        fwd = fwd_beyond = grad = 0.0
        for a, b_ in zip(k_outs, p_outs):
            a, b_ = a.detach(), b_.detach()
            if a.dtype != want_dtype or b_.dtype != want_dtype:
                raise AssertionError(f"bf16 {name}: outputs {a.dtype}, {b_.dtype}, "
                                     f"expected {want_dtype}")
            d = (a.float() - b_.float()).abs()
            d = torch.where(torch.isnan(a.float()) & torch.isnan(b_.float()), 0.0, d)
            beyond = (d - _bf16_ulp(b_)).clamp_min(0.0)  # what exceeds one ulp
            if not float(beyond.max()) <= 1e-5:
                raise AssertionError(f"bf16 {name}: forward beyond one bfloat16 ulp + 1e-5 "
                                     f"by {float(beyond.max())}")
            fwd = max(fwd, float(d.max()))
            fwd_beyond = max(fwd_beyond, float(beyond.max()))
        for i, a, b_ in zip(grad_of, k_grads, p_grads):
            if a.dtype != inputs[i].dtype:
                raise AssertionError(f"bf16 {name}: grad {i} {a.dtype}, input "
                                     f"{inputs[i].dtype}")
            d = (a.float() - b_.float()).abs()
            lim = 1e-4 * float(b_.float().abs().max()) + _bf16_ulp(b_)
            if not (bool(torch.isfinite(a.float()).all()) and bool((d <= lim).all())):
                raise AssertionError(f"bf16 {name}: grad {i} max diff {float(d.max())}")
            grad = max(grad, float(d.max()))
        return dict(out_dtype=str(want_dtype).replace("torch.", ""), forward_max_diff=fwd,
                    forward_max_beyond_ulp=fwd_beyond, grad_max_diff=grad, launched=launched)

    ob16 = (batch["ob"] * batch["padding_mask"]).to(bf)
    m16, t16 = batch["padding_mask"].to(bf), batch["timestamp"].to(bf)
    k16 = torch.rand(C, generator=gen, device=dev).to(bf)
    hours = cfg.hours_from_admission
    checks = {
        "sci": boundary("sci", lambda k, o, m, t: ci.sci(k, o, m, t, R, hours),
                        [k16, ob16, m16, t16], (0, 1), bf),
        # the fake stream's float32 ob beside bfloat16 planes: float32 out
        "sci_f32_ob": boundary("sci_f32_ob", lambda k, o, m, t: ci.sci(k, o, m, t, R, hours),
                               [k16, batch["ob"] * batch["padding_mask"], m16, t16], (0, 1),
                               torch.float32),
        "rbf_push": boundary(
            "rbf_push", lambda k, p, m, t: ci.rbf_push(k, p, m, t, R, hours),
            [k16, torch.randn((B, C, R), generator=gen, device=dev).to(bf), m16, t16],
            (0, 1), bf),
    }
    bnd = 1.0 / np.sqrt(H)
    uni = lambda *shape: ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bnd).to(bf)
    lstm_ins = [torch.randn((R, 2 * B, 4 * H), generator=gen, device=dev).to(bf),
                torch.randn((R, 2 * B, 4 * H), generator=gen, device=dev).to(bf),
                uni(2, H, 4 * H), uni(2, 4 * H),
                torch.zeros((2, 2 * B, H), device=dev, dtype=bf),
                torch.zeros((2, 2 * B, H), device=dev, dtype=bf)]
    checks["bilstm_recurrence"] = boundary("bilstm_recurrence", cl.bilstm_recurrence,
                                           lstm_ins, tuple(range(6)), bf)
    for name, want in (("sci", ("sci_forward", "sci_backward")), ("rbf_push", ("rbf_push",)),
                       ("bilstm_recurrence", ("lstm_forward", "lstm_backward"))):
        if not all(checks[name]["launched"].get(k) for k in want):
            raise AssertionError(f"bf16 {name}: kernels not launched: "
                                 f"{checks[name]['launched']}")

    # ---- a bf16 step against the float32 step, at both configurations
    def step_pair(cfg_x, batch_x, draws):
        net32 = Net(cfg_x, generator=torch.Generator().manual_seed(1)).to(dev)
        net16 = copy.deepcopy(net32)
        out = {}
        for dtype, net in (("float32", net32), ("bfloat16", net16)):
            c = cfg_x.replace(compute_dtype=dtype)
            opt = make_optimizer(c, net.parameters())
            cb.reset_launch_counts()
            inputs = build_inputs(c, cast_batch(c, batch_x), None, True, False, draws)
            losses = update(net, opt, c, inputs, torch.Generator(device=dev).manual_seed(5))
            torch.cuda.synchronize()
            launches = {w.name: w.launches for w in cb.KERNELS}
            if not all(bool(torch.isfinite(p.grad).all()) for p in net.parameters()
                       if p.grad is not None):
                raise AssertionError(f"bf16 step ({dtype}): gradients not finite")
            kinds = {p.dtype for p in net.parameters()} | {
                v.dtype for p in net.parameters() for v in opt.state[p].values()
                if v.is_floating_point() and v.dim()}
            if kinds != {torch.float32}:
                raise AssertionError(f"bf16 step ({dtype}): parameters or Adam state {kinds}")
            out[dtype] = ({k: float(v) for k, v in losses.items()}, launches)
        (l32, n32), (l16, n16) = out["float32"], out["bfloat16"]
        gap = {k: abs(l16[k] - v) / max(abs(v), 1e-30) for k, v in l32.items()}
        if not max(gap.values()) <= 5e-2:
            raise AssertionError(f"bf16 step: losses {l16} vs float32 {l32}")
        if n16 != n32:
            raise AssertionError(f"bf16 step launches {n16} differ from float32's {n32}")
        return dict(loss_rel_gap=gap, loss_bf16=l16["loss"], loss_f32=l32["loss"],
                    launches={k: v for k, v in n16.items() if v})

    steps = {"default": step_pair(cfg, batch, _step_draws(gen, dev, B, T))}
    scfg = Config(batch_size=SCALED_B, num_timestamps=SCALED_T)
    sarr = {k: torch.as_tensor(v[:SCALED_B], device=dev) for k, v in sdata.arrays().items()}
    steps["scaled"] = step_pair(scfg, sarr, _step_draws(gen, dev, SCALED_B, SCALED_T))
    if not steps["scaled"]["launches"].get("fake_select_packed"):
        raise AssertionError(f"bf16 scaled step: no packed select {steps['scaled']}")
    del sarr

    # ---- bare steps in turns, and the device's busy time a step
    trainers = {dtype: Trainer(cfg.replace(compute_dtype=dtype), {"training": ds},
                               os.path.join(os.path.dirname(run["results"]), f"bf16_{dtype}"),
                               device=dev) for dtype in ("float32", "bfloat16")}
    for tr in trainers.values():
        tr.train_steps(2)
    step_ms = {dtype: [] for dtype in trainers}
    for _ in range(2):
        for dtype, tr in trainers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_steps(OPTION_STEPS)
            torch.cuda.synchronize()
            step_ms[dtype].append(round((time.perf_counter() - t0) / OPTION_STEPS * 1e3, 3))
    busy = {}
    for dtype, tr in trainers.items():
        stream = tr._stream()
        prof = device_profile(lambda: tr.step(*next(stream)), 5)
        busy[dtype] = dict(device_busy_ms=round(prof["device_busy_ms"] / 5, 4),
                           device_events=prof["device_events_per_step"])
        tr.close()
    del trainers
    timing = {dtype: dict(step_ms=v, encounters_per_s=[round(B / (x / 1e3), 1) for x in v],
                          **busy[dtype]) for dtype, v in step_ms.items()}

    # ---- the entry point: two bf16 epochs
    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    lines = Lines()
    port_log = logging.getLogger("dicl.torch")
    port_log.addHandler(lines)
    results = os.path.join(os.path.dirname(run["results"]), "bf16_p1")
    cb.reset_launch_counts()
    try:
        exp = p1.main(run["width"] + ["--max_epochs", "3", "--compute_dtype", "bfloat16",
                                      "--results_path", results])
        torch.cuda.synchronize()
    finally:
        port_log.removeHandler(lines)
    p1_launches = {w.name: w.launches for w in cb.KERNELS}
    missing = [k for k in ("fake_select", "sci_forward", "sci_backward", "rbf_push",
                           "lstm_forward", "lstm_backward", "clip_adam") if not p1_launches[k]]
    if missing:
        raise AssertionError(f"bf16 p1: kernels never launched on the path: {missing}")
    epochs = _epoch_lines("\n".join(lines.lines))[0]
    with open(os.path.join(exp, "summary", "events.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if len([r for r in rows if r["scope"] == "train"]) != 2 or not all(
            np.isfinite(v) for r in rows for k, v in r.items() if k not in ("scope", "step")):
        raise AssertionError(f"bf16 p1: summary rows {rows}")
    for m in ("loss", "ae_mse"):
        for cohort in COHORTS:
            d = np.load(os.path.join(exp, "out_feat", m, f"{cohort}.npy"),
                        allow_pickle=True).item()
            for k in ("hidden", "rec_ob"):
                if d[k].dtype != np.float32 or not np.isfinite(d[k]).all():
                    raise AssertionError(f"bf16 p1 dump {m}/{cohort} {k}: {d[k].dtype}")
    p1_bf16 = dict(epoch_s=[round(e, 4) for e, _ in epochs],
                   encounters_per_s=[round(x, 1) for _, x in epochs],
                   p1_phase_epoch_s=[round(e, 4) for e in run["epoch_s"]],
                   launches=p1_launches)
    say("bf16", batch=B, T=T, boundary=json.dumps(checks), steps=json.dumps(steps),
        bare_steps=json.dumps(timing), p1=json.dumps(p1_bf16), card=repr(smi))
    return dict(boundary=checks, steps=steps, timing=timing, p1=p1_bf16)


def _graph_vs_stepped(cfg, ds, root: str, tag: str, dev, eval_too: bool = False) -> dict:
    """Two trainers from one seed on `ds`: one replays the captured steps
    (`Trainer._dispatch_fused_epoch`), the other steps eagerly over the same
    batches; two epochs, the second at another rate (written in place into
    the rate tensor the graph reads). Raises unless the per-batch losses,
    the parameters, BatchNorm buffers, optimizer state, generator state and
    update counts are equal bit for bit and the second epoch's hand-kernel
    launches equal; with `eval_too`, a fused validation pass's metrics and
    dumps against a stepped one's. Returns what it measured."""
    import torch

    from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
    from deep_interpolation_clustering_tpu_torch.train import Trainer
    from deep_interpolation_clustering_tpu_torch.train.optim import set_learning_rate

    fused = Trainer(cfg, ds, os.path.join(root, tag + "_graph"), device=dev)
    stepped = Trainer(cfg.replace(fused_epoch=False), ds, os.path.join(root, tag + "_step"),
                      device=dev)
    out = {"epoch_s": {"graph": [], "stepped": []}}
    for epoch, lr in ((1, cfg.init_lr), (2, cfg.init_lr * cfg.lr_decay_rate)):
        for tr in (fused, stepped):
            set_learning_rate(tr.opt, lr)
        torch.cuda.synchronize()
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        table, keys = fused._dispatch_fused_epoch()
        torch.cuda.synchronize()
        out["epoch_s"]["graph"].append(time.perf_counter() - t0)
        graph_launches = {w.name: w.launches for w in cb.KERNELS}
        cb.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [stepped.step(*b) for b in stepped._epoch_batches(stepped.epoch)]
        torch.cuda.synchronize()
        out["epoch_s"]["stepped"].append(time.perf_counter() - t0)
        stepped_launches = {w.name: w.launches for w in cb.KERNELS}
        want = torch.stack([torch.stack([l[k] for k in keys]) for l in losses])
        if not torch.equal(table, want):
            raise AssertionError(f"fused {tag} epoch {epoch}: losses differ from the "
                                 f"stepped epoch's by {float((table - want).abs().max())}")
        if epoch == 2:  # the first epoch's count holds the graphs' warm-up too
            if graph_launches != stepped_launches:
                raise AssertionError(f"fused {tag}: a replayed epoch launched "
                                     f"{graph_launches}, the stepped one {stepped_launches}")
            out["launches_epoch"] = graph_launches
        for tr in (fused, stepped):
            tr.epoch += 1
    states = []
    for tr in (fused, stepped):
        st = dict(tr.net.state_dict())
        for i, p in enumerate(tr.net.parameters()):
            st.update({f"opt.{i}.{k}": v for k, v in tr.opt.state[p].items()})
        states.append(st)
    differ = [k for k in states[1] if not torch.equal(states[0][k], states[1][k])]
    if differ or states[0].keys() != states[1].keys():
        raise AssertionError(f"fused {tag}: the graphed run's state differs at {differ[:8]}")
    if not torch.equal(fused.generator.get_state(), stepped.generator.get_state()):
        raise AssertionError(f"fused {tag}: the generators' states differ")
    if fused.num_updates != stepped.num_updates:
        raise AssertionError(f"fused {tag}: updates {fused.num_updates}, {stepped.num_updates}")
    out["tensors_equal"] = len(states[1])
    if eval_too:
        valid = ds["validation"]
        m_graph, d_graph = fused.eval_one_epoch("valid", valid, False)
        m_step, d_step = stepped.eval_one_epoch("valid", valid, False)
        differ = [k for k in d_step if not np.array_equal(d_graph[k][0], d_step[k][0])]
        if m_graph != m_step or differ or set(d_graph) != set(d_step):
            raise AssertionError(f"fused {tag} eval: metrics {m_graph} vs {m_step}, dumps "
                                 f"differ at {differ}")
        out["eval_dumps_equal"] = sorted(k for k in d_step if k != "__index__")
    out["graphs"] = {"/".join(str(x) for x in key if x is not None): dict(
        capture_s=round(g.capture_seconds, 4), pool_bytes=g.pool_bytes, replays=g.replays)
        for key, g in fused._graphs.items()}
    out["epoch_s"] = {k: [round(x, 4) for x in v] for k, v in out["epoch_s"].items()}
    for tr in (fused, stepped):
        tr.close()
    return out


def _logged_epochs(fn) -> tuple:
    """Run `fn()` with the port's log lines collected; returns (fn's
    result, [(epoch seconds, encounters/s)] from its epoch lines)."""
    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    lines = Lines()
    port_log = logging.getLogger("dicl.torch")
    port_log.addHandler(lines)
    try:
        out = fn()
    finally:
        port_log.removeHandler(lines)
    return out, _epoch_lines("\n".join(lines.lines)).get(0, [])


# each kernel wrapper's device kernels (csrc/*.cu), a call launching one of
# each group: B1 and B2 share one kernel template and its looping form, B7
# launches four kernels, the optimizer tail two
DEVICE_KERNELS = {
    ("fake_select", "fake_select_packed"): [("fake_select_kernel", "fake_select_loop_kernel")],
    ("sci_forward",): [("sci_fwd_kernel",)],
    ("sci_backward",): [("sci_bwd_kernel",)],
    ("rbf_push",): [("rbf_push_kernel",)],
    ("lstm_forward",): [("lstm_fwd_kernel",)],
    ("lstm_backward",): [("lstm_gate_products_kernel",), ("lstm_bwd_kernel",),
                         ("lstm_dw_partial_kernel",), ("lstm_dw_reduce_kernel",)],
    ("clip_adam",): [("optim_partials_kernel",), ("optim_update_kernel",)],
}


def _replay_launches(prof: dict, counted: dict, tag: str) -> dict:
    """The hand kernels that the profiler saw run in a replay of the graph
    (`device_profile`'s `replay_kernels`), by device kernel; raises unless
    the host launched every replay of the window, the trace holds the device
    events of more than half of them (CUPTI has been seen to drop all of one
    replay's events), and in each replay it holds each wrapper's count
    (`GraphedStep.launches`, recorded at capture) is what ran."""
    replays, n = prof["replay_kernels"], prof["window_steps"]
    if prof["graph_launches"] != n or 2 * len(replays) <= n:
        raise AssertionError(f"fused {tag}: {prof['graph_launches']} graph launches, "
                             f"{len(replays)} traced, of {n} replays")
    seen, bad = {}, {}
    for wrappers, groups in DEVICE_KERNELS.items():
        want = sum(counted.get(w, 0) for w in wrappers)
        for names in groups:
            key = "|".join(names)
            ran = sorted({sum(c for kernel, c in replay.items() for name in names
                              if name + "<" in kernel or name + "(" in kernel)
                          for replay in replays})
            seen[key] = ran[0] if len(ran) == 1 else ran
            if ran != [want]:
                bad[key] = (ran, want)
    if bad:
        raise AssertionError(f"fused {tag}: kernels run a replay (profiled, counted): {bad}")
    return seen


def _optimizer_steps(cfg, dev, start: str, make_card=None) -> float:
    """Four steps of the card's optimizer (`make_card`, by default
    `make_optimizer` on CUDA parameters) against the CPU's (torch's
    defaults, a float rate) over the Net's parameters at `cfg`'s width,
    from random or from zero parameters (the first step's parameters are
    then the update itself), from the same gradients, the rate changed by
    `set_learning_rate` before the third. Returns the largest difference
    of a parameter or state tensor over its largest value, and whether
    every element was within 1e-6 of itself plus 1e-6 of that value."""
    import torch

    from deep_interpolation_clustering_tpu_torch.models.net import Net
    from deep_interpolation_clustering_tpu_torch.train.optim import (
        make_optimizer, set_learning_rate,
    )

    torch.manual_seed(0)
    init = [p.detach().clone() for p in Net(cfg).parameters()]
    if start == "zero":
        init = [torch.zeros_like(t) for t in init]
    cpu = [torch.nn.Parameter(t.clone()) for t in init]
    card = [torch.nn.Parameter(t.to(dev)) for t in init]
    opt_cpu, opt_card = make_optimizer(cfg, cpu), (make_card or make_optimizer)(cfg, card)
    g = torch.Generator().manual_seed(1)
    worst, within = 0.0, True
    for step in range(4):
        if step == 2:
            for opt in (opt_cpu, opt_card):
                set_learning_rate(opt, cfg.init_lr / 7)
        for pc, pg in zip(cpu, card):
            pc.grad = torch.randn(pc.shape, generator=g)
            pg.grad = pc.grad.to(dev)
        opt_cpu.step()
        opt_card.step()
        for pc, pg in zip(cpu, card):
            pairs = [(pg, pc)] + [(opt_card.state[pg][k], v)
                                  for k, v in opt_cpu.state[pc].items()]
            for got, want in pairs:
                got, want = got.detach().cpu().double(), want.detach().double()
                top = float(want.abs().max())
                diff = (got - want).abs()
                within &= not bool((diff > 1e-6 * want.abs() + 1e-6 * top).any())
                if top > 0:
                    worst = max(worst, float(diff.max()) / top)
    return worst, within


def _optimizer_check(cfg, dev) -> dict:
    """The card's optimizer (`make_optimizer` on CUDA parameters: a tensor
    rate; Adam capturable on float64 step counts, SGD fused, RMSprop
    capturable) against the CPU's, for adam, sgd and rmsprop from random
    and from zero parameters (`_optimizer_steps`); raises unless each is
    within the bound. Beside them, unchecked, the two Adams the card's is
    not: the capturable one on its own float32 step counts and the fused
    one, from zero parameters. Returns each run's largest difference over
    the largest value."""
    import torch

    out, bad = {}, []
    for optimizer in ("adam", "sgd", "rmsprop"):
        for start in ("random", "zero"):
            worst, within = _optimizer_steps(cfg.replace(optimizer=optimizer), dev, start)
            out[f"{optimizer}/{start}"] = worst
            if not within:
                bad.append(f"{optimizer}/{start}")
    if bad:
        raise AssertionError(f"fused: the card's optimizer differs from the CPU's past 1e-6: "
                             f"{bad} {out}")

    def other_adam(**kw):
        def make(c, params):
            lr = torch.tensor(c.init_lr, dtype=torch.float32, device=params[0].device)
            return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=c.weight_decay_rate, amsgrad=True, **kw)
        return make

    for name, kw in (("adam_capturable_f32", dict(capturable=True)),
                     ("adam_fused", dict(fused=True, capturable=True))):
        out[f"{name}/zero (unchecked)"] = _optimizer_steps(
            cfg.replace(optimizer="adam"), dev, "zero", other_adam(**kw))[0]
    return out


def optim_kernels(cfg, dev) -> dict:
    """Phase `kernels`: the optimizer tail's kernel pair (`ops/cuda_optim.py`)
    against the plain tail it replaces (`clip_grad_global_norm_`, then the
    card's capturable amsgrad Adam) at the Net's 37 leaves, from the same
    parameters and gradients, three steps with the clip engaged, idle and
    engaged: every parameter and state tensor within 1e-6 of its largest
    value, the norm within 1e-6. Then the wrapper's call alone (`ms`, its
    two launches), and the pair and the plain tail (`pair_ms`,
    `plain_tail_ms`) each captured in a CUDA graph and replayed, as the
    fused step runs them, timed by `time_ms` (L2 flushed). Returns the
    wrapper's report row."""
    import torch

    from deep_interpolation_clustering_tpu_torch.models.net import Net
    from deep_interpolation_clustering_tpu_torch.ops import cuda_optim as co
    from deep_interpolation_clustering_tpu_torch.train.optim import (
        clip_adam_step_, clip_grad_global_norm_, make_optimizer,
    )
    from deep_interpolation_clustering_tpu_torch.utils.cuda_timing import time_ms

    torch.manual_seed(0)
    init = [p.detach().to(dev) for p in Net(cfg).parameters()]
    sides = []
    for _ in range(2):
        params = [torch.nn.Parameter(t.clone()) for t in init]
        sides.append((params, make_optimizer(cfg, params)))
    (kp, kopt), (pp, popt) = sides
    gen = torch.Generator(device=dev).manual_seed(5)
    worst, norm_err = 0.0, 0.0
    for scale in (1.0, 1e-4, 1.0):  # a norm of ~800 and of ~0.08 against the clip of 15
        for a, b in zip(kp, pp):
            a.grad = torch.randn(a.shape, generator=gen, device=dev) * scale
            b.grad = a.grad.clone()
        got = clip_adam_step_(kopt, cfg.grad_clip)
        want = clip_grad_global_norm_(pp, cfg.grad_clip)
        popt.step()
        norm_err = max(norm_err, abs(float(got) / float(want) - 1.0))
        for a, b in zip(kp, pp):
            for x, y in [(a, b)] + [(kopt.state[a][k], popt.state[b][k])
                                    for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")]:
                top = float(y.abs().max())
                if top > 0:
                    worst = max(worst, float((x - y).abs().max()) / top)
    if not (worst <= 1e-6 and norm_err <= 1e-6):
        raise AssertionError(f"optimizer kernel pair against the plain tail: {worst:.3g} of "
                             f"the largest value, norm {norm_err:.3g}")

    def graphed(fn):
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return graph.replay

    def plain_tail():
        clip_grad_global_norm_(pp, cfg.grad_clip)
        popt.step()

    group = kopt.param_groups[0]
    leaves = [(p, p.grad, *(kopt.state[p][k] for k in ("exp_avg", "exp_avg_sq",
                                                        "max_exp_avg_sq", "step")))
              for p in kp]
    hyper = (cfg.grad_clip, group["weight_decay"], *group["betas"], group["eps"])
    norm = torch.empty((), dtype=torch.float32, device=dev)
    n = sum(p.numel() for p in kp)
    plain_tail_ms = time_ms(graphed(plain_tail))
    f32 = 4
    return {"clip_adam": dict(
        max_abs_err=max(worst, norm_err),
        tolerance="1e-6 of the largest value (parameters, state) and of the norm",
        ms=time_ms(lambda: co.clip_adam_(norm, leaves, group["lr"], hyper)),
        plain_ms=plain_tail_ms, library_ms=None, expf=0,
        pair_ms=time_ms(graphed(lambda: clip_adam_step_(kopt, cfg.grad_clip))),
        plain_tail_ms=plain_tail_ms,
        # reads g (twice), p, m, v, vmax; writes them all (g scaled: the clip engaged)
        bytes=11 * n * f32, flop=22 * n)}


# mTAN's encoder attention at the mtan_t354_b256 cell: B encounters of C
# channels (1,536 heads) over T slots, R reference points, embedding width D
MTAN_R, MTAN_D = 128, 128


def mtan_kernels(dev) -> dict:
    """Phase `kernels`: mTAN's encoder attention pair (`ops/cuda_mtan.py`)
    at the cell's shapes, each head's count of observations uniform on
    4..T at the front of its slots: the forward's sums, max and log-sum
    within 1e-5 of the plain version's (relative above 1), the backward's
    dK, dob and dQ within 1e-4 of their largest values, both bit-identical
    across two runs; each kernel's ms (`time_ms`, L2 flushed), the plain
    version's, and the bound of its work (the observed (query, key) pairs'
    operations and expf, the inputs read and outputs written once). Returns
    the two wrappers' report rows."""
    import torch

    from deep_interpolation_clustering_tpu_torch.ops import cuda_mtan as cm
    from deep_interpolation_clustering_tpu_torch.utils.cuda_timing import time_ms

    gen = torch.Generator(device=dev).manual_seed(20)
    heads, r, d = B * C, MTAN_R, MTAN_D
    q = torch.randn((r, d), generator=gen, device=dev)
    k = torch.randn((heads, T, d), generator=gen, device=dev)
    counts = torch.randint(4, T + 1, (heads,), generator=gen, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < counts[:, None]).to(torch.float32)
    ob = torch.randn((heads, T), generator=gen, device=dev) * mask
    g_ob = torch.randn((heads, r), generator=gen, device=dev)
    g_m = torch.randn((heads, r), generator=gen, device=dev)
    scale = d ** -0.5
    fwd = cm.attn_fwd(q, k, ob, mask, scale)
    want = cm._attn_fwd_plain(q, k, ob, mask, scale)
    fwd_err = max(float(((x - y).abs() / torch.clamp(y.abs(), min=1.0)).max())
                  for x, y in zip(fwd, want))
    out_ob, out_m, _, lse = fwd
    bwd_args = (q, k, ob, mask, out_ob, out_m, lse, g_ob, g_m, scale)
    bwd = cm.attn_bwd(*bwd_args)
    plain = cm._attn_bwd_plain(*bwd_args)
    bwd_err = max(float((x - y).abs().max()) / float(y.abs().max()) for x, y in zip(bwd, plain))
    if not (fwd_err <= 1e-5 and bwd_err <= 1e-4):
        raise AssertionError(f"mTAN attention pair against plain: forward {fwd_err:.3g}, "
                             f"backward {bwd_err:.3g} of the largest value")
    if not (all(same_bits(x, y) for x, y in zip(fwd, cm.attn_fwd(q, k, ob, mask, scale)))
            and all(same_bits(x, y) for x, y in zip(bwd, cm.attn_bwd(*bwd_args)))):
        raise AssertionError("the mTAN attention pair differs between two runs")
    pairs = float(counts.sum()) * r  # (query, observed key) pairs
    observed = float(counts.sum())
    f32 = 4
    return {
        "mtan_attn_fwd": dict(
            max_abs_err=fwd_err, tolerance="1e-5 (relative above 1); two runs bit-identical",
            ms=time_ms(lambda: cm.attn_fwd(q, k, ob, mask, scale)),
            plain_ms=time_ms(lambda: cm._attn_fwd_plain(q, k, ob, mask, scale)),
            library_ms=None, shape=[heads, T, r, d],
            # q, the observed keys' rows, ob and mask in; four (heads, R) out
            bytes=f32 * (r * d + observed * d + 2 * heads * T + 4 * heads * r),
            flop=pairs * (2 * d + 6), expf=pairs),
        "mtan_attn_bwd": dict(
            max_abs_err=bwd_err, tolerance="1e-4 of the largest value; two runs bit-identical",
            ms=time_ms(lambda: cm.attn_bwd(*bwd_args)),
            plain_ms=time_ms(lambda: cm._attn_bwd_plain(*bwd_args)),
            library_ms=None, shape=[heads, T, r, d],
            # the forward's inputs, three outputs and two cotangents in;
            # dK (every slot), dob and dQ out
            bytes=f32 * (r * d + observed * d + 2 * heads * T + 5 * heads * r
                         + heads * T * d + heads * T + r * d),
            flop=pairs * (6 * d + 8), expf=pairs),
    }


def mtan_p1_phase(run: dict, smi: str) -> dict:
    """The mtan_t354_b256 cell's path: `Trainer.train()` with `model="mtan"`
    at mTAN's published widths (the Config's defaults) and the cell's
    optimizer, on the p1 phase's T=354 pickles (`run`), fused epoch on, two
    epochs with a validation pass each. The launch counters are zeroed
    just before, and must show M1's pair and O1 launched (at capture: the
    train graphs and the eval graph). The validation losses must be finite
    and the restored ae_mse checkpoint's validation `hidden` (the
    classifier GRU's state) one finite 256-d row an encounter. Returns the
    kernels' launch counts of the phase."""
    import torch

    from deep_interpolation_clustering_tpu_torch.cli.common import (
        build_parser, config_from_args, make_datasets,
    )
    from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
    from deep_interpolation_clustering_tpu_torch.train import Trainer

    cfg = config_from_args(build_parser("p1").parse_args(run["width"])).replace(
        model="mtan", aux_tasks={"future_vital": 1.0}, fake_detection=False, init_lr=1e-4,
        weight_decay_rate=0.0, grad_clip=0.0, fused_epoch=True, max_epochs=3)
    datasets = make_datasets(cfg)
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, datasets, os.path.join(run["results"], "mtan"), device="cuda")
    valid = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {w.name: w.launches for w in cb.KERNELS}
    hidden = trainer.eval("validation", metric="ae_mse")["hidden"]
    trainer.close()
    missing = [k for k in ("mtan_attn_fwd", "mtan_attn_bwd", "clip_adam") if launches[k] == 0]
    if missing:
        raise AssertionError(f"mtan_p1: kernels never launched on the path: {missing}")
    if not all(np.isfinite(v) for v in valid.values()):
        raise AssertionError(f"mtan_p1: validation losses not finite: {valid}")
    n_valid = len(datasets["validation"])
    if hidden.shape != (n_valid, cfg.mtan_rec_hidden) or not np.isfinite(hidden).all():
        raise AssertionError(f"mtan_p1: hidden {hidden.shape}, expected "
                             f"({n_valid}, {cfg.mtan_rec_hidden}), finite")
    say("mtan_p1", batch=cfg.batch_size, T=cfg.num_timestamps, R=cfg.mtan_ref_points,
        epochs=trainer.epoch, seconds=f"{train_s:.2f}",
        valid=json.dumps({k: round(float(v), 6) for k, v in valid.items()}),
        launches=json.dumps({k: v for k, v in launches.items() if v}), card=repr(smi))
    return launches


def fused_phase(run: dict, sdata, smi: str, dev) -> dict:
    """Phase `fused`: the fused epoch (`fused_epoch`, the default), each
    epoch replayed from captured CUDA graphs of the step
    (`train/graphs.py`):
      * the card's optimizer against the CPU's (`_optimizer_check`);
      * graph against stepped, two epochs, bit for bit (`_graph_vs_stepped`)
        at the default Config on the p1 phase's cohort (2,100 encounters:
        8 full batches and the 52-row masked tail; with a fused validation
        pass's dumps) and at the scaled one (B=4096, T=48: 3 batches and the
        368-row tail), in float32 and in bfloat16; the hand-kernel launches
        of a replayed epoch equal the stepped epoch's;
      * p3 (`ClusterTrainer` from the p1 run, k-means centres, the count
        rule firing at the first comparable epoch): `eval_interval=3` with
        `pipeline_delta` (its lagged count stops the run inside the next
        epoch, which is rolled back) against `eval_interval=1`: the same
        stop epoch, delta history, weights and optimizer state; and five
        epochs without a stop, deferred and pipelined against undeferred
        and against stepped;
      * timings, in turns within this call: the stepped and the replayed
        step (`utils.profiling.step_turns`) at both widths and in bf16, the
        device-busy ms, operations and idle share of each
        (`device_profile`), the hand kernels the profiler saw run in each
        replay held to the launches counted at capture
        (`_replay_launches`), the replays the host launched against the
        card's own count of them (the graph captured under the tracer,
        `utils.tracing`: `graph.replays_unrun` must be 0), the seconds of
        each graph's warm-up and capture and the memory it added to the
        trainer's one graph pool,
        the peak memory allocated and reserved at B=4096, T=48, and
        `cli.p1` epochs with `--fused_epoch false` and with the default.
    Returns what it measured."""
    import torch

    from deep_interpolation_clustering_tpu_torch import Config
    from deep_interpolation_clustering_tpu_torch.cli import p1
    from deep_interpolation_clustering_tpu_torch.cli.common import (
        build_parser, config_from_args, make_datasets,
    )
    from deep_interpolation_clustering_tpu_torch.train import ClusterTrainer, Trainer
    from deep_interpolation_clustering_tpu_torch.utils import profiling, tracing

    root = os.path.join(os.path.dirname(run["results"]), "fused")
    cfg = config_from_args(build_parser("p1").parse_args(run["width"]))
    ds = make_datasets(cfg)
    opt_err = _optimizer_check(cfg, dev)
    say("fused", check="card optimizer vs the CPU's, 4 steps, a rate change",
        max_err_over_max=json.dumps(opt_err), bound=1e-6, card=repr(smi))
    if len(ds["training"]) % B == 0:
        raise AssertionError("fused: the p1 cohort has no tail")
    scfg = Config(batch_size=SCALED_B, num_timestamps=SCALED_T)
    sds = {"training": sdata}
    bits = {}
    for tag, cfg_x, ds_x in (("default", cfg, ds), ("scaled", scfg, sds),
                             ("default_bf16", cfg.replace(compute_dtype="bfloat16"), ds),
                             ("scaled_bf16", scfg.replace(compute_dtype="bfloat16"), sds)):
        if tag == "scaled":
            torch.cuda.synchronize()
            gc.collect()  # the default width's trainers and graphs
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        bits[tag] = _graph_vs_stepped(cfg_x, ds_x, root, tag, dev, eval_too=tag == "default")
        if tag == "scaled":
            bits[tag]["peak_bytes"] = torch.cuda.max_memory_allocated()
            bits[tag]["peak_reserved_bytes"] = torch.cuda.max_memory_reserved()
        say("fused", check="graph vs stepped, bit for bit", config=tag,
            batch=cfg_x.batch_size, T=cfg_x.num_timestamps,
            encounters=len(ds_x["training"]), **{k: json.dumps(v) for k, v in bits[tag].items()},
            card=repr(smi))

    # ---- p3: the deferred and pipelined cadences against the unlagged loop
    dec_cfg = cfg.replace(loss="ae_mse_sup_fake_detect_kl", log_train_freq=1000,
                          log_valid_freq=1000)
    dec = {}

    def dec_run(name, **kw):
        tr = ClusterTrainer(dec_cfg.replace(**kw), ds, os.path.join(root, "dec_" + name),
                            pretrain_exp_path=run["exp"], device=dev)
        t0 = time.perf_counter()
        _, epochs = _logged_epochs(tr.train)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        tr.close()
        st = dict(tr.net.state_dict())
        for i, p in enumerate(tr.net.parameters()):
            st.update({f"opt.{i}.{k}": v for k, v in tr.opt.state[p].items()})
        dec[name] = dict(epoch=tr.epoch, deltas=list(tr.delta_history), train_s=round(seconds, 4),
                         epoch_s=[round(s, 4) for s, _ in epochs])
        return st

    def same(a, b, what):
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        if differ or a.keys() != b.keys():
            raise AssertionError(f"fused p3 {what}: weights or optimizer state differ at "
                                 f"{differ[:8]}")

    stop = dict(stopping_delta=None, stopping_mode="count", stopping_count=10**9,
                max_epochs=6)
    ref = dec_run("stop_ref", eval_interval=1, **stop)
    piped = dec_run("stop_piped", eval_interval=3, pipeline_delta=True, **stop)
    same(ref, piped, "stop under pipeline_delta")
    if (dec["stop_ref"]["epoch"], dec["stop_ref"]["deltas"]) != (
            dec["stop_piped"]["epoch"], dec["stop_piped"]["deltas"]):
        raise AssertionError(f"fused p3 stop: {dec['stop_piped']} against {dec['stop_ref']}")
    run5 = dict(stopping_delta=0.0, max_epochs=6)
    ref = dec_run("ref", eval_interval=1, **run5)
    for name, kw in (("deferred", dict(eval_interval=3)),
                     ("piped", dict(eval_interval=3, pipeline_delta=True)),
                     ("stepped", dict(eval_interval=1, fused_epoch=False))):
        same(ref, dec_run(name, **kw, **run5), name)
        if dec[name]["deltas"] != dec["ref"]["deltas"] or len(dec["ref"]["deltas"]) != 5:
            raise AssertionError(f"fused p3 {name}: deltas {dec[name]['deltas']} against "
                                 f"{dec['ref']['deltas']}")
    say("fused", check="p3 deferred and pipelined cadences against the unlagged loop",
        runs=json.dumps(dec), card=repr(smi))

    # ---- timings, in turns
    timing = {}
    for tag, cfg_x, ds_x in (("default", cfg, ds), ("scaled", scfg, sds),
                             ("default_bf16", cfg.replace(compute_dtype="bfloat16"), ds)):
        tr = Trainer(cfg_x.replace(fused_epoch=False), {"training": ds_x["training"]},
                     os.path.join(root, "timing_" + tag), device=dev)
        tr.train_steps(2)  # warm-up
        stream = tr._stream()
        step = lambda: tr.step(*next(stream))  # noqa: E731
        # the graph captured under the tracer counts its replays on the card
        tracing.enable(dev)
        replay = profiling.graphed_step(tr)
        replay()  # warm-up and capture
        graph = tr._graphs[("train", False)]
        n = 4 if tag == "scaled" else 10
        turns = profiling.step_turns({"stepped": step, "graphed": replay}, 3, n)
        prof = {name: profiling.device_profile(fn, 5 if name == "stepped" else 20)
                for name, fn in (("stepped", step), ("graphed", replay))}
        unrun = tracing.report()["counters"]["graph.replays_unrun"]
        tracing.disable()
        tr.close()
        if unrun != 0:
            raise AssertionError(f"fused {tag}: {unrun} replays the host launched never ran")
        measured = _replay_launches(prof["graphed"], graph.launches, tag)
        median = {k: float(np.median(v)) for k, v in turns.items()}
        timing[tag] = dict(
            step_ms_turns={k: [round(x, 4) for x in v] for k, v in turns.items()},
            encounters_per_s={k: round(cfg_x.batch_size / v * 1e3, 1) for k, v in median.items()},
            device_busy_ms={k: round(p["device_busy_ms"] / p["window_steps"], 4)
                            for k, p in prof.items()},
            device_ops_per_step={k: p["device_events_per_step"] for k, p in prof.items()},
            idle_share={k: round(1.0 - p["device_busy_ms"] / p["window_steps"] / median[k], 4)
                        for k, p in prof.items()},
            # within the profiled window itself (the profiler slows the host)
            idle_share_profiled={k: round(p["device_idle_share"], 4) for k, p in prof.items()},
            hand_kernel_ms={k: round(sum(h["ms_per_step"] for h in p["hand_kernels"]), 4)
                            for k, p in prof.items()},
            capture_s=round(graph.capture_seconds, 4), pool_bytes=graph.pool_bytes,
            launches_per_replay=graph.launches, profiled_launches_per_replay=measured,
            replays_traced=prof["graphed"]["steps_traced"], replays=graph.replays,
            replays_unrun=unrun)
        say("fused", timing=tag, batch=cfg_x.batch_size, T=cfg_x.num_timestamps,
            **{k: json.dumps(v) for k, v in timing[tag].items()}, card=repr(smi))

    # cli.p1 epochs: stepped, then fused (the default), three epochs each
    p1_epochs = {}
    for name, extra in (("stepped", ["--fused_epoch", "false"]), ("fused", [])):
        argv = run["width"] + ["--max_epochs", "4", "--results_path",
                               os.path.join(root, "p1_" + name)] + extra
        _, epochs = _logged_epochs(lambda: p1.main(argv))
        if len(epochs) != 3:
            raise AssertionError(f"fused cli.p1 {name}: {len(epochs)} epoch lines")
        p1_epochs[name] = [round(s, 4) for s, _ in epochs]
    say("fused", check="cli.p1 epoch seconds", epoch_s=json.dumps(p1_epochs),
        encounters=len(ds["training"]), card=repr(smi))
    return dict(bits=bits, dec=dec, timing=timing, p1_epochs=p1_epochs)


def convert_phase(run: dict, smi: str) -> None:
    """The converter on the p1 phase's weight root: `to_torch` in directory
    mode; each tar loads with strict=True into a fresh port Net on the card,
    whose validation eval gives the dump's latents again (1e-6), and its
    optimizer state into the amsgrad Adam over that Net; `to_jax` of the
    tars gives the checkpoints' params and state back bit for bit."""
    import torch

    from deep_interpolation_clustering_tpu_torch.cli import convert
    from deep_interpolation_clustering_tpu_torch.cli.common import (
        build_parser, config_from_args, make_datasets,
    )
    from deep_interpolation_clustering_tpu_torch.train import Trainer, make_optimizer
    from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt

    weight = os.path.join(run["exp"], "weight")
    root = os.path.join(os.path.dirname(run["results"]), "convert")
    tars, back = os.path.join(root, "tars"), os.path.join(root, "npz")
    seconds = {}
    t0 = time.perf_counter()
    convert.main(["to_torch", "--src", weight, "--dst", tars])
    seconds["to_torch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    convert.main(["to_jax", "--src", tars, "--dst", back])
    seconds["to_jax"] = time.perf_counter() - t0
    cfg = config_from_args(build_parser("convert").parse_args(run["width"]))
    ds = make_datasets(cfg)["validation"]
    errs = {}
    for m in ("loss", "ae_mse"):
        t0 = time.perf_counter()
        blob = torch.load(os.path.join(tars, m, convert.TORCH_NAME), map_location="cpu",
                          weights_only=True)
        tr = Trainer(cfg, {"validation": ds}, os.path.join(root, f"eval_{m}"), device="cuda")
        tr.net.load_state_dict(blob["state_dict"], strict=True)
        opt = make_optimizer(cfg, tr.net.parameters())
        opt.load_state_dict(blob["optimizer"])
        if not (isinstance(opt, torch.optim.Adam) and opt.param_groups[0]["amsgrad"]):
            raise AssertionError(f"convert {m}: optimizer {type(opt).__name__}")
        _, dumps = tr.eval_one_epoch("valid", ds, False)
        hidden = tr.merge_ob_pred(ds, dumps)["hidden"]
        torch.cuda.synchronize()
        seconds[f"load_eval_{m}"] = time.perf_counter() - t0
        tr.close()
        dump = np.load(os.path.join(run["exp"], "out_feat", m, "validation.npy"),
                       allow_pickle=True).item()
        errs[m] = float(np.abs(hidden - dump["hidden"]).max())
        if not errs[m] <= 1e-6:
            raise AssertionError(f"convert {m}: the tar's latents differ from the dump by "
                                 f"{errs[m]}")
        _, p_want, s_want, _, _ = ckpt.load_checkpoint(os.path.join(weight, m, ckpt.CKPT_NAME))
        _, p_got, s_got, _, meta = ckpt.load_checkpoint(os.path.join(back, m, ckpt.CKPT_NAME))
        want = ckpt._flatten_nested({"params": p_want, "state": s_want})
        got = ckpt._flatten_nested({"params": p_got, "state": s_got})
        differ = [k for k in want if k not in got or not np.array_equal(got[k], want[k])]
        if differ or set(got) != set(want):
            raise AssertionError(f"convert {m}: to_jax of the tar differs at {differ}")
        if meta["lr"] != ckpt.load_meta(os.path.join(weight, m, ckpt.CKPT_NAME))["lr"]:
            raise AssertionError(f"convert {m}: rate {meta['lr']} not carried")
    say("convert", metrics=["loss", "ae_mse"], latent_err=json.dumps(errs),
        seconds=json.dumps({k: round(v, 4) for k, v in seconds.items()}), card=repr(smi))


def _captured_stderr(fn):
    """Run `fn()` with file descriptor 2 (and so the log lines of every rank
    it spawns) sent to a file; returns (fn's result, the text), the text
    also passed on to this process's stderr."""
    with tempfile.TemporaryFile("w+") as f:
        sys.stderr.flush()
        saved = os.dup(2)
        os.dup2(f.fileno(), 2)
        try:
            out = fn()
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
        f.seek(0)
        text = f.read()
    sys.stderr.write(text)
    return out, text


def _epoch_lines(text: str) -> dict:
    """{rank: [(epoch seconds, encounters/s)]} from the trainer's epoch log
    lines (rank 0 without a group)."""
    import re

    out = {}
    for m in re.finditer(r"epoch \d+ trained in ([0-9.]+) s, ([0-9.]+) encounters/s"
                         r"(?: \(rank (\d+) of \d+\))?", text):
        out.setdefault(int(m.group(3) or 0), []).append((float(m.group(1)),
                                                         float(m.group(2))))
    return out


def _cohort_lines(text: str) -> dict:
    """From the trainer's log lines of a sharded run: {(cohort, rank):
    (bytes a rank, bytes replicated)} and {rank: [seconds of each epoch's
    relayout]}."""
    import re

    out = {"bytes": {}, "relayout_s": {}}
    for m in re.finditer(r"cohort '(\w+)' row-sharded over \d+ ranks: (\d+) bytes "
                         r"\([0-9.]+ MB\) a rank, (\d+) bytes .*\(rank (\d+)\)", text):
        out["bytes"][m.group(1), int(m.group(4))] = (int(m.group(2)), int(m.group(3)))
    for m in re.finditer(r"cohort relayout for epoch \d+ in ([0-9.]+) s \(rank (\d+)", text):
        out["relayout_s"].setdefault(f"rank{m.group(2)}", []).append(float(m.group(1)))
    return out


def _files(folder: str) -> list:
    """The files under `folder` (TensorBoard event files, named by time and
    host, left out)."""
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, fs in os.walk(folder) for f in fs
                  if not f.startswith("events.out.tfevents"))


def _run_files(exp: str) -> dict:
    """A p1 or p3 run directory's checkpoints and dumps, and its summary
    rows."""
    from deep_interpolation_clustering_tpu_torch.info import COHORTS, METRICS

    out = {}
    for m in METRICS:
        path = os.path.join(exp, "weight", m, "checkpoint.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                out[("ckpt", m)] = {k: z[k] for k in z.files}
        for cohort in COHORTS:
            path = os.path.join(exp, "out_feat", m, f"{cohort}.npy")
            if os.path.exists(path):
                out[("dump", m, cohort)] = np.load(path, allow_pickle=True).item()
    with open(os.path.join(exp, "summary", "events.jsonl")) as f:
        out["rows"] = [json.loads(line) for line in f]
    return out


def _bit_differences(a: dict, b: dict) -> list:
    """The entries of two `_run_files` that are not the same bits."""
    bad = [k for k in set(a) ^ set(b)]
    for k in set(a) & set(b):
        if k == "rows":
            if a[k] != b[k]:
                bad.append(k)
            continue
        for name in set(a[k]) | set(b[k]):
            x, y = a[k].get(name), b[k].get(name)
            if x is None or y is None or not np.array_equal(np.asarray(x), np.asarray(y)):
                bad.append((k, name))
    return bad


# invariant 1's band (the JAX package's sharded-vs-single contract): train
# losses, validation ae_mse, the largest parameter difference, the share of
# parameter elements beyond 1e-4, latents, rec_ob beyond its rtol 3e-4, soft
# cluster labels
BAND = dict(max_loss_diff=1e-5, max_valid_ae_mse_diff=5e-4, max_param_diff=5e-3,
            beyond_1e4_share=1e-3, max_hidden_diff=1e-4, rec_ob_excess_over_rtol=1e-4,
            max_cluster_pred_diff=1e-4)
# a nudge of every weight by 2^-24 of itself, random in sign: the size of
# the float32 summation-order differences between two ranks and one process
NUDGE = 2.0 ** -24


def _drift(got: dict, want: dict, tag: str) -> dict:
    """How far one run's `_run_files` are from another's, in `BAND`'s
    measures, and the label flips of the soft cluster labels."""
    rows, wrows = got["rows"], want["rows"]
    if [(r["scope"], r["step"]) for r in rows] != [(r["scope"], r["step"]) for r in wrows]:
        raise AssertionError(f"dp {tag}: summary rows {[(r['scope'], r['step']) for r in rows]}")
    loss_diff = max([abs(r["loss"] - w["loss"]) for r, w in zip(rows, wrows)
                     if r["scope"] == "train"] or [0.0])
    ae_diff = max([abs(r["ae_mse"] - w["ae_mse"]) for r, w in zip(rows, wrows)
                   if r["scope"] == "valid"] or [0.0])
    worst, n_viol, n_tot = 0.0, 0, 0
    for k in want:
        if k[0] != "ckpt":
            continue
        for name, w in want[k].items():
            if name.startswith("params/"):
                d = np.abs(got[k][name] - w)
                worst = max(worst, float(d.max()))
                n_viol += int((d > 1e-4).sum())
                n_tot += d.size
    hidden = rec = soft = 0.0
    flips = 0
    for k in want:
        if k[0] != "dump":
            continue
        g, w = got[k], want[k]
        if list(g["encounter_id"]) != list(w["encounter_id"]):
            raise AssertionError(f"dp {tag}: {k} encounters differ")
        hidden = max(hidden, float(np.abs(g["hidden"] - w["hidden"]).max()))
        if "rec_ob" in w:
            excess = np.abs(g["rec_ob"] - w["rec_ob"]) - 3e-4 * np.abs(w["rec_ob"])
            rec = max(rec, float(excess.max()))
        if "cluster_pred" in w:
            soft = max(soft, float(np.abs(g["cluster_pred"] - w["cluster_pred"]).max()))
            flips = max(flips, int((g["cluster_pred"].argmax(1)
                                    != w["cluster_pred"].argmax(1)).sum()))
    return dict(max_loss_diff=loss_diff, max_valid_ae_mse_diff=ae_diff, max_param_diff=worst,
                beyond_1e4_share=n_viol / max(n_tot, 1), max_hidden_diff=hidden,
                rec_ob_excess_over_rtol=rec, max_cluster_pred_diff=soft, label_flips=flips)


def _held(drift: dict, nudged: dict, tag: str) -> None:
    """Hold a two-epoch drift to invariant 1's band or, where the training
    trajectory amplifies float32 noise past it, to 10x the drift of the one
    process under a `NUDGE` of its weights (measured in the same call):
    summation order cannot be held closer than that."""
    over = {k: (v, lim, nudged[k]) for k, v in drift.items() if k in BAND
            for lim in [BAND[k]] if v > max(lim, 10 * nudged[k])}
    if drift["label_flips"] > max(1, 10 * nudged["label_flips"]):
        over["label_flips"] = (drift["label_flips"], 1, nudged["label_flips"])
    if over:
        raise AssertionError(f"dp {tag}: drift (value, band, nudged) {over}")


def _nudge_(net) -> None:
    """Every parameter of `net` times 1 +- `NUDGE` (signs from seed 0)."""
    import torch

    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            sign = torch.randint(0, 2, p.shape, generator=g).to(p.device, p.dtype) * 2 - 1
            p.add_(p * sign * NUDGE)


def _nudged(cls, method: str, fn):
    """Run `fn()` with `_nudge_` applied to the net after `cls.method`."""
    saved = getattr(cls, method)

    def wrapped(self, *args, **kw):
        out = saved(self, *args, **kw)
        _nudge_(self.net)
        return out

    setattr(cls, method, wrapped)
    try:
        return fn()
    finally:
        setattr(cls, method, saved)


def _dp_step_rank(r: int, address: str, argv: list, exp: str, backend: str):
    """One rank of the step check (`_two_steps` as rank r of 2)."""
    from deep_interpolation_clustering_tpu_torch import parallel

    dev = parallel.initialize(address, 2, r, "cuda", backend)
    try:
        return _two_steps(argv, exp, dev)
    finally:
        parallel.shutdown()


def _two_steps(argv: list, exp: str, dev):
    """A Trainer from the seed's weights takes the first full batch and the
    masked tail (whose second half is all padding); returns each step's
    losses and the parameters after both."""
    from deep_interpolation_clustering_tpu_torch.cli.common import (
        build_parser, config_from_args, make_datasets,
    )
    from deep_interpolation_clustering_tpu_torch.train import Trainer

    cfg = config_from_args(build_parser("p1").parse_args(argv))
    tr = Trainer(cfg, make_datasets(cfg), exp, device=dev)
    batches = tr._epoch_batches(1)
    losses = [{k: float(v) for k, v in tr.step(*batches[i]).items()} for i in (0, -1)]
    params = {n: p.detach().cpu().numpy() for n, p in tr.net.named_parameters()}
    tr.close()
    return losses, params


def _nccl_rank(r: int, address: str, world: int, argv: list, root: str) -> dict:
    """Rank r of a NCCL group of `world` ranks, card r each, on the fused
    epoch's step at `argv`'s Config: the replayed step against the same
    group's stepped step and, at one rank, against the same trainer's replay
    without a group (captured before the group is made), in turns; the
    collectives a stepped step issues, those issued while its graph is
    captured and those its replays issue (none); each one's device busy ms,
    device operations, NCCL kernels and their ms, from the profiler; the
    hand kernels a replay ran against the launches counted at capture
    (`_replay_launches`); the replays the host launched less the card's
    count of them (`utils.tracing`, the graph captured with the tracer on);
    the graph's capture seconds and pool bytes."""
    import torch

    from deep_interpolation_clustering_tpu_torch import parallel
    from deep_interpolation_clustering_tpu_torch.cli.common import (
        build_parser, config_from_args, make_datasets,
    )
    from deep_interpolation_clustering_tpu_torch.train import Trainer
    from deep_interpolation_clustering_tpu_torch.utils import profiling, tracing

    cfg = config_from_args(build_parser("p1").parse_args(argv))
    train = {"training": make_datasets(cfg)["training"]}
    steps = {}
    if world == 1:
        alone = Trainer(cfg, train, os.path.join(root, "no_group"), device="cuda")
        alone.train_steps(2)
        steps["no_group"] = profiling.graphed_step(alone)
        steps["no_group"]()  # warm-up and capture, without a group
    dev = parallel.initialize(address, world, r, "cuda", "nccl")
    try:
        tr = Trainer(cfg, train, os.path.join(root, "group"), device=dev)
        tr.train_steps(2)  # the optimizer's state, the communicator
        stream = tr._stream()
        steps["stepped"] = lambda: tr.step(*next(stream))
        # on for the rest: the graph captured below counts its replays on the card
        tracing.enable(dev)
        with profiling.collective_calls() as calls:
            steps["stepped"]()
            torch.cuda.synchronize()
        per_step = dict(calls)
        replay = steps["replayed"] = profiling.graphed_step(tr)
        with profiling.collective_calls() as calls:
            replay()  # the warm-up's steps, the capture, a replay
            torch.cuda.synchronize()
            at_capture = dict(calls)
            for _ in range(3):
                replay()
            torch.cuda.synchronize()
        replay_calls = sum(calls.values()) - sum(at_capture.values())
        graph = tr._graphs[("train", False)]
        turns = profiling.step_turns(steps, 3, 10)
        prof = {name: profiling.device_profile(fn, 5 if name == "stepped" else 20)
                for name, fn in steps.items()}
        hand = _replay_launches(prof["replayed"], graph.launches, f"dp nccl rank {r}")
        unrun = tracing.report()["counters"]["graph.replays_unrun"]
        tracing.disable()
        tr.close()
    finally:
        parallel.shutdown()
    median = {k: float(np.median(v)) for k, v in turns.items()}
    return dict(
        world=world, step_ms_turns={k: [round(x, 4) for x in v] for k, v in turns.items()},
        device_busy_ms={k: round(p["device_busy_ms"] / p["window_steps"], 4)
                        for k, p in prof.items()},
        idle_share={k: round(1.0 - p["device_busy_ms"] / p["window_steps"] / median[k], 4)
                    for k, p in prof.items()},
        device_ops_per_step={k: p["device_events_per_step"] for k, p in prof.items()},
        nccl_kernels_per_step={k: p["nccl_kernels_per_step"] for k, p in prof.items()},
        nccl_ms_per_step={k: round(p["nccl_ms_per_step"], 4) for k, p in prof.items()},
        collectives_stepped_step=per_step, collectives_at_capture=at_capture,
        collectives_three_replays=replay_calls, capture_s=round(graph.capture_seconds, 4),
        pool_bytes=graph.pool_bytes, launches_per_replay=graph.launches,
        profiled_launches_per_replay=hand, replays_traced=prof["replayed"]["steps_traced"],
        replays=graph.replays, replays_unrun=unrun)


def _held_nccl(m: dict, tag: str) -> None:
    """The checks of a `_nccl_rank` result: its stepped step issued
    collectives, the capture issued each once more, the replays none; the
    card ran every replay the host launched; a replay ran the NCCL kernels
    of a stepped step, and at two ranks or more one a collective (over one
    rank NCCL runs none for an in-place sum)."""
    per_step = m["collectives_stepped_step"]["eager"]
    nccl = m["nccl_kernels_per_step"]
    bad = []
    if not per_step or m["collectives_at_capture"]["captured"] != per_step:
        bad.append(("captured", m["collectives_at_capture"], per_step))
    if m["collectives_three_replays"]:
        bad.append(("replays issued", m["collectives_three_replays"]))
    if m["replays_unrun"] != 0:
        bad.append(("replays the card never ran", m["replays_unrun"]))
    if nccl["replayed"] != nccl["stepped"]:
        bad.append(("nccl kernels", nccl))
    if m["world"] > 1 and nccl["replayed"] != per_step:
        bad.append(("nccl kernels a collective", nccl, per_step))
    if bad:
        raise AssertionError(f"dp {tag}: {bad}")


def dp_phase(run: dict, smi: str) -> dict:
    """Data-parallel p1 and p3, and multi-process p2 and p4, through the
    entry points at the default Config on the p0 phase's pickles:
      (a) `cli.p1.main --data_parallel 1` (a one-rank NCCL group, whose
          epochs replay captured graphs with the group's collectives in
          them) writes the same bits as the same argv without a group
          (invariant 2) and as the group's stepped run (`--fused_epoch
          false`), and so does `python -m torch.distributed.run --standalone
          --nproc_per_node 1 -m ...cli.p1 --num_processes 1` (env://); the
          epoch lines say "(fused)"; `cli.p3.main --data_parallel 1`, fused
          and stepped, writes the bits of p3 without a group; and one rank
          of a NCCL group measures the replayed step against the stepped
          one and against a replay without a group (`_nccl_rank`, held by
          `_held_nccl`);
      (b) two ranks sharing the card over gloo: one full-width step and the
          masked tail from the same weights and draws within invariant 1's
          band (`BAND`) of one process, the ranks' parameters the same bits;
          then `cli.p1.main --data_parallel 2` for two epochs against (a),
          each file written once, the ranks' launch counts showing B1 and
          B3-B7 (the trainer checks the ranks' state bit for bit after
          every epoch). Over 18 full-width steps the training trajectory
          amplifies float32 noise past the band: one process whose weights
          are nudged by 2^-24 of themselves drifts as far from (a) as two
          ranks do. So the two-epoch run is held to the band or to 10x that
          nudged run's drift, measured here, whichever is larger (`_held`);
      (c) two NCCL ranks, one card each, where the machine has two cards:
          p1 fused and stepped, the same bits, both held as (b), and
          `_nccl_rank` at two ranks (a replay's NCCL kernels one a
          collective);
      (d) `cli.p3.main --data_parallel 2` (gloo) for 3 DEC epochs against
          one process, held as (b) against a run nudged after the centre
          init, the label deltas too;
      (e) `cli.p2.main` and `cli.p4.main` at `--num_processes 2` as two
          processes on the card: the CSVs at rtol 1e-5 / atol 1e-6 and the
          labels exactly those of one process.
    Two ranks on one card show the path is correct; they say nothing of
    scaling. Returns what it measured."""
    import shutil

    import torch

    from deep_interpolation_clustering_tpu_torch import Config, parallel
    from deep_interpolation_clustering_tpu_torch.cli import p1, p2, p3, p4
    from deep_interpolation_clustering_tpu_torch.info import COHORTS
    from deep_interpolation_clustering_tpu_torch.train import ClusterTrainer, Trainer

    root = os.path.join(os.path.dirname(run["results"]), "dp")
    width = run["width"] + ["--max_epochs", "3"]
    n_train = len(run["cohorts"]["training"]["encounter_id"])
    need = ("fake_select", "sci_forward", "sci_backward", "rbf_push", "lstm_forward",
            "lstm_backward", "clip_adam")
    report, seconds, texts = {}, {}, {}

    def results(name):
        return ["--results_path", os.path.join(root, name)]

    def timed(name, fn):
        t0 = time.perf_counter()
        out, text = _captured_stderr(fn)
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 3)
        texts[name] = text
        epochs = _epoch_lines(text)
        report[name] = {f"rank{r}": [dict(epoch_s=round(s, 4), encounters_per_s=round(e, 1))
                                     for s, e in v] for r, v in sorted(epochs.items())}
        return out

    def ranks_launched(name):
        counts = list(parallel.multihost.last_rank_launches)
        missing = [(r, k) for r, c in enumerate(counts) for k in need if not c.get(k)]
        if not counts or missing:
            raise AssertionError(f"dp {name}: kernels never launched on a rank: {missing}")
        return [{k: c[k] for k in need} for c in counts]

    def fused_lines(name, fused):
        """The run's epoch lines all say "(fused)", or none does."""
        lines = [x for x in texts[name].splitlines() if " trained in " in x]
        if not lines or any(x.endswith("(fused)") != fused for x in lines):
            raise AssertionError(f"dp {name}: epoch lines {lines}")

    # (a) one-rank NCCL group vs no group, the same argv, fused and stepped
    single = timed("single", lambda: p1.main(width + results("single")))
    one = timed("dp1", lambda: p1.main(width + results("dp1") + ["--data_parallel", "1"]))
    one_stepped = timed("dp1_stepped", lambda: p1.main(
        width + results("dp1_stepped") + ["--data_parallel", "1", "--fused_epoch", "false"]))
    launches = {"dp1": ranks_launched("dp1")}
    fused_lines("single", True)
    fused_lines("dp1", True)
    fused_lines("dp1_stepped", False)
    for run_x, name in ((one, "--data_parallel 1"),
                        (one_stepped, "--data_parallel 1 --fused_epoch false")):
        differ = _bit_differences(_run_files(run_x), _run_files(single))
        if differ or _files(run_x) != _files(single):
            raise AssertionError(f"dp (a): {name} differs from one process: {differ[:8]}")
    nccl_1 = parallel.spawn(_nccl_rank, 1, (f"127.0.0.1:{parallel.free_port()}", 1,
                                            width + results("nccl_1"),
                                            os.path.join(root, "nccl_1")), timeout_s=600)[0]
    _held_nccl(nccl_1, "(a) one NCCL rank")
    # (a) through torchrun's env:// launch, as a user types it
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    trun = os.path.join(root, "torchrun")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", "deep_interpolation_clustering_tpu_torch.cli.p1"] + width + [
           "--results_path", trun, "--num_processes", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    seconds["torchrun_1"] = round(time.perf_counter() - t0, 3)
    if proc.returncode != 0:
        raise AssertionError(f"dp (a): torchrun failed:\n{proc.stderr[-4000:]}")
    differ = _bit_differences(_run_files(os.path.join(trun, "Pretrain")), _run_files(one))
    if differ:
        raise AssertionError(f"dp (a): torchrun --num_processes 1 differs from "
                             f"--data_parallel 1: {differ[:8]}")

    # (b) two gloo ranks on the card: the step check, then the entry point
    address = f"127.0.0.1:{parallel.free_port()}"
    step_argv = width + results("step")
    t0 = time.perf_counter()
    ranks = parallel.spawn(_dp_step_rank, 2, (address, step_argv,
                                              os.path.join(root, "step_dp"), "gloo"))
    seconds["step_check"] = round(time.perf_counter() - t0, 3)
    alone = _two_steps(step_argv, os.path.join(root, "step_one"), "cuda")
    step = {}
    for i, tag in enumerate(("first_batch", "tail")):
        step[f"{tag}_loss_diff"] = max(abs(ranks[0][0][i][k] - v)
                                       for k, v in alone[0][i].items())
    worst, n_viol, n_tot = 0.0, 0, 0
    for n, w in alone[1].items():
        d = np.abs(ranks[0][1][n] - w)
        worst = max(worst, float(d.max()))
        n_viol += int((d > 1e-4).sum())
        n_tot += d.size
        if not np.array_equal(ranks[0][1][n], ranks[1][1][n]):
            raise AssertionError(f"dp (b): ranks hold different {n} after the steps")
    step.update(max_param_diff=worst, beyond_1e4=f"{n_viol}/{n_tot}")
    step["beyond_1e4_share"] = n_viol / n_tot
    if not (max(step["first_batch_loss_diff"], step["tail_loss_diff"]) < BAND["max_loss_diff"]
            and worst < BAND["max_param_diff"]
            and step["beyond_1e4_share"] <= BAND["beyond_1e4_share"]):
        raise AssertionError(f"dp (b): two-rank steps outside the band: {step}")
    two = timed("gloo_2", lambda: p1.main(width + results("gloo_2") + ["--data_parallel", "2"],
                                          backend="gloo"))
    launches["gloo_2"] = ranks_launched("gloo_2")
    fused_lines("gloo_2", False)  # gloo's collectives cannot be captured: the ranks step
    # the yardstick: one process with its initial weights nudged
    nudged = timed("nudged", lambda: _nudged(Trainer, "__init__",
                                             lambda: p1.main(width + results("nudged"))))
    base = _run_files(one)
    drift = {"nudged": _drift(_run_files(nudged), base, "(b) nudged"),
             "gloo_2": _drift(_run_files(two), base, "(b)")}
    _held(drift["gloo_2"], drift["nudged"], "(b)")
    if _files(two) != _files(one):
        raise AssertionError("dp (b): the two-rank run's files are not the one-rank run's")
    # (b) with every rank holding the whole cohort: the sharded run's bits
    rep = timed("gloo_2_replicated", lambda: p1.main(
        width + results("gloo_2_replicated") + ["--data_parallel", "2", "--shard_cohort",
                                                "false"], backend="gloo"))
    differ = _bit_differences(_run_files(rep), _run_files(two))
    if differ or _files(rep) != _files(two):
        raise AssertionError(f"dp (b): shard_cohort false differs from the sharded run: "
                             f"{differ[:8]}")
    p1_cohort = _cohort_lines(texts["gloo_2"])
    if sorted(p1_cohort["bytes"]) != sorted((c, r) for c in COHORTS for r in (0, 1)) or \
            _cohort_lines(texts["gloo_2_replicated"])["bytes"]:
        raise AssertionError(f"dp (b): the sharded run's cohorts: {p1_cohort}")

    # (c) two NCCL ranks, one card each, fused and stepped
    nccl_2_timing = None
    if torch.cuda.device_count() >= 2:
        nccl = timed("nccl_2", lambda: p1.main(width + results("nccl_2")
                                               + ["--data_parallel", "2"]))
        launches["nccl_2"] = ranks_launched("nccl_2")
        nccl_stepped = timed("nccl_2_stepped", lambda: p1.main(
            width + results("nccl_2_stepped") + ["--data_parallel", "2", "--fused_epoch",
                                                 "false"]))
        fused_lines("nccl_2", True)
        fused_lines("nccl_2_stepped", False)
        differ = _bit_differences(_run_files(nccl), _run_files(nccl_stepped))
        if differ:
            raise AssertionError(f"dp (c): two NCCL ranks fused and stepped differ: "
                                 f"{differ[:8]}")
        for name, x in (("nccl_2", nccl), ("nccl_2_stepped", nccl_stepped)):
            drift[name] = _drift(_run_files(x), base, f"(c) {name}")
            _held(drift[name], drift["nudged"], f"(c) {name}")
        nccl_2_timing = parallel.spawn(
            _nccl_rank, 2, (f"127.0.0.1:{parallel.free_port()}", 2, width + results(
                "nccl_2_timing"), os.path.join(root, "nccl_2_timing")), timeout_s=600)
        for r, m in enumerate(nccl_2_timing):
            _held_nccl(m, f"(c) rank {r} of two NCCL ranks")
        nccl_2 = "ran"
    else:
        nccl_2 = "skipped: 1 card"

    # (d) p3 under two gloo ranks against one process
    p3_argv = width[:-2] + ["--max_epochs", "4", "--stopping_delta", "0", "--pretrain_path",
                            single]
    p3_one = timed("p3_single", lambda: p3.main(p3_argv + results("p3_single")))
    # p3 in a one-rank NCCL group, fused and stepped: the bits of no group
    for name, extra in (("p3_dp1", []), ("p3_dp1_stepped", ["--fused_epoch", "false"])):
        x = timed(name, lambda: p3.main(p3_argv + results(name) + ["--data_parallel", "1"]
                                        + extra))
        fused_lines(name, not extra)
        differ = _bit_differences(_run_files(x), _run_files(p3_one))
        if differ or _files(x) != _files(p3_one):
            raise AssertionError(f"dp (d): {name} differs from p3 without a group: "
                                 f"{differ[:8]}")
    p3_two = timed("p3_gloo_2", lambda: p3.main(p3_argv + results("p3_gloo_2")
                                                + ["--data_parallel", "2"], backend="gloo"))
    launches["p3_gloo_2"] = ranks_launched("p3_gloo_2")
    fused_lines("p3_gloo_2", False)
    p3_cohort = _cohort_lines(texts["p3_gloo_2"])
    if not p3_cohort["relayout_s"]:
        raise AssertionError(f"dp (d): p3 at two ranks not sharded: {p3_cohort}")
    # the yardstick: one process with the weights nudged after the centre init
    p3_nudged = timed("p3_nudged", lambda: _nudged(
        ClusterTrainer, "init_centers", lambda: p3.main(p3_argv + results("p3_nudged"))))
    p3_base = _run_files(p3_one)
    runs = {"p3_nudged": _run_files(p3_nudged), "p3_gloo_2": _run_files(p3_two)}
    for name, x in runs.items():
        drift[name] = _drift(x, p3_base, f"(d) {name}")
        drift[name]["max_delta_diff"] = max(
            abs(r["delta"] - w["delta"]) for r, w in zip(x["rows"], p3_base["rows"])
            if r["scope"] == "valid")
    _held(drift["p3_gloo_2"], drift["p3_nudged"], "(d)")
    d2, dn = drift["p3_gloo_2"]["max_delta_diff"], drift["p3_nudged"]["max_delta_diff"]
    n_valid = len(run["cohorts"]["validation"]["encounter_id"])
    if d2 > max(1.0 / n_valid, 10 * dn):
        raise AssertionError(f"dp (d): label deltas {d2} apart (nudged {dn})")

    # (e) p2 and p4 as two processes on the card against one process
    p2_argv = ["--restore_metrics", "ae_mse", "--k_max", "6", "--n_init", "3", "--gap_b", "3"]
    p4_argv = ["--stage", "Pretrain", "--restore_metrics", "ae_mse", "--cluster_method",
               "kmeans"]
    multi = os.path.join(root, "p2p4_multi")
    shutil.copytree(os.path.join(root, "single"), multi)
    ports = [parallel.free_port() for _ in range(2)]

    def rank_code(pid):
        def flags(i):
            return ["--results_path", multi, "--num_processes", "2", "--process_id", str(pid),
                    "--coordinator_address", f"127.0.0.1:{ports[i]}"]
        return ("from deep_interpolation_clustering_tpu_torch.cli import p2, p4\n"
                f"p2.main({p2_argv + flags(0)!r})\np4.main({p4_argv + flags(1)!r})\n")

    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", rank_code(pid)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds["p2p4_2proc"] = round(time.perf_counter() - t0, 3)
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"dp (e): a p2/p4 process failed:\n{out[-4000:]}")
    single_results = os.path.join(root, "single")
    t0 = time.perf_counter()
    p2_one = p2.main(p2_argv + ["--results_path", single_results])
    seconds["p2_single"] = round(time.perf_counter() - t0, 3)
    labels = p4.main(p4_argv + ["--results_path", single_results])
    seconds["p2p4_single"] = round(time.perf_counter() - t0, 3)
    plot = os.path.join("Pretrain", "opt_k", "ae_mse", "plot")
    for name in ("gap_sts_v1.csv", "elbow.csv"):
        with open(os.path.join(multi, plot, name)) as f:
            got = f.read().splitlines()
        with open(os.path.join(single_results, plot, name)) as f:
            want = f.read().splitlines()
        if got[0] != want[0]:
            raise AssertionError(f"dp (e): {name} header {got[0]}")
        g = np.array([[float(x) for x in row.split(",")] for row in got[1:]])
        w = np.array([[float(x) for x in row.split(",")] for row in want[1:]])
        if g.shape != w.shape or not np.allclose(g, w, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"dp (e): {name} differs from one process")
    k = Config().num_clusters
    for cohort in COHORTS:
        path = os.path.join("Pretrain", "out_feat", "ae_mse_kmeans_aligned", f"{cohort}_{k}.npy")
        d = np.load(os.path.join(multi, path), allow_pickle=True).item()
        if not np.array_equal(d["cluster_id"], labels["ae_mse"][cohort]):
            raise AssertionError(f"dp (e): p4 labels of {cohort} differ from one process")
    if _files(os.path.join(multi, "Pretrain", "opt_k")) != _files(
            os.path.join(single_results, "Pretrain", "opt_k")):
        raise AssertionError("dp (e): the two processes' opt_k files are not one process's")

    # (f) p2 --data_parallel 2: two gloo ranks on the card, the latents
    # row-sharded, against one process
    sharded_p2 = os.path.join(root, "p2_dp2")
    shutil.copytree(os.path.join(single_results, "Pretrain", "out_feat"),
                    os.path.join(sharded_p2, "Pretrain", "out_feat"))
    p2_two = timed("p2_gloo_2", lambda: p2.main(
        p2_argv + ["--results_path", sharded_p2, "--data_parallel", "2"], backend="gloo"))
    n_valid = len(run["cohorts"]["validation"]["encounter_id"])
    for n_rows in (n_train, n_valid):
        if f"{n_rows} rows row-sharded over 2 ranks" not in texts["p2_gloo_2"]:
            raise AssertionError(f"dp (f): {n_rows} rows not row-sharded")
    p2_gap = {}
    for name in ("gap_sts_v1.csv", "elbow.csv"):
        with open(os.path.join(sharded_p2, plot, name)) as f:
            got = list(csv.DictReader(f))
        with open(os.path.join(single_results, plot, name)) as f:
            want = list(csv.DictReader(f))
        if len(got) != len(want) or [r.keys() for r in got] != [r.keys() for r in want]:
            raise AssertionError(f"dp (f): {name} has other rows or columns")
        for r, w in zip(got, want):
            for key in w:
                if key == "k":
                    if r[key] != w[key]:
                        raise AssertionError(f"dp (f): {name} k {r[key]} vs {w[key]}")
                    continue
                # ref_s is the spread of gap_b log inertias ~1e-3 apart: the
                # logs' rounding (~1e-7 of |ref|) moves it by ~1e-4 of itself,
                # so it is held to 1e-5 of the logs it spreads, |ref|
                scale = abs(float(w["ref" if key == "ref_s" else key]))
                rel = abs(float(r[key]) - float(w[key])) / max(scale, 1e-30)
                p2_gap[f"{name}:{key}"] = max(p2_gap.get(f"{name}:{key}", 0.0), rel)
                if not rel <= 1e-5:
                    raise AssertionError(f"dp (f): {name} {key} at k={w['k']}: {r[key]} vs "
                                         f"{w[key]}")
    for method, keys in (("elbow", ("elbow_k",)), ("gap_sts", ("opt_k", "opt_k_argmax"))):
        for key in keys:
            if p2_two["ae_mse"][method][key] != p2_one["ae_mse"][method][key]:
                raise AssertionError(f"dp (f): {method} {key} differs from one process")
    cohort_bytes = {c: {f"rank{r}": dict(zip(("sharded", "replicated"), b))
                        for (cc, r), b in sorted(p1_cohort["bytes"].items()) if cc == c}
                    for c in COHORTS}

    say("dp", batch=B, T=T, train_encounters=n_train, note=repr(
            "two ranks share one card over gloo: a check of correctness, not of scaling"),
        one_rank_bits="identical (p1 and p3, fused and stepped)",
        shard_cohort_false_bits="identical", nccl_1=json.dumps(nccl_1),
        nccl_2_timing=json.dumps(nccl_2_timing),
        cohort_bytes=json.dumps(cohort_bytes),
        relayout_s=json.dumps({"p1": p1_cohort["relayout_s"],
                               "p3": p3_cohort["relayout_s"]}),
        p2_dp2_max_rel_diff=json.dumps(p2_gap), step=json.dumps(step), drift=json.dumps(drift),
        nccl_2=repr(nccl_2), epochs=json.dumps(report), seconds=json.dumps(seconds),
        rank_launches=json.dumps(launches), card=repr(smi))
    return dict(step=step, drift=drift, epochs=report, seconds=seconds,
                cohort_bytes=cohort_bytes, relayout_s=p1_cohort["relayout_s"], nccl_1=nccl_1,
                nccl_2_timing=nccl_2_timing)


def p2_phase(run: dict, smi: str, dev) -> None:
    """Drive `cli.p2.main` at the default Config on the p1 phase's
    `Pretrain` run: the k-means sweeps (elbow, gap), a second call that
    reloads the gap tables with no fit, then the DBSCAN explorer. Times the
    fits, the inertia sweeps and the internal metrics apart."""
    import torch

    from deep_interpolation_clustering_tpu_torch import Config
    from deep_interpolation_clustering_tpu_torch.cli import p2
    from deep_interpolation_clustering_tpu_torch.cluster import kmeans as km
    from deep_interpolation_clustering_tpu_torch.cluster import optk

    cfg0 = Config()
    ks = list(range(2, cfg0.k_max + 1))
    n_train = len(run["cohorts"]["training"]["encounter_id"])
    spent = {}  # seconds of each call, by what was called
    rounds = []  # Lloyd rounds of each fit, each ending in a host read
    saved = (optk.kmeans_fit, optk.inertia_v1, optk.compute_internal_metrics, km._lloyd,
             optk.KSelection.elbow, optk.KSelection.gap_statistic,
             optk.DbscanExplorer.k_distance_graph, optk.DbscanExplorer.eps_sweep)
    fit, inertia, metrics, lloyd, elbow, gap, kdist, sweep = saved

    def timed(key, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent.setdefault(key, []).append(time.perf_counter() - t0)
            return out
        return wrapper

    def checked_fit(generator, x, k, n_init=10, sharded=False):
        if x.device.type != dev.type or generator.device.type != dev.type:
            raise AssertionError(f"p2 k-means on {x.device}, generator on {generator.device}")
        return fit(generator, x, k, n_init=n_init, sharded=sharded)

    def counted_lloyd(*args):
        out = lloyd(*args)
        rounds.append(int(out[3].max()) + 1)
        return out

    optk.kmeans_fit = timed("fit", checked_fit)
    optk.inertia_v1 = timed("inertia", inertia)
    optk.compute_internal_metrics = timed("metrics", metrics)
    km._lloyd = counted_lloyd
    optk.KSelection.elbow = timed("elbow", elbow)
    optk.KSelection.gap_statistic = timed("gap", gap)
    optk.DbscanExplorer.k_distance_graph = timed("k_distance", kdist)
    optk.DbscanExplorer.eps_sweep = timed("eps_sweep", sweep)
    calls, fits = {}, {}
    try:
        for name, extra in (("kmeans", []), ("reload", ["--select_opt_k", '["gap_sts"]']),
                            ("dbscan", ["--cluster_algo", "dbscan"])):
            before = len(spent.get("fit", []))
            calls[name] = timed(name, p2.main)(["--results_path", run["results"], *extra])
            fits[name] = len(spent.get("fit", [])) - before
    finally:
        (optk.kmeans_fit, optk.inertia_v1, optk.compute_internal_metrics, km._lloyd,
         optk.KSelection.elbow, optk.KSelection.gap_statistic,
         optk.DbscanExplorer.k_distance_graph, optk.DbscanExplorer.eps_sweep) = saved
    out, again, dbs = calls["kmeans"], calls["reload"], calls["dbscan"]
    fits_first, fits_again = fits["kmeans"], fits["reload"]

    metrics_ = ("ae_mse", "loss")
    want_fits = len(metrics_) * len(ks) * (1 + cfg0.gap_b + 1)  # elbow, refs, data
    if fits_first != want_fits or fits_again != 0:
        raise AssertionError(f"p2 fits: {fits_first} (expected {want_fits}), "
                             f"{fits_again} on the reload (expected 0)")
    suggest = {}
    for m in metrics_:
        plot = os.path.join(run["results"], "Pretrain", "opt_k", m, "plot")
        for name in ("elbow.csv", "gap_sts_v1.csv", "gap_sts_v1.csv.fp"):
            if not os.path.exists(os.path.join(plot, name)):
                raise AssertionError(f"p2 {m}: no {name}")
        with open(os.path.join(plot, "elbow.csv")) as f:
            elbow_rows = [line.strip().split(",") for line in f][1:]
        if [int(r[0]) for r in elbow_rows] != ks or not all(
                np.isfinite(float(v)) for r in elbow_rows for v in r[1:]):
            raise AssertionError(f"p2 {m} elbow table: {elbow_rows}")
        g = out[m]["gap_sts"]
        rows = optk._read_gap_csv(g["csv"])
        if [r["k"] for r in rows] != ks or not all(
                np.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"p2 {m} gap table: {rows}")
        if g["opt_k_argmax"] not in ks or g["opt_k"] not in (None, *ks[:-1]):
            raise AssertionError(f"p2 {m}: opt_k {g['opt_k']}, argmax {g['opt_k_argmax']}")
        if again[m]["gap_sts"]["rows"] != rows:
            raise AssertionError(f"p2 {m}: the reloaded table differs from the written one")
        kd, eps_rows = dbs[m]["k_distance"], dbs[m]["eps_sweep"]
        kth = kd["kth_distances"]
        if kth.shape != (n_train,) or not np.isfinite(kth).all() or kd["knee_eps"] is None:
            raise AssertionError(f"p2 {m} k-distance: {kth.shape}, knee {kd['knee_eps']}")
        if [r["eps"] for r in eps_rows] != list(np.arange(0.5, 5.0, 0.5)):
            raise AssertionError(f"p2 {m} eps sweep: {[r['eps'] for r in eps_rows]}")
        suggest[m] = dict(opt_k=g["opt_k"], opt_k_argmax=g["opt_k_argmax"],
                          elbow_k=out[m]["elbow"]["elbow_k"],
                          knee_eps=round(kd["knee_eps"], 4),
                          sweep=[(r["eps"], r["n_clusters"], r["n_noise"]) for r in eps_rows])
    seconds = {key: [round(x, 4) for x in spent[key]]
               for key in ("kmeans", "reload", "dbscan", "elbow", "gap", "k_distance",
                           "eps_sweep")}
    say("p2", train_encounters=n_train, latent=2 * H, k_max=cfg0.k_max, n_init=cfg0.n_init,
        gap_b=cfg0.gap_b, fits=fits_first, reload_fits=fits_again, lloyd_rounds=sum(rounds),
        **{f"{key}_s": f"{sum(spent[key]):.4f}" for key in ("fit", "inertia", "metrics")},
        seconds=json.dumps(seconds), suggest=json.dumps(suggest), card=repr(smi))


def _grid_latents(n: int, dev, seed: int):
    """`n` x 256 latents in [-1, 1] on a grid of 1/16 (squared distances
    exact in float32): four blobs of spread 0.15 around centres drawn in
    [-0.5, 0.5], and 2% uniform noise rows. Returns (x, labels), labels the
    blob of each row (a noise row's drawn at random)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    d = 2 * H
    centers = torch.rand((4, d), generator=g, device=dev) - 0.5
    labels = torch.randint(0, 4, (n,), generator=g, device=dev)
    x = centers[labels] + 0.15 * torch.randn((n, d), generator=g, device=dev)
    noise = torch.rand((n,), generator=g, device=dev) < 0.02
    x = torch.where(noise[:, None], torch.rand((n, d), generator=g, device=dev) * 2 - 1, x)
    return torch.round(x.clamp(-1.0, 1.0) * 16) / 16, labels


def _dense_reference(x, labels, k: int, kth: int, eps: float, min_samples: int) -> dict:
    """Silhouette, inertia_v1, Dunn, the kth-neighbour distances and DBSCAN
    labels from the dense float64 distance matrix of `x` (on its device);
    DBSCAN by sklearn's scan: clusters numbered as the scan meets their
    first core point, each expanded through its core points before the
    next, a border joining the first cluster that reaches it."""
    import torch

    x64 = x.double()
    sq = torch.sum(x64 * x64, 1)
    dist = torch.sqrt(torch.clamp_min(sq[:, None] - 2 * x64 @ x64.T + sq[None, :], 0))
    dist.fill_diagonal_(0.0)
    one_hot = torch.nn.functional.one_hot(labels, k).double()
    counts = one_hot.sum(0)
    sums = dist @ one_hot
    own = sums.gather(1, labels[:, None])[:, 0]
    a = own / torch.clamp_min(counts[labels] - 1, 1)
    mean = sums / counts[None, :]
    mean[torch.arange(len(x)), labels] = float("inf")
    b = mean.min(1).values
    s = torch.where(counts[labels] > 1, (b - a) / torch.maximum(a, b), 0.0)
    same = labels[:, None] == labels[None, :]
    ref = {"silhouette": float(s.mean()),
           "inertia_v1": float(torch.mean((one_hot.T @ dist @ one_hot).diagonal() / counts ** 2)),
           "dunn": float(dist[~same].min() / dist[same].max())}
    off = dist.clone()
    off.fill_diagonal_(float("inf"))
    ref["kth"] = torch.kthvalue(off, kth, dim=1).values
    adj = (dist <= eps).cpu().numpy()
    core = adj.sum(1) >= min_samples
    out = np.full(len(x), -1, np.int64)
    cluster = 0
    for i in np.flatnonzero(core):
        if out[i] != -1:
            continue
        out[i] = cluster
        stack = [i]
        while stack:
            j = stack.pop()
            for nb in np.flatnonzero(adj[j] & (out == -1)):
                out[nb] = cluster
                if core[nb]:
                    stack.append(nb)
        cluster += 1
    ref["dbscan"], ref["core"] = out, core
    return ref


def p2_scale_phase(smi: str, dev) -> None:
    """The p2 sweeps at the 100k configuration's training cohort, 70,000
    latents of width 256: each timed at blocks of 1,024 and 4,096 rows and
    held block against block, and on the first 4,000 rows against a dense
    float64 evaluation."""
    import torch

    from deep_interpolation_clustering_tpu_torch.cluster import metrics as cm
    from deep_interpolation_clustering_tpu_torch.cluster.dbscan import dbscan_fit
    from deep_interpolation_clustering_tpu_torch.cluster.kneedle import kneedle

    torch.cuda.reset_peak_memory_stats()
    x, labels = _grid_latents(P2_SCALE_N, dev, seed=11)
    k, kth_k, min_samples = 4, 2 * H - 1, 2 * H + 1

    def run(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, round(time.perf_counter() - t0, 4)

    def knee_eps(kth):
        """eps at the k-distance knee, moved half a grid step of d^2 off the
        data's squared distances (multiples of 1/256), so no pair sits on
        eps's rounding."""
        kth = np.sort(kth.cpu().numpy())
        knee = kth[int(kneedle(np.arange(len(kth)), kth, "convex", "increasing"))]
        return float(np.sqrt((np.round(knee.astype(np.float64) ** 2 * 256) + 0.5) / 256))

    seconds, scores = {}, {}
    for block in (1024, 4096):
        for name, fn in (("silhouette", cm.silhouette_score), ("inertia_v1", cm.inertia_v1),
                         ("dunn", cm.dunn_index)):
            val, seconds[f"{name}_{block}"] = run(lambda: float(fn(x, labels, k, block)))
            scores[name, block] = val
        kth, seconds[f"kth_{block}"] = run(lambda: cm.kth_neighbor_distance(x, kth_k, block))
        if block == 1024:
            eps = knee_eps(kth)
            kth_1024 = kth
        elif not torch.equal(kth, kth_1024):
            raise AssertionError("kth_neighbor_distance differs between blocks 1024 and 4096")
        (lab, core), seconds[f"dbscan_{block}"] = run(
            lambda: dbscan_fit(x, eps, min_samples, block))
        if block == 1024:
            db_1024 = (lab, core)
        elif not (np.array_equal(lab, db_1024[0]) and np.array_equal(core, db_1024[1])):
            raise AssertionError("DBSCAN labels differ between blocks 1024 and 4096")
    block_rel = {name: abs(scores[name, 4096] - scores[name, 1024]) / abs(scores[name, 1024])
                 for name in ("silhouette", "inertia_v1", "dunn")}
    if not all(np.isfinite(v) for v in scores.values()) or max(block_rel.values()) > 1e-5:
        raise AssertionError(f"p2_scale scores {scores}: block 4096 vs 1024 {block_rel}")
    n_clusters = int(db_1024[0].max()) + 1
    if n_clusters < 1 or not (db_1024[0] == -1).any():
        raise AssertionError(f"p2_scale DBSCAN at eps {eps}: {n_clusters} clusters, "
                             f"{int((db_1024[0] == -1).sum())} noise")

    # the first 4,000 rows against a dense float64 evaluation on the card
    xs, ls = x[:P2_DENSE_N], labels[:P2_DENSE_N]
    kth_s = cm.kth_neighbor_distance(xs, kth_k)
    eps_s = knee_eps(kth_s)
    ref = _dense_reference(xs, ls, k, kth_k, eps_s, min_samples)
    got = {"silhouette": float(cm.silhouette_score(xs, ls, k)),
           "inertia_v1": float(cm.inertia_v1(xs, ls, k)), "dunn": float(cm.dunn_index(xs, ls, k))}
    dense_rel = {key: abs(v - ref[key]) / abs(ref[key]) for key, v in got.items()}
    dense_rel["kth"] = float(((kth_s.double() - ref["kth"]).abs() / ref["kth"]).max())
    if max(dense_rel.values()) > 1e-5:
        raise AssertionError(f"p2_scale vs float64 on {P2_DENSE_N} rows: {dense_rel}")
    lab_s, core_s = dbscan_fit(xs, eps_s, min_samples)
    if not (np.array_equal(lab_s, ref["dbscan"]) and np.array_equal(core_s, ref["core"])):
        raise AssertionError(f"p2_scale DBSCAN on {P2_DENSE_N} rows differs from the dense "
                             f"scan at {int((lab_s != ref['dbscan']).sum())} rows")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    say("p2_scale", rows=P2_SCALE_N, width=2 * H, K=k, seconds=json.dumps(seconds),
        scores=json.dumps({name: scores[name, 1024] for name in ("silhouette", "inertia_v1",
                                                                  "dunn")}),
        block_rel=json.dumps({key: f"{v:.3g}" for key, v in block_rel.items()}),
        eps=f"{eps:.6f}", dbscan=json.dumps(dict(
            clusters=n_clusters, noise=int((db_1024[0] == -1).sum()),
            core=int(db_1024[1].sum()))),
        dense_rows=P2_DENSE_N, dense_rel=json.dumps({key: f"{v:.3g}" for key, v in
                                                     dense_rel.items()}),
        dense_dbscan=json.dumps(dict(clusters=int(lab_s.max()) + 1,
                                     noise=int((lab_s == -1).sum()),
                                     border=int((~core_s & (lab_s >= 0)).sum()),
                                     eps=round(eps_s, 6))),
        peak_memory_gb=f"{peak_gb:.2f}", card=repr(smi))


def p3_phase(run: dict, smi: str) -> dict:
    """Drive `cli.p3.main` at the default Config from the p1 phase's run
    (its pickles and `Pretrain` checkpoints): centre init by k-means on the
    card, 3 DEC epochs, checkpoints and nine dumps; returns the kernels'
    launch counts of the phase."""
    import torch

    from deep_interpolation_clustering_tpu_torch.cli import p3
    from deep_interpolation_clustering_tpu_torch.cluster.kmeans import kmeans_predict
    from deep_interpolation_clustering_tpu_torch.compat import jax_from_state_dict
    from deep_interpolation_clustering_tpu_torch.info import COHORTS, METRICS
    from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
    from deep_interpolation_clustering_tpu_torch.train import ClusterTrainer, Trainer
    from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt
    from deep_interpolation_clustering_tpu_torch.train import cluster_trainer as ct

    epoch_s, eval_s, pred_s, restore, fits, trainers = [], {}, [], [], [], []
    saved = (Trainer.train_one_epoch, Trainer.eval, ClusterTrainer.generate_pred_cluster,
             ClusterTrainer.load_pretrain_weight, ClusterTrainer.train, ct.fit_kmeans_impl)
    train_one_epoch, evaluate, predict, load_pretrain, train, fit = saved

    def timed(store, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            store.append(time.perf_counter() - t0)
            return out
        return wrapper

    def timed_eval(self, cohort, *args, **kw):
        t0 = time.perf_counter()
        out = evaluate(self, cohort, *args, **kw)
        torch.cuda.synchronize()
        eval_s.setdefault(cohort, []).append(time.perf_counter() - t0)
        return out

    def checked_restore(self):
        # every leaf of the p1 checkpoint lands bit for bit; the DEC head
        # keeps its init
        head = self.net.cluster_assignment.cluster_centers.detach().clone()
        load_pretrain(self)
        path = os.path.join(self.pretrain_exp_path, "weight", self.cfg.restore_metric,
                            ckpt.CKPT_NAME)
        _, p_params, p_state, _, _ = ckpt.load_checkpoint(path)
        got_p, got_s = jax_from_state_dict(self.net.state_dict())
        want = ckpt._flatten_nested({"params": p_params, "state": p_state})
        got = ckpt._flatten_nested({"params": got_p, "state": got_s})
        differ = [k for k in want if not np.array_equal(got[k], want[k])]
        if differ or set(got) - set(want) != {"params/cluster_centers"}:
            raise AssertionError(f"p3 partial restore: {differ} differ, extra "
                                 f"{sorted(set(got) - set(want))}")
        if not torch.equal(self.net.cluster_assignment.cluster_centers, head):
            raise AssertionError("p3 partial restore moved the DEC head")
        restore.append(len(want))

    def checked_fit(cfg, seed, x, k, n_init):
        t0 = time.perf_counter()
        result = fit(cfg, seed, x, k, n_init)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not (isinstance(x, torch.Tensor) and x.is_cuda and result.centers.is_cuda):
            raise AssertionError("p3 k-means did not run on the card")
        if not torch.equal(result.labels, kmeans_predict(result.centers, x)):
            raise AssertionError("p3 k-means labels differ from kmeans_predict of its centres")
        fits.append(dict(seconds=dt, n_init=n_init, k=k, rows=int(x.shape[0]),
                         n_iter=int(result.n_iter), inertia=float(result.inertia)))
        return result

    def recorded_train(self):
        trainers.append(self)
        return train(self)

    Trainer.train_one_epoch = timed(epoch_s, train_one_epoch)
    Trainer.eval = timed_eval
    ClusterTrainer.generate_pred_cluster = timed(pred_s, predict)
    ClusterTrainer.load_pretrain_weight = checked_restore
    ClusterTrainer.train = recorded_train
    ct.fit_kmeans_impl = checked_fit
    cb.reset_launch_counts()
    try:
        t0 = time.perf_counter()
        # stopping_delta 0: no label delta is below it, so the 3 epochs
        # always run (the stop rules are held by the CPU tests)
        exp = p3.main(run["width"] + ["--max_epochs", "4", "--stopping_delta", "0",
                                      "--pretrain_path", run["exp"]])
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    finally:
        (Trainer.train_one_epoch, Trainer.eval, ClusterTrainer.generate_pred_cluster,
         ClusterTrainer.load_pretrain_weight, ClusterTrainer.train, ct.fit_kmeans_impl) = saved
    launches = {w.name: w.launches for w in cb.KERNELS}

    tr = trainers[0]
    p3_cfg = tr.cfg
    cfg0 = type(p3_cfg)()
    if (p3_cfg.loss, p3_cfg.cluster_number, p3_cfg.kmeans_n_init) != (
            "ae_mse_sup_fake_detect_kl", cfg0.cluster_number, cfg0.kmeans_n_init):
        raise AssertionError(f"p3 config: {p3_cfg.loss}, K {p3_cfg.cluster_number}, "
                             f"n_init {p3_cfg.kmeans_n_init}")
    if len(restore) != 1 or len(fits) != 1 or fits[0]["n_init"] != 20 or fits[0]["k"] != 4:
        raise AssertionError(f"p3 centre init: restores {restore}, k-means fits {fits}")
    if len(epoch_s) != 3 or len(tr.delta_history) != 3:
        raise AssertionError(f"p3 trained {len(epoch_s)} epochs, deltas {tr.delta_history}")
    for m in METRICS:
        if not os.path.exists(os.path.join(exp, "weight", m, ckpt.CKPT_NAME)):
            raise AssertionError(f"p3: no checkpoint for {m}")
    k = p3_cfg.cluster_number
    for m in METRICS:
        for cohort in COHORTS:
            d = np.load(os.path.join(exp, "out_feat", m, f"{cohort}.npy"),
                        allow_pickle=True).item()
            ids = list(run["cohorts"][cohort]["encounter_id"])
            n = len(ids)
            if list(d["encounter_id"]) != ids or len(set(d["encounter_id"])) != n:
                raise AssertionError(f"p3 dump {m}/{cohort}: not every encounter once")
            for key, shape in (("hidden", (n, 2 * H)), ("cluster_pred", (n, k)),
                               ("cluster_label", (n, k))):
                if d[key].shape != shape or not np.isfinite(d[key]).all():
                    raise AssertionError(f"p3 dump {m}/{cohort} {key}: shape "
                                         f"{d[key].shape}, expected {shape}, or not finite")
            row_err = float(np.abs(d["cluster_pred"].sum(1) - 1.0).max())
            if not row_err <= 1e-5:
                raise AssertionError(f"p3 dump {m}/{cohort}: cluster_pred rows sum to 1 "
                                     f"within {row_err}")
    need = ("fake_select", "sci_forward", "sci_backward", "rbf_push", "lstm_forward",
            "lstm_backward", "clip_adam")
    missing = [name for name in need if launches[name] == 0]
    if missing:
        raise AssertionError(f"p3: kernels never launched on the path: {missing}")
    n_train = len(run["cohorts"]["training"]["encounter_id"])
    say("p3", batch=B, T=T, K=k, train_encounters=n_train, restored_leaves=restore[0],
        kmeans=json.dumps({key: (round(v, 4) if isinstance(v, float) and key == "seconds"
                                 else v) for key, v in fits[0].items()}),
        deltas=json.dumps(tr.delta_history),
        epoch_s=json.dumps([round(x, 4) for x in epoch_s]),
        encounters_per_s=json.dumps([round(n_train / x, 1) for x in epoch_s]),
        delta_eval_s=json.dumps([round(x, 4) for x in pred_s]),
        eval_s=json.dumps({c: [round(x, 4) for x in v] for c, v in eval_s.items()}),
        total_s=f"{total_s:.2f}", launches=json.dumps(launches), card=repr(smi))
    return launches, dict(run, exp_p3=exp, k=k)


def p4_phase(run: dict, smi: str, dev) -> None:
    """Drive `cli.p4.main` on the p3 phase's `Clustering` run with the
    kmeans path (on the card), the dl path and the dbscan path (on the card,
    at the least eps, rounded up, at which every cohort of every metric has
    a core point), and check the labels."""
    import torch

    from deep_interpolation_clustering_tpu_torch.cli import p4
    from deep_interpolation_clustering_tpu_torch.cluster.metrics import kth_neighbor_distance
    from deep_interpolation_clustering_tpu_torch.info import COHORTS, METRICS

    k = run["k"]
    dumps = {(m, c): np.load(os.path.join(run["exp_p3"], "out_feat", m, f"{c}.npy"),
                             allow_pickle=True).item() for m in METRICS for c in COHORTS}
    # min_samples is the latent width, self included: a core point has
    # width - 1 other points within eps
    width = dumps[METRICS[0], "training"]["hidden"].shape[1]
    least = max(float(kth_neighbor_distance(torch.as_tensor(d["hidden"], device=dev),
                                            width - 1).min()) for d in dumps.values())
    opt_eps = float(np.ceil(least * 1.001 * 1e4) / 1e4)
    seconds = {}
    out = {}
    for method in ("kmeans", "dl", "dbscan"):
        t0 = time.perf_counter()
        out[method] = p4.main(["--cluster_method", method, "--opt_eps", str(opt_eps),
                               "--results_path", run["results"]])
        torch.cuda.synchronize()
        seconds[method] = time.perf_counter() - t0
    n_dbscan = {}
    for method, results in out.items():
        if sorted(results) != sorted(METRICS):
            raise AssertionError(f"p4 {method}: metrics {sorted(results)}")
        for m, cohorts in results.items():
            n_clusters = len(set(cohorts["training"].tolist()) - {-1})
            hi = n_clusters if method == "dbscan" else k
            lo = -1 if method == "dbscan" else 0
            for cohort in COHORTS:
                labels = cohorts[cohort]
                n = len(run["cohorts"][cohort]["encounter_id"])
                if len(labels) != n or labels.min() < lo or labels.max() >= hi:
                    raise AssertionError(f"p4 {method} {m}/{cohort}: {len(labels)} labels "
                                         f"in [{labels.min()}, {labels.max()}]")
                dump = dumps[m, cohort]
                if method == "dl" and not np.array_equal(labels,
                                                         np.argmax(dump["cluster_pred"], 1)):
                    raise AssertionError(f"p4 dl {m}/{cohort}: not the argmax of cluster_pred")
                if method == "dbscan" and not (labels >= 0).any():
                    raise AssertionError(f"p4 dbscan {m}/{cohort}: no cluster at {opt_eps}")
                if method == "dbscan" and not os.path.exists(os.path.join(
                        run["exp_p3"], "out_feat", f"{m}_dbscan_aligned",
                        f"{cohort}_eps-{opt_eps}.npy")):
                    raise AssertionError(f"p4 dbscan {m}/{cohort}: no labels file")
                if method in ("kmeans", "dbscan") and cohort == "training":
                    # the align contract: clusters in descending masked mean SBP
                    pad = dump["padding_mask"][:, 0]
                    sbp = (dump["ob"][:, 0] * pad).sum(1) / pad.sum(1)
                    means = [float(sbp[labels == i].mean())
                             for i in np.unique(labels[labels >= 0])]
                    if means != sorted(means, reverse=True):
                        raise AssertionError(f"p4 {method} {m}: cluster SBP means {means} "
                                             f"not descending")
            if method == "dbscan":
                n_dbscan[m] = {c: dict(clusters=len(set(v.tolist()) - {-1}),
                                       noise=int((v == -1).sum())) for c, v in cohorts.items()}
    sizes = {method: {m: np.bincount(results[m]["training"], minlength=k).tolist()
                      for m in results} for method, results in out.items() if method != "dbscan"}
    say("p4", K=k, seconds=json.dumps({m: round(x, 4) for m, x in seconds.items()}),
        training_cluster_sizes=json.dumps(sizes), opt_eps=opt_eps,
        dbscan=json.dumps(n_dbscan), card=repr(smi))


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
    from deep_interpolation_clustering_tpu_torch.data.loader import draw_bits, draw_dtype
    from deep_interpolation_clustering_tpu_torch.models import Net
    from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
    from deep_interpolation_clustering_tpu_torch.ops import cuda_interp as ci
    from deep_interpolation_clustering_tpu_torch.ops import cuda_lstm as cl
    from deep_interpolation_clustering_tpu_torch.ops import cuda_select as cs
    from deep_interpolation_clustering_tpu_torch.ops.interpolation import reference_times
    from deep_interpolation_clustering_tpu_torch.train import (
        Trainer, build_inputs, gather_batch, make_optimizer, update,
    )
    from deep_interpolation_clustering_tpu_torch.train.steps import forward_and_losses
    from deep_interpolation_clustering_tpu_torch.utils import resolve_device
    from deep_interpolation_clustering_tpu_torch.utils.cuda_timing import time_ms

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    run_root = tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"))

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

    # B1: bit-identical
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
        # one encounter's 6 rows: the launch and one row's chain
        few_rows_ms=time_ms(lambda: cs.fake_select(bits[:C], n_valid[:C], k_sel[:C])),
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
    if not same_bits(got, ci.sci_fwd(x2, t2, m2, alpha, ref_t)):
        raise AssertionError("sci_forward differs between two runs")
    report["sci_forward"] = dict(
        max_abs_err=err, tolerance="1e-5; two runs bit-identical",
        ms=time_ms(lambda: ci.sci_fwd(x2, t2, m2, alpha, ref_t)),
        # one encounter's 6 rows: the launch and one row's chain of cold
        # loads, three reductions and 36 expf a thread, which no layout hides
        few_rows_ms=time_ms(lambda: ci.sci_fwd(x2[:C], t2[:C], m2[:C], alpha, ref_t)),
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
        # one encounter's 6 rows: the launch and one row's cold loads
        few_rows_ms=time_ms(lambda: ci.rbf_push_k(t2[:C], m2[:C], proj[:C], beta, ref_t)),
        plain_ms=time_ms(lambda: ci._rbf_plain(t2, m2, proj, beta, ref_t)),
        library_ms=None,
        # per observed slot and r: ~7 float32 operations and 1 expf
        bytes=3 * rows * T * f32 + rows * R * f32, flop=7 * R * n_obs, expf=R * n_obs,
    )
    # B2: the packed select at the scaled shape (rows = 4096 x 6, T = 48),
    # bit-identical, with the ragged masks of a T=48 synthetic cohort
    n_scaled = SCALED_TRAIN + 256
    train_share = (SCALED_TRAIN + 0.5) / n_scaled  # int(share * n) = SCALED_TRAIN
    scaled = process_splits(
        make_synthetic_cohorts(n_total=n_scaled, max_obs=SCALED_T, seed=cfg.seed,
                               split=(train_share, 1.0 - train_share, 0.0)),
        rng=np.random.RandomState(1),
    )
    scfg = Config(batch_size=SCALED_B, num_timestamps=SCALED_T)
    sdata = ArrayDataset(scfg, scaled["training"], "training")
    if len(sdata) != SCALED_TRAIN:
        raise AssertionError(f"scaled cohort: {len(sdata)} training encounters")
    rows_s = SCALED_B * C
    m_s = torch.as_tensor(sdata.padding_mask[:SCALED_B], device=dev).reshape(rows_s, SCALED_T)
    nv_s = m_s.sum(1).to(torch.int32)
    k_s = torch.where(nv_s > 0, torch.clamp(nv_s // 2, min=1), torch.zeros_like(nv_s))
    bits_s = draw_bits((rows_s, SCALED_T), gen, dev)
    got = cs.fake_select_packed(bits_s, nv_s, k_s)
    want = cs._select_sort(bits_s, nv_s, k_s)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"fake_select_packed differs from the sort oracle at "
                             f"{int((got != want).sum())} slots")
    if not torch.equal(got.sum(1).to(torch.int32), k_s):
        raise AssertionError("fake_select_packed did not take exactly k per row")
    # B4 at the scaled shape too (a warp a row there, a block a row at T=354)
    sarrays = {k: torch.as_tensor(v, device=dev) for k, v in sdata.arrays().items()}
    sfirst = gather_batch(sarrays, torch.arange(SCALED_B, device=dev))
    x_s = (sfirst["ob"] * sfirst["padding_mask"]).reshape(rows_s, SCALED_T).contiguous()
    t_s = sfirst["timestamp"].reshape(rows_s, SCALED_T).contiguous()
    # a generator of its own: the phases below keep the draws they had
    g_s = torch.randn((SCALED_B, R, 3 * C), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    got = ci.sci_bwd(x_s, t_s, m_s, alpha, ref_t, g_s, True)
    want = ci._sci_bwd_plain(x_s, t_s, m_s, alpha, ref_t, g_s, True)
    obs_s = m_s > 0
    some = obs_s.any(1)  # a row without observations: 0 from the kernel, NaN from the plain version
    for name, a, b_ in zip(("dx", "dt", "dm", "dalpha"), got, want):
        a, b_ = (a[obs_s], b_[obs_s]) if name == "dm" else (a[some], b_[some])
        rel = float((a - b_).abs().max()) / max(float(b_.abs().max()), 1e-30)
        if not rel <= 1e-4:
            raise AssertionError(f"sci_backward (scaled) {name}: {rel:.2e} of max|{name}|")
    report["sci_backward"]["scaled_ms"] = time_ms(
        lambda: ci.sci_bwd(x_s, t_s, m_s, alpha, ref_t, g_s, False))
    # B3 at the scaled shape (a warp a row there too); a row without
    # observations is NaN in both versions and left out
    got = ci.sci_fwd(x_s, t_s, m_s, alpha, ref_t)
    want = ci._sci_fwd_plain(x_s, t_s, m_s, alpha, ref_t)
    seen = some.reshape(SCALED_B, 1, C).repeat(1, R, 3)  # (B, R, 3C) [y | w | yt]
    err_s = float((got - want)[seen].abs().max())
    if not err_s <= 1e-5:
        raise AssertionError(f"sci_forward (scaled) max abs err {err_s} > 1e-5")
    if not same_bits(got, ci.sci_fwd(x_s, t_s, m_s, alpha, ref_t)):
        raise AssertionError("sci_forward (scaled) differs between two runs")
    report["sci_forward"]["max_abs_err"] = max(report["sci_forward"]["max_abs_err"], err_s)
    report["sci_forward"]["scaled_ms"] = time_ms(
        lambda: ci.sci_fwd(x_s, t_s, m_s, alpha, ref_t))
    # B5 at the scaled shape (a warp a row there, a block a row at T=354),
    # with grid values from a generator of its own
    proj_s = torch.randn((rows_s, R), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    got = ci.rbf_push_k(t_s, m_s, proj_s, beta, ref_t)
    err_s = float((got - ci._rbf_plain(t_s, m_s, proj_s, beta, ref_t)).abs().max())
    if not err_s <= 1e-5:
        raise AssertionError(f"rbf_push (scaled) max abs err {err_s} > 1e-5")
    report["rbf_push"]["max_abs_err"] = max(report["rbf_push"]["max_abs_err"], err_s)
    report["rbf_push"]["scaled_ms"] = time_ms(
        lambda: ci.rbf_push_k(t_s, m_s, proj_s, beta, ref_t))
    del sfirst, got, want, proj_s

    # both selects on 16-bit keys (rng_draw_bits=16: the low 16 bits 0, so
    # ties in the random part are common), from a generator of their own
    gen16 = torch.Generator(device=dev).manual_seed(16)
    for name, fn, args16 in (
            ("fake_select", cs.fake_select,
             (draw_bits((rows, T), gen16, dev, 16), n_valid, k_sel)),
            ("fake_select_packed", cs.fake_select_packed,
             (draw_bits((rows_s, SCALED_T), gen16, dev, 16), nv_s, k_s))):
        got, want = fn(*args16), cs._select_sort(*args16)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} on 16-bit keys differs from the sort oracle at "
                                 f"{int((got != want).sum())} slots")
        report.setdefault(name, {})["bits16"] = dict(
            T=args16[0].shape[1], rows=args16[0].shape[0], identical=True,
            ms=time_ms(lambda: fn(*args16)))
    report["fake_select_packed"].update(
        max_abs_err=0.0, tolerance="bit-identical", shape=[rows_s, SCALED_T],
        ms=time_ms(lambda: cs.fake_select_packed(bits_s, nv_s, k_s)),
        plain_ms=time_ms(lambda: cs._select_sort(bits_s, nv_s, k_s)),
        library_ms=time_ms(lambda: torch.sort(bits_s, dim=-1)),
        # one block's 8 rows: the launch and one row's chain
        few_rows_ms=time_ms(lambda: cs.fake_select_packed(bits_s[:8], nv_s[:8], k_s[:8])),
        bytes=rows_s * SCALED_T * (4 + 1) + rows_s * 8, flop=0, expf=0,
    )
    del got, want, args16
    # both selects over the row lengths they are routed at, bit-identical to
    # the sort oracle (and the packed one to the other select on its rows);
    # draws from a generator of its own
    sel_gen = torch.Generator(device=dev).manual_seed(2)
    for name, lengths in (("fake_select_packed", PACKED_T), ("fake_select", SELECT_T)):
        by_t = {}
        for t_sel in lengths:
            rows_t = C * -(-2**20 // (C * t_sel))
            nv_t = torch.randint(0, t_sel + 1, (rows_t,), generator=sel_gen, device=dev,
                                 dtype=torch.int32)
            k_t = torch.where(nv_t > 0, torch.clamp(nv_t // 2, min=1), torch.zeros_like(nv_t))
            bits_t = draw_bits((rows_t, t_sel), sel_gen, dev)
            fn = getattr(cs, name)
            got = fn(bits_t, nv_t, k_t)
            wants = [("the sort oracle", cs._select_sort(bits_t, nv_t, k_t))]
            if name == "fake_select_packed":
                wants.append(("fake_select", cs.fake_select(bits_t, nv_t, k_t)))
            for other, want in wants:
                if not torch.equal(got, want):
                    raise AssertionError(f"{name} at T={t_sel} differs from {other} at "
                                         f"{int((got != want).sum())} slots")
            by_t[t_sel] = dict(
                rows=rows_t, layout=list(cs.select_layout(t_sel)),
                ms=time_ms(lambda: fn(bits_t, nv_t, k_t)),
                library_ms=time_ms(lambda: torch.sort(bits_t, dim=-1)),
                bound_ms=bound(rows_t * t_sel * (4 + 1) + rows_t * 8, 0, 0)[0])
            say("select", kernel=name, T=t_sel, rows=rows_t, ms=f"{by_t[t_sel]['ms']:.4f}",
                library_ms=f"{by_t[t_sel]['library_ms']:.4f}",
                bound_ms=f"{by_t[t_sel]['bound_ms']:.4f}")
        report[name]["by_t"] = by_t
    del got, want, wants, bits_t, nv_t, k_t

    # B6/B7 at the encoder's shape (real+fake batched, B = 2 x 256, no
    # state), the decoder's (B = 256, seeded with h0/c0) and the encoder's
    # with p3's triplet stream on (real+fake+positive, B = 3 x 256)
    def lstm_inputs(b, feat, with_state):
        bnd = 1.0 / np.sqrt(H)
        uni = lambda *shape: (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bnd
        w = dict(w_ih=uni(2, 4 * H, feat), b_ih=uni(2, 4 * H), w_hh=uni(2, 4 * H, H),
                 b_hh=uni(2, 4 * H), x=torch.randn((R, b, feat), generator=gen, device=dev))
        xg = [torch.matmul(w["x"], w["w_ih"][d].T) + w["b_ih"][d] for d in range(2)]
        state = [torch.randn((2, b, H), generator=gen, device=dev) * 0.5 if with_state
                 else torch.zeros((2, b, H), device=dev) for _ in range(2)]
        w_hhT = w["w_hh"].transpose(1, 2).contiguous()
        return [xg[0], xg[1], w_hhT, w["b_hh"], state[0], state[1]], w

    def cudnn_lstm(w, feat):
        """cuDNN's bidirectional LSTM with the same weights (the port never
        calls it): it also does the input projection."""
        lib = torch.nn.LSTM(feat, H, bidirectional=True).to(dev)
        with torch.no_grad():
            for d, sfx in enumerate(("", "_reverse")):
                for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                    torch_name = {"w": "weight", "b": "bias"}[name[0]] + name[1:]
                    getattr(lib, f"{torch_name}_l0{sfx}").copy_(w[name][d])
        return lib

    lstm_checks = {}
    for tag, b_l, feat, with_state in (("encoder", 2 * B, 3 * C, False),
                                       ("decoder", B, 2 * H, True),
                                       ("encoder_triplet", 3 * B, 3 * C, False)):
        ins, w = lstm_inputs(b_l, feat, with_state)
        outs = cl.lstm_forward(*ins)
        want = cl.recurrence_plain(*ins)
        err_f = max(float((a - b_).abs().max()) for a, b_ in zip(outs, want))
        if not err_f <= 1e-5:
            raise AssertionError(f"lstm_forward ({tag}) max abs err {err_f} > 1e-5")
        for name, a, a2 in zip(("ysf", "ysb", "csf", "csb"), outs, cl.lstm_forward(*ins)):
            if not torch.equal(a, a2):
                raise AssertionError(f"lstm_forward ({tag}) {name} differs between two runs")
        cots = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
        w_hh = ins[2].transpose(1, 2).contiguous()
        bwd_args = (*ins[:3], w_hh, *ins[3:], *outs, *cots)
        got_g = cl.lstm_backward(*bwd_args)
        again = cl.lstm_backward(*bwd_args)
        want_g = cl._recurrence_bwd_plain(*bwd_args)
        errs, rels = [], []
        for name, a, b_, a2 in zip(("dxgf", "dxgb", "dw_hhT", "db_hh", "dh0", "dc0"),
                                   got_g, want_g, again):
            if not torch.equal(a, a2):
                raise AssertionError(f"lstm_backward ({tag}) {name} differs between two runs")
            e = float((a - b_).abs().max())
            rel = e / max(float(b_.abs().max()), 1e-30)
            errs.append(e)
            rels.append(rel)
            if not rel <= 1e-4:
                raise AssertionError(f"lstm_backward ({tag}) {name}: err {e} is {rel:.2e} "
                                     f"of max|{name}|")
        lstm_checks[tag] = (ins, bwd_args, w, feat, err_f, max(errs), max(rels))
        say("lstm_check", shape=tag, B=b_l, forward_err=f"{err_f:.3g}",
            backward_err=f"{max(errs):.3g}", backward_rel=f"{max(rels):.3g}",
            repeat="bit-identical")

    ins, bwd_args, w, feat, err_f, err_b, rel_b = lstm_checks["encoder"]
    lib = cudnn_lstm(w, feat)
    x_lib = w["x"].clone().requires_grad_()
    lib_cots = [torch.randn(s_, generator=gen, device=dev)
                for s_ in ((R, 2 * B, 2 * H), (2, 2 * B, H), (2, 2 * B, H))]

    def lib_fwd_bwd():
        out, (hn, cn) = lib(x_lib)
        torch.autograd.backward([out, hn, cn], lib_cots)

    with torch.no_grad():
        lib_fwd_ms = time_ms(lambda: lib(w["x"]))
    lib_train_fwd_ms = time_ms(lambda: lib(x_lib))
    lib_fwd_bwd_ms = time_ms(lib_fwd_bwd)
    dec_ins, dec_bwd = lstm_checks["decoder"][:2]
    trip_ins, trip_bwd = lstm_checks["encoder_triplet"][:2]
    n_bytes, n_flop, n_expf = lstm_work(R, 2 * B, H, backward=False)
    report["lstm_forward"] = dict(
        max_abs_err=max(err_f, lstm_checks["decoder"][4]),
        tolerance="1e-5; two runs bit-identical", shape=[R, 2 * B, H],
        ms=time_ms(lambda: cl.lstm_forward(*ins)),
        plain_ms=time_ms(lambda: cl.recurrence_plain(*ins)),
        library_ms=lib_fwd_ms, library="cuDNN nn.LSTM forward incl. input projection",
        decoder_ms=time_ms(lambda: cl.lstm_forward(*dec_ins)),
        triplet_ms=time_ms(lambda: cl.lstm_forward(*trip_ins)),
        bytes=n_bytes, flop=n_flop, expf=n_expf,
    )
    n_bytes, n_flop, n_expf = lstm_work(R, 2 * B, H, backward=True)
    report["lstm_backward"] = dict(
        max_abs_err=max(err_b, lstm_checks["decoder"][5]),
        tolerance="1e-4 x max|grad| per output; two runs bit-identical",
        max_rel_err=max(rel_b, lstm_checks["decoder"][6]), shape=[R, 2 * B, H],
        ms=time_ms(lambda: cl.lstm_backward(*bwd_args)),
        plain_ms=time_ms(lambda: cl._recurrence_bwd_plain(*bwd_args)),
        library_ms=lib_fwd_bwd_ms - lib_train_fwd_ms,
        library="cuDNN nn.LSTM forward+backward less its training forward",
        decoder_ms=time_ms(lambda: cl.lstm_backward(*dec_bwd)),
        triplet_ms=time_ms(lambda: cl.lstm_backward(*trip_bwd)),
        bytes=n_bytes, flop=n_flop, expf=n_expf,
    )
    del lib, x_lib, lstm_checks
    report.update(optim_kernels(cfg, dev))
    report.update(mtan_kernels(dev))

    for name, r in report.items():
        r["bound_ms"], r["bound_by"] = bound(r.pop("bytes"), r.pop("flop"), r.pop("expf"))
        say("kernels", name=name, max_abs_err=f"{r['max_abs_err']:.3g}",
            ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}", bound_by=r["bound_by"],
            library_ms=None if r["library_ms"] is None else f"{r['library_ms']:.4f}",
            **{k: f"{r[k]:.4f}" for k in ("decoder_ms", "triplet_ms", "scaled_ms",
                                           "few_rows_ms", "pair_ms", "plain_tail_ms")
               if k in r})

    # ------------------------------------------------------------ 4. main path
    trainer = Trainer(cfg, {"training": datasets["training"],
                            "validation": datasets["validation"]},
                      os.path.join(run_root.name, "main"), device=dev)
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
            "sci_backward": 2 * STEPS, "rbf_push": STEPS,
            "lstm_forward": 2 * STEPS, "lstm_backward": 2 * STEPS, "clip_adam": STEPS}
    short = {k: (launches[k], n) for k, n in need.items() if launches[k] < n}
    if short:
        raise AssertionError(f"kernel launches below the path's count: {short}")
    steps_per_s = (STEPS - 2) / dt
    say("main", steps=STEPS, batch=B, T=T, loss=f"{float(losses[-1]['loss']):.5f}",
        steps_per_s=f"{steps_per_s:.2f}", encounters_per_s=f"{steps_per_s * B:.1f}",
        latent=tuple(latent.shape), launches=json.dumps(launches), card=repr(smi))

    # the bare step with the options off by default, beside the default, in
    # turns (a record, not a change of default): each a fresh trainer, 2
    # warm-up steps, then OPTION_STEPS timed
    def bare_step_ms(cfg_x):
        tr = Trainer(cfg_x, {"training": datasets["training"]},
                     os.path.join(run_root.name, "options"), device=dev)
        tr.train_steps(2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_steps(OPTION_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / OPTION_STEPS * 1e3
        tr.close()
        return round(ms, 3)

    option_ms = {}
    for _ in range(2):
        for name, cfg_x in (("default", cfg), ("fused_heads", cfg.replace(fused_heads=True)),
                            ("rng_draw_bits_16", cfg.replace(rng_draw_bits=16))):
            option_ms.setdefault(name, []).append(bare_step_ms(cfg_x))
    say("main", options="bare step ms, in turns", steps=OPTION_STEPS,
        step_ms=json.dumps(option_ms), card=repr(smi))

    # ------------------------------------------------------ 5. scaled path
    strainer = Trainer(scfg, {"training": sdata}, os.path.join(run_root.name, "scaled"),
                       device=dev)
    sbefore = {n: p.detach().clone() for n, p in strainer.net.named_parameters()}
    n_batches = len(strainer._epoch_batches(strainer.epoch))
    if n_batches != 4:
        raise AssertionError(f"scaled epoch: {n_batches} batches, expected 3 + the tail")
    warm = strainer.train_one_epoch()  # warm-up: allocator, cuBLAS at B=4096
    strainer.epoch += 1  # the second epoch's shuffle (the rate is the same)
    torch.cuda.synchronize()
    cb.reset_launch_counts()
    t0 = time.perf_counter()
    epoch_losses = strainer.train_one_epoch()
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    slaunches = {w.name: w.launches for w in cb.KERNELS}
    for k, v in {**warm, **epoch_losses}.items():
        if not np.isfinite(v):
            raise AssertionError(f"scaled loss {k} is not finite: {v}")
    unchanged = [n for n, p in strainer.net.named_parameters() if torch.equal(p, sbefore[n])]
    if unchanged:
        raise AssertionError(f"scaled: parameters unchanged after two epochs: {unchanged}")
    if slaunches["fake_select_packed"] != n_batches or slaunches["fake_select"] != 0:
        raise AssertionError(f"scaled select launches: {slaunches}")
    sneed = {"fake_select_packed": n_batches, "sci_forward": 2 * n_batches,
             "sci_backward": 2 * n_batches, "rbf_push": n_batches,
             "lstm_forward": 2 * n_batches, "lstm_backward": 2 * n_batches,
             "clip_adam": n_batches}
    short = {k: (slaunches[k], n) for k, n in sneed.items() if slaunches[k] < n}
    if short:
        raise AssertionError(f"scaled kernel launches below the path's count: {short}")
    strainer.close()
    say("scaled", batch=SCALED_B, T=SCALED_T, encounters=SCALED_TRAIN, steps=n_batches,
        loss=f"{epoch_losses['loss']:.5f}", epoch_s=f"{dt_s:.4f}",
        encounters_per_s=f"{SCALED_TRAIN / dt_s:.1f}", launches=json.dumps(slaunches),
        card=repr(smi))
    del strainer

    # ------------------------------------------------- 6. main path vs plain
    def kernel_vs_plain_step(cfg0, batch, draws, clustering=False):
        net_k = Net(cfg0, generator=torch.Generator().manual_seed(1),
                    clustering=clustering).to(dev)
        net_p = copy.deepcopy(net_k)
        out = {}
        for use_kernels, net in ((True, net_k), (False, net_p)):
            inputs = build_inputs(cfg0, batch, None, True, False, draws, use_kernels)
            out[use_kernels] = update(net, make_optimizer(cfg0, net.parameters()), cfg0,
                                      inputs, None, use_kernels)
        for k in out[True]:
            a, b_ = float(out[True][k]), float(out[False][k])
            if not abs(a - b_) <= 1e-5 * max(1.0, abs(b_)):
                raise AssertionError(f"loss {k}: kernels {a} vs plain {b_}")
        return (*params_agree(net_k, net_p, cfg0.init_lr), float(out[True]["loss"]))

    def step_draws(b, t_len, triplet=False, width=32):
        draws = {
            "fake_bits": draw_bits((b, C, t_len), gen, dev, width),
            "fake_noise": torch.rand((b, C, t_len), generator=gen, device=dev,
                                     dtype=draw_dtype(width)),
            "perm": torch.randperm(2 * b, generator=gen, device=dev),
        }
        if triplet:
            draws["pos_noise"] = torch.randn((2, b, C, t_len), generator=gen, device=dev)
        return draws

    worst, n_viol, n_tot, loss = kernel_vs_plain_step(cfg.replace(dropout=0.0), batch,
                                                      step_draws(B, T))
    # the masked tail step at the scaled configuration: the 368 real rows
    # repeated to B=4096, sample_mask 1 on them
    n_tail = SCALED_TRAIN % SCALED_B
    tail = np.resize(np.arange(SCALED_TRAIN - n_tail, SCALED_TRAIN), SCALED_B)
    sbatch = gather_batch(sarrays, torch.as_tensor(tail, device=dev))
    sbatch["sample_mask"] = (torch.arange(SCALED_B, device=dev) < n_tail).float()
    t_worst, t_viol, t_tot, t_loss = kernel_vs_plain_step(
        scfg.replace(dropout=0.0), sbatch, step_draws(SCALED_B, SCALED_T))
    # the p3 step: the DEC head and the KL term (the default p3 loss), and
    # with the triplet stream on, which runs the encoder's B6/B7 at 3 x B rows
    dec_cfg = cfg.replace(dropout=0.0, loss="ae_mse_sup_fake_detect_kl")
    d_worst, d_viol, d_tot, d_loss = kernel_vs_plain_step(dec_cfg, batch, step_draws(B, T),
                                                          clustering=True)
    trip_cfg = dec_cfg.replace(loss="ae_mse_sup_fake_detect_kl_triplet", triple_margin=1.0)
    # record the rows (xg's batch) of each B6/B7 launch of the triplet step
    lstm_wrappers = [w for w in cb.KERNELS if w.name.startswith("lstm")]
    originals = {w.name: w._launch for w in lstm_wrappers}
    rows_seen = {w.name: [] for w in lstm_wrappers}

    def recording(name):
        def launch(*args):
            rows_seen[name].append(args[0].shape[1])
            return originals[name](*args)
        return launch

    for w in lstm_wrappers:
        w._launch = recording(w.name)
    try:
        r_worst, r_viol, r_tot, r_loss = kernel_vs_plain_step(
            trip_cfg, batch, step_draws(B, T, triplet=True), clustering=True)
    finally:
        for w in lstm_wrappers:
            w._launch = originals[w.name]
    if any(sorted(rows) != [B, 3 * B] for rows in rows_seen.values()):
        raise AssertionError(f"the triplet step's B6/B7 rows: {rows_seen}, expected the "
                             f"encoder's {3 * B} and the decoder's {B}")
    # the options off by default: a kernel step against a plain step with
    # fused heads and with 16-bit draws; the fused kernel step's forward
    # against the unfused one's from the same weights and draws
    fused_cfg = cfg.replace(dropout=0.0, fused_heads=True)
    f_worst, f_viol, f_tot, f_loss = kernel_vs_plain_step(fused_cfg, batch, step_draws(B, T))
    w_worst, w_viol, w_tot, w_loss = kernel_vs_plain_step(
        cfg.replace(dropout=0.0, rng_draw_bits=16), batch, step_draws(B, T, width=16))
    unfused_cfg = fused_cfg.replace(fused_heads=False)
    net_f = Net(fused_cfg, generator=torch.Generator().manual_seed(1)).to(dev)
    net_u = Net(unfused_cfg).to(dev)
    net_u.load_state_dict(net_f.state_dict())
    draws = step_draws(B, T)
    outs = {}
    for cfg_x, net in ((fused_cfg, net_f), (unfused_cfg, net_u)):
        inputs = build_inputs(cfg_x, batch, None, True, False, draws, True)
        with torch.no_grad():
            outs[cfg_x.fused_heads] = forward_and_losses(net, cfg_x, inputs, True, None,
                                                         True)[0]
    fu_err = {"rec": float((outs[True].rec - outs[False].rec).abs().max())}
    for k in outs[False].aux:
        fu_err[k] = float((outs[True].aux[k] - outs[False].aux[k]).abs().max())
    buf_u = dict(net_u.named_buffers())
    fu_err["bn_running"] = max(float((v - buf_u[n]).abs().max())
                               for n, v in net_f.named_buffers() if "running" in n)
    if not max(fu_err.values()) <= 1e-5:
        raise AssertionError(f"fused heads vs unfused (kernel step forward): {fu_err}")
    del net_f, net_u, outs
    say("plain", max_param_diff=f"{worst:.3g}", beyond_1e5=f"{n_viol}/{n_tot}",
        loss=f"{loss:.6f}", tail_max_param_diff=f"{t_worst:.3g}",
        tail_beyond_1e5=f"{t_viol}/{t_tot}", tail_loss=f"{t_loss:.6f}",
        dec_max_param_diff=f"{d_worst:.3g}", dec_beyond_1e5=f"{d_viol}/{d_tot}",
        dec_loss=f"{d_loss:.6f}", triplet_max_param_diff=f"{r_worst:.3g}",
        triplet_beyond_1e5=f"{r_viol}/{r_tot}", triplet_loss=f"{r_loss:.6f}",
        fused_max_param_diff=f"{f_worst:.3g}", fused_beyond_1e5=f"{f_viol}/{f_tot}",
        fused_loss=f"{f_loss:.6f}", fused_vs_unfused=f"{max(fu_err.values()):.3g}",
        draw16_max_param_diff=f"{w_worst:.3g}", draw16_beyond_1e5=f"{w_viol}/{w_tot}",
        draw16_loss=f"{w_loss:.6f}")
    trainer.close()
    del trainer, sbatch, sarrays

    # -------------------------------------------- 7. p0 entry point, at scale
    p1_root = os.path.join(run_root.name, "p1")
    cohorts_p1 = p0_phase(p1_root, smi)
    p0_scale_phase(smi)

    # ------------------------------------------------- 8, 9. p1 entry point, converter
    p1_launches, run = p1_phase(p1_root, cohorts_p1, smi)
    mtan_launches = mtan_p1_phase(run, smi)
    fused = fused_phase(run, sdata, smi, dev)
    bf16 = bf16_phase(run, sdata, smi)
    dp_phase(run, smi)
    convert_phase(run, smi)

    # ----------------------------------------------- 10, 11. p2 entry point, at scale
    p2_phase(run, smi, dev)
    p2_scale_phase(smi, dev)

    # ----------------------------------------------- 12, 13. p3 and p4 entry points
    p3_launches, run = p3_phase(run, smi)
    p4_phase(run, smi, dev)
    run_root.cleanup()

    kernels = []
    for w in cb.KERNELS:
        r = report[w.name]
        # each kernel's count from the path that runs it: the scaled path
        # for the packed select (T <= 192), mTAN's p1 for M1, the p1 entry
        # point for the others
        path_launches = (slaunches if w.name == "fake_select_packed" else
                         mtan_launches if w.name.startswith("mtan_") else p1_launches)
        kernels.append({
            "name": w.name, "route": "cuda", "source": w.source, "replaces": w.replaces,
            "launches": path_launches[w.name], "launches_p1": p1_launches[w.name],
            "launches_p3": p3_launches[w.name],
            "launches_main": launches[w.name], "launches_scaled": slaunches[w.name],
            # one bf16 step's (B2's at the scaled configuration) and the bf16
            # p1 entry point's
            "launches_bf16_step": bf16["steps"][
                "scaled" if w.name == "fake_select_packed" else "default"]["launches"].get(
                    w.name, 0),
            "launches_bf16_p1": bf16["p1"]["launches"][w.name],
            # one epoch replayed from the captured steps (phase `fused`: the
            # default Config's, the scaled one's for the packed select)
            "launches_fused_epoch": fused["bits"][
                "scaled" if w.name == "fake_select_packed" else "default"][
                    "launches_epoch"].get(w.name, 0),
            "max_abs_err": r["max_abs_err"],
            "tolerance": r["tolerance"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("by_t", "bits16", "few_rows_ms", "decoder_ms", "triplet_ms",
                                 "scaled_ms", "shape", "library", "pair_ms", "plain_tail_ms")
               if k in r},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
