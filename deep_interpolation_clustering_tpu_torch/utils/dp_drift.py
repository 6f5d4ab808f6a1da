"""How far data-parallel training drifts from one process, step by step.

    python -m deep_interpolation_clustering_tpu_torch.utils.dp_drift [--n_total 3000] [--dropout 0.2] [--epochs 2]

At the default `Config` width (B=256, T=354, H=128) on a synthetic cohort
of `--n_total` encounters at T=354 (70% training), three `Trainer` runs
take the same steps over `--epochs` shuffled epochs, without eval or
schedule: one process; one process whose initial weights are nudged by
2^-24 of themselves (random signs, seed 0), the size of a float32
summation-order difference; and two ranks sharing the card over gloo. For
each of the last two it prints, per step, the largest loss difference from
the first run, the largest parameter difference and the number of
parameter elements beyond 1e-4; then the largest latent and `rec_ob`
differences of a validation pass, and the parameter tensors that drift
most. If two ranks drift no further than the nudged process, the drift is
the trajectory's amplification of float32 noise, not a fault of the
data-parallel path. Needs one CUDA card; prints the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from .. import Config, parallel
from ..cli.common import build_parser, config_from_args, make_datasets, save_processed
from ..data import make_synthetic_cohorts, process_splits
from ..train import Trainer
from .device import resolve_device

NUDGE = 2.0 ** -24


def _flat(net) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()]).cpu().numpy()


def run(argv, exp: str, device, epochs: int, nudge: bool = False) -> dict:
    """The steps of `epochs` epochs from the seed's weights (nudged with
    `nudge`): each step's losses and parameters, then a validation pass's
    latents and reconstructions."""
    cfg = config_from_args(build_parser("dp_drift").parse_args(argv))
    tr = Trainer(cfg, make_datasets(cfg), exp, device=device)
    if nudge:
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in tr.net.parameters():
                sign = torch.randint(0, 2, p.shape, generator=g).to(p.device, p.dtype) * 2 - 1
                p.add_(p * sign * NUDGE)
    losses, params = [], []
    for epoch in range(1, epochs + 1):
        for idx, mask in tr._epoch_batches(epoch):
            losses.append({k: float(v) for k, v in tr.step(idx, mask).items()})
            params.append(_flat(tr.net))
    _, dumps = tr.eval_one_epoch("valid", tr.datasets["validation"], False,
                                 ("hidden", "rec_ob"))
    out = dict(losses=losses, params=np.stack(params), hidden=dumps["hidden"][0],
               rec=dumps["rec_ob"][0], names=[(n, p.numel()) for n, p in tr.net.named_parameters()])
    tr.close()
    return out


def _rank(r: int, address: str, argv, exp: str, epochs: int):
    dev = parallel.initialize(address, 2, r, "cuda", "gloo")
    try:
        out = run(argv, exp, dev, epochs)
        return out if r == 0 else None
    finally:
        parallel.shutdown()


def _report(name: str, other: dict, one: dict) -> dict:
    dl = [max(abs(x[k] - y[k]) for k in y) for x, y in zip(other["losses"], one["losses"])]
    dp = np.abs(other["params"] - one["params"])
    tensors, off = [], 0
    for n, k in one["names"]:
        seg = dp[-1, off:off + k]
        tensors.append((float(seg.max()), int((seg > 1e-4).sum()), n))
        off += k
    return {
        "run": name,
        "loss_diff_per_step": [float(f"{v:.3g}") for v in dl],
        "param_max_per_step": [float(f"{v:.3g}") for v in dp.max(1)],
        "params_beyond_1e4_per_step": [int(v) for v in (dp > 1e-4).sum(1)],
        "hidden_max": float(np.abs(other["hidden"] - one["hidden"]).max()),
        "rec_ob_max": float(np.abs(other["rec"] - one["rec"]).max()),
        "params": int(dp.shape[1]),
        "worst_tensors": sorted(tensors, reverse=True)[:4],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_total", type=int, default=3000)
    ap.add_argument("--dropout", type=float, default=Config().dropout)
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args()
    resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    root_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build")
    os.makedirs(root_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root_dir) as root:
        base = os.path.join(root, "Data")
        cfg = Config()
        cohorts = process_splits(make_synthetic_cohorts(n_total=args.n_total,
                                                        max_obs=cfg.num_timestamps, seed=cfg.seed),
                                 rng=np.random.RandomState(cfg.seed))
        save_processed(Config(base_path=base), cohorts)
        argv = ["--base_path", base, "--results_path", os.path.join(root, "Results"),
                "--dropout", str(args.dropout)]
        one = run(argv, os.path.join(root, "one"), "cuda", args.epochs)
        nudged = run(argv, os.path.join(root, "nudged"), "cuda", args.epochs, nudge=True)
        two = parallel.spawn(_rank, 2, (f"127.0.0.1:{parallel.free_port()}", argv,
                                        os.path.join(root, "two"), args.epochs))[0]
    for name, other in (("two_ranks", two), ("nudged", nudged)):
        print(json.dumps(dict(_report(name, other, one), dropout=args.dropout,
                              n_total=args.n_total, epochs=args.epochs)), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
