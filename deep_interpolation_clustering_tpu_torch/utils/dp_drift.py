"""How far data-parallel training drifts from one process, step by step.

    python -m deep_interpolation_clustering_tpu_torch.utils.dp_drift [--n_total 3000] [--dropout 0.2] [--epochs 2]

At the default `Config` width (B=256, T=354, H=128) on a synthetic cohort
of `--n_total` encounters at T=354 (70% training), `Trainer` runs take the
same steps over `--epochs` shuffled epochs, stepped, without eval or
schedule: one process with the port's optimizer ("one"); that process with
its initial weights nudged by 2^-24 of themselves (random signs, seeds 0, 1
and 2), the size of a float32 summation-order difference, once; with every
gradient element nudged so at every step (fresh signs each step), which is
where two ranks' gradient sums differ from one process's; with torch's
default Adam (a float rate, the step count on the host: the port's Adam
rounded another way) and with the capturable Adam on its own float32 step
counts (bias corrections in float32: every step 6.4e-6 longer) in place of
the port's, each also nudged (seeds 0 and 1) against itself; and two ranks
sharing the card over gloo.
For each it prints, per step, the largest loss difference from its
reference, the largest parameter difference and the number of parameter
elements beyond 1e-4; then the largest latent and `rec_ob` differences of a
validation pass, and the parameter tensors that drift most. If two ranks
drift no further than the nudged processes, the drift is the trajectory's
amplification of float32 noise, not a fault of the data-parallel path.
Needs one CUDA card; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np
import torch

from .. import Config, parallel
from ..cli.common import build_parser, config_from_args, make_datasets, save_processed
from ..data import make_synthetic_cohorts, process_splits
from ..train import Trainer, clip_grad_global_norm_, steps
from .device import resolve_device

NUDGE = 2.0 ** -24

# (name, run's options, the run it is held against)
RUNS = [("one", {}, None)]
RUNS += [(f"nudged_s{i}", dict(nudge=i), "one") for i in range(3)]
RUNS += [("grad_nudged", dict(grad_nudge=True), "one")]
for _adam_kind in ("default", "capturable_f32"):
    RUNS += [(f"{_adam_kind}_adam", dict(adam=_adam_kind), "one")]
    RUNS += [(f"{_adam_kind}_adam_nudged_s{i}", dict(adam=_adam_kind, nudge=i),
              f"{_adam_kind}_adam") for i in range(2)]


def _flat(net) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()]).cpu().numpy()


def _adam(kind: str, cfg: Config, params) -> torch.optim.Optimizer:
    """torch's default Adam ("default") or the capturable one on its own
    float32 step counts ("capturable_f32", a tensor rate) with the port's
    hyperparameters."""
    params = list(params)
    kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay_rate, amsgrad=True)
    if kind == "default":
        return torch.optim.Adam(params, lr=cfg.init_lr, **kw)
    lr = torch.tensor(cfg.init_lr, dtype=torch.float32, device=params[0].device)
    return torch.optim.Adam(params, lr=lr, capturable=True, **kw)


def _own_tail(opt: torch.optim.Optimizer, max_norm) -> None:
    """In place of `steps.update`'s kernel pair, which takes only the port's
    Adam: the clip, then the Adam's own step."""
    if max_norm:
        clip_grad_global_norm_(opt.param_groups[0]["params"], max_norm)
    opt.step()


def _nudge_grads(net, seed: int) -> None:
    """Every gradient element, at every backward, times 1 +- 2^-24 (signs
    drawn afresh each time from a generator of its own)."""
    gens = {}

    def hook(g):
        gen = gens.setdefault(g.device, torch.Generator(g.device).manual_seed(seed))
        sign = torch.randint(0, 2, g.shape, generator=gen, device=g.device).to(g.dtype) * 2 - 1
        return g + g * sign * NUDGE

    for p in net.parameters():
        p.register_hook(hook)


def run(argv, exp: str, device, epochs: int, nudge: Optional[int] = None,
        grad_nudge: bool = False, adam: Optional[str] = None) -> dict:
    """The steps of `epochs` epochs from the seed's weights (nudged with
    the seed `nudge`; the gradients nudged at every step with `grad_nudge`;
    with `adam`, that Adam in place of the port's): each step's losses and
    parameters, then a validation pass's latents and reconstructions."""
    cfg = config_from_args(build_parser("dp_drift").parse_args(argv))
    tr = Trainer(cfg, make_datasets(cfg), exp, device=device)
    if adam:
        tr.opt = _adam(adam, cfg, tr.net.parameters())
        kernel_tail, steps.clip_adam_step_ = steps.clip_adam_step_, _own_tail
    if nudge is not None:
        g = torch.Generator().manual_seed(nudge)
        with torch.no_grad():
            for p in tr.net.parameters():
                sign = torch.randint(0, 2, p.shape, generator=g).to(p.device, p.dtype) * 2 - 1
                p.add_(p * sign * NUDGE)
    if grad_nudge:
        _nudge_grads(tr.net, 0)
    losses, params = [], []
    try:
        for epoch in range(1, epochs + 1):
            for idx, mask in tr._epoch_batches(epoch):
                losses.append({k: float(v) for k, v in tr.step(idx, mask).items()})
                params.append(_flat(tr.net))
    finally:
        if adam:
            steps.clip_adam_step_ = kernel_tail
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
        runs = {name: run(argv, os.path.join(root, name), "cuda", args.epochs, **kw)
                for name, kw, _ in RUNS}
        runs["two_ranks"] = parallel.spawn(_rank, 2, (
            f"127.0.0.1:{parallel.free_port()}", argv, os.path.join(root, "two"),
            args.epochs))[0]
    for name, _, ref in RUNS[1:] + [("two_ranks", {}, "one")]:
        print(json.dumps(dict(_report(name, runs[name], runs[ref]), against=ref,
                              dropout=args.dropout, n_total=args.n_total,
                              epochs=args.epochs)), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
