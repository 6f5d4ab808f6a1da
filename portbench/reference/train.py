"""The reference's training steps and eval pass: the batches rebuilt from the
raw cohort, the random draws taken again from the seed in the program's
documented order, autograd, the global-norm clip and amsgrad Adam with L2
weight decay folded into the gradient (pretrain_trainer.py, utils.py:77-99).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import model as M
from .model import initial_buffers  # noqa: F401  (the jobs take it from here)


def prepare(raw: Dict[str, np.ndarray], rows: np.ndarray, cfg: dict,
            device) -> Dict[str, torch.Tensor]:
    """A batch of the raw p0 cohort as the model reads it: the values scaled
    `x -> s*x - s/2`, the future-vital targets with their NaN mask."""
    def take(k):
        return torch.as_tensor(np.ascontiguousarray(raw[k][rows]), device=device)

    ob = take("feat").to(torch.float32)
    s = cfg["scale"]
    if s != 0:
        ob = s * ob - s / 2
    fv = take("future_vital").to(torch.float32)
    return {"ob": ob, "mask": take("padding_mask").to(torch.float32),
            "ts": take("time_step").to(torch.float32),
            "fv_mask": (~torch.isnan(fv)).to(torch.float32),
            "fv": torch.nan_to_num(fv, nan=0.0)}


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The epoch's shuffle of the training rows (the reference's sampler,
    seeded by the run's seed and the epoch)."""
    order = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(order)
    return order


def step_inputs(cfg: dict, batch: Dict[str, torch.Tensor], gen: torch.Generator,
                triplet: bool):
    """The streams, labels and the permutation of one train step, drawn from
    `gen` in the order the step takes them: the select's bits, the fake
    noise, the real/fake permutation, the triplet positive's jitter."""
    ob_raw, mask, ts = batch["ob"], batch["mask"], batch["ts"]
    shape, dev = ob_raw.shape, ob_raw.device
    bits = torch.randint(-(2**31), 2**31, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(torch.int32)
    noise = torch.rand(shape, generator=gen, device=dev)
    perm = torch.randperm(2 * shape[0], generator=gen, device=dev)
    ob = ob_raw * mask
    streams = [(ob, mask, ts), (M.fake_ob(ob_raw, mask, bits, noise, cfg["scale"]) * mask,
                                mask, ts)]
    if triplet:
        jitter = torch.randn((2,) + tuple(shape), generator=gen, device=dev)
        streams.append(((ob + jitter[0] * cfg["triple_pos_std"]) * mask, mask,
                        (ts + jitter[1] * 0.01) * mask))
    b = shape[0]
    label = torch.cat([torch.ones(b, dtype=torch.long, device=dev),
                       torch.zeros(b, dtype=torch.long, device=dev)])[perm]
    return streams, perm, label, ob


class AmsgradAdam:
    """torch's Adam(amsgrad=True) with L2 weight decay folded into the
    gradient, its bias corrections in double precision."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, wd, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.vmax = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], at: Dict[str, torch.Tensor]):
        """One update of the parameters `at` -> (the update, the gradients
        as the moments took them)."""
        b1, b2 = self.betas
        self.t += 1
        bc1 = 1.0 - b1 ** self.t
        bc2_sqrt = (1.0 - b2 ** self.t) ** 0.5
        update, taken = {}, {}
        for k, p in at.items():
            g = grads[k] + self.wd * p
            taken[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1.0 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            torch.maximum(self.vmax[k], self.v[k], out=self.vmax[k])
            denom = self.vmax[k].sqrt() / bc2_sqrt + self.eps
            update[k] = self.m[k] / denom * (-self.lr / bc1)
        return update, taken


def clip_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> float:
    """Scale every gradient by max_norm / norm when the global norm reaches
    max_norm (optax's clip_by_global_norm: no epsilon); returns the norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    if float(norm) >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)
    return float(norm)


def step_generator(cfg: dict, device: torch.device,
                   program_state: Optional[torch.Tensor] = None) -> torch.Generator:
    """The steps' generator, seeded by the run's seed + 1. Where the program
    drew before its first step (p3's centre init, whose draws the reference
    cannot make), the generator is moved on to the program's offset: a CUDA
    generator's state is its seed and its Philox offset, 8 bytes each, and
    only the offset is taken, so that draws from another seed still show.
    A CPU generator (a rehearsal) has no offset apart from its state, which
    is taken whole."""
    gen = torch.Generator(device=device).manual_seed(cfg["seed"] + 1)
    if program_state is not None:
        if device.type == "cuda":
            state = gen.get_state().clone()
            state[8:16] = program_state.cpu()[8:16]
            gen.set_state(state)
        else:
            gen.set_state(program_state)
    return gen


def train_steps(cfg: dict, weights: Dict[str, torch.Tensor], raw: Dict[str, np.ndarray],
                n_steps: int, precision: str = "float32",
                device: Optional[torch.device] = None,
                generator_state: Optional[torch.Tensor] = None,
                states: Optional[List[Dict[str, torch.Tensor]]] = None) -> dict:
    """The first `n_steps` train steps of the run from `weights`, on the
    reference's own trajectory: each step's losses, the first step's
    gradients as the optimizer takes them (`grad`) and before the weight
    decay is folded in (`raw_grad`), and the parameters after the last
    step. The draws start from the seed (`step_generator`, which takes the
    program's offset from `generator_state`).

    `states` (the program's parameters before each step) is for a
    diagnostic only: each step's losses and gradients are then taken at the
    program's point, the updates from the reference's own moments, so that
    a rounding-level sign that Adam's first step turns into a whole step of
    the rate (PERF.md, PR 17) moves one element and not both trajectories."""
    device = device or next(iter(weights.values())).device
    num = M.Numerics(precision)
    params = {k: v.detach().clone().to(device) for k, v in weights.items()}
    opt = AmsgradAdam(params, cfg["init_lr"], cfg["weight_decay_rate"])
    gen = step_generator(cfg, torch.device(device), generator_state)
    order = epoch_order(len(raw["feat"]), cfg["seed"], 1)
    bsz, triplet = cfg["batch_size"], cfg.get("triple_margin", 0.0) != 0.0
    out: dict = {"losses": []}
    with num.active():
        for i in range(n_steps):
            batch = prepare(raw, order[i * bsz:(i + 1) * bsz], cfg, device)
            streams, perm, label, ob = step_inputs(cfg, batch, gen, triplet)
            at = params if states is None else {k: v.detach().clone().to(device)
                                                for k, v in states[i].items()}
            leaves = {k: p.requires_grad_(True) for k, p in at.items()}
            net = M.forward(leaves, {}, cfg, streams, num, True, perm, gen)
            ls = M.losses(cfg, net, ob, batch["mask"], batch["fv"], batch["fv_mask"], label)
            grads = dict(zip(leaves, torch.autograd.grad(ls["loss"], list(leaves.values()),
                                                         allow_unused=True)))
            for k, p in at.items():
                p.requires_grad_(False)
                if grads[k] is None:
                    grads[k] = torch.zeros_like(p)
            out.setdefault("norms", []).append(clip_global_norm(grads, cfg["grad_clip"]))
            clipped = {k: g.clone() for k, g in grads.items()} if i == 0 else None
            update, taken = opt.step(grads, at)
            with torch.no_grad():
                for k, u in update.items():
                    params[k].add_(u)
            out["losses"].append({k: float(v.detach()) for k, v in ls.items()})
            if i == 0:
                out["grad"] = {k: v.clone() for k, v in taken.items()}
                out["raw_grad"] = clipped
    out["params"] = params
    return out


@torch.no_grad()
def eval_losses(cfg: dict, params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                raw: Dict[str, np.ndarray], precision: str = "float32",
                device: Optional[torch.device] = None) -> Dict[str, float]:
    """The eval pass's per-batch losses of the real stream (ae_mse and the
    future-vital term), in batches of the batch size in cohort order, their
    mean over batches."""
    device = device or next(iter(params.values())).device
    num = M.Numerics(precision)
    n, bsz = len(raw["feat"]), cfg["batch_size"]
    sums: Dict[str, List[float]] = {"ae_mse": [], "future_vital": []}
    with num.active():
        for start in range(0, n, bsz):
            batch = prepare(raw, np.arange(start, min(start + bsz, n)), cfg, device)
            ob = batch["ob"] * batch["mask"]
            net = M.forward(params, buffers, cfg, [(ob, batch["mask"], batch["ts"])], num,
                            False)
            sums["ae_mse"].append(float(M._masked_mse(net["rec"], ob, batch["mask"])))
            sums["future_vital"].append(float(M._masked_mse(net["future_vital"], batch["fv"],
                                                            batch["fv_mask"])))
    return {k: float(np.mean(v, dtype=np.float64)) for k, v in sums.items()}


@torch.no_grad()
def latents(cfg: dict, params: Dict[str, torch.Tensor], raw: Dict[str, np.ndarray],
            precision: str = "float32", device: Optional[torch.device] = None) -> torch.Tensor:
    """The (N, 2H) latents of the cohort's real stream, in cohort order."""
    device = device or next(iter(params.values())).device
    num = M.Numerics(precision)
    n, bsz = len(raw["feat"]), cfg["batch_size"]
    out = []
    with num.active():
        for start in range(0, n, bsz):
            batch = prepare(raw, np.arange(start, min(start + bsz, n)), cfg, device)
            planes = (batch["ob"] * batch["mask"], batch["mask"], batch["ts"])
            out.append(M.encode(params, cfg, [planes], num)[3])
    return torch.cat(out)


@torch.no_grad()
def labels(cfg: dict, params: Dict[str, torch.Tensor], raw: Dict[str, np.ndarray],
           precision: str = "float32", device: Optional[torch.device] = None) -> torch.Tensor:
    """Each encounter's cluster: the argmax of its soft assignment to the
    centres in `params`."""
    z = latents(cfg, params, raw, precision, device)
    q = M.soft_assignment(params["cluster_assignment.cluster_centers"], z, cfg["dec_alpha"])
    return torch.argmax(q, dim=1)
