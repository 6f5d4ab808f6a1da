"""Checkpoint converter: the reference's `model.pth.tar` <-> the `.npz` that
both packages' trainers write (counterpart of the JAX `cli/convert.py`).

    python -m deep_interpolation_clustering_tpu_torch.cli.convert to_torch --src A --dst B
    python -m deep_interpolation_clustering_tpu_torch.cli.convert to_jax --src A --dst B

  * `to_jax`: a torch checkpoint the reference saved (utils.py:141-145,
    `{'epoch', 'state_dict', 'optimizer'}`) becomes a weights-only
    `checkpoint.npz` that `--restore` loads (the optimizer starts fresh);
    the optimizer's learning rate rides along in the meta.
  * `to_torch`: a `checkpoint.npz` becomes a `model.pth.tar` the reference
    restores end to end: strict `load_state_dict` (BatchNorm's
    `num_batches_tracked` included, 0) and `optimizer.load_state_dict` on
    a fresh Adam, SGD or RMSprop state.

`--src`/`--dst` may be single files or weight root directories (`.../weight`
with one `<metric>/` subdirectory per tracked metric); directory mode
converts every metric's checkpoint. Host work on the CPU, as in the JAX
package: a thin layer over `compat.jax_params` and `train.checkpoint`.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import torch

from ..compat import jax_from_state_dict, state_dict_from_jax
from ..train import checkpoint as ckpt
from ..utils.logging import logger

TORCH_NAME = "model.pth.tar"
_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _load_torch_file(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # older torch saves (or other pickled content) predate the
        # weights_only loader; these files are the user's own checkpoints
        return torch.load(path, map_location="cpu", weights_only=False)


def to_jax(src: str, dst: str) -> str:
    """`model.pth.tar` -> weights-only `checkpoint.npz`, with the torch
    optimizer's rate in the meta (`lr`) so that a later `to_torch`, or the
    trainer's restore, resumes at the saved rate."""
    blob = _load_torch_file(src)
    sd = blob["state_dict"] if isinstance(blob, dict) and "state_dict" in blob else blob
    epoch = int(blob.get("epoch", 0)) if isinstance(blob, dict) else 0
    extra: Dict = {"imported_from": os.path.abspath(src)}
    try:
        extra["lr"] = float(blob["optimizer"]["param_groups"][0]["lr"])
    except (TypeError, KeyError, IndexError):
        pass  # a weights-only blob: no rate to carry
    params, state = jax_from_state_dict(sd)
    ckpt.save_checkpoint(dst, epoch, params, state, opt_leaves=None, extra=extra)
    logger.info("to_jax: %s (epoch %d) -> %s", src, epoch, dst)
    return dst


def _fresh_torch_opt_state(n_params: int, meta: Dict, optimizer: str,
                           weight_decay: float) -> Dict:
    """A state_dict a freshly built reference optimizer loads: no
    per-parameter state, one group with every parameter, and the
    hyperparameters of that optimizer class (torch's `load_state_dict`
    installs them over the group's, so they carry that class's keys). The
    rate comes from the checkpoint's meta when present, the weight decay
    from the caller; the rest are the torch defaults the reference's
    factory keeps (utils.py:77-83)."""
    lr = float(meta.get("lr", 3e-3))
    common = {"maximize": False, "foreach": None, "differentiable": False,
              "weight_decay": weight_decay}
    if optimizer == "adam":
        hyper = {"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8,
                 "amsgrad": True, "capturable": False, "fused": None, **common}
    elif optimizer == "sgd":
        hyper = {"lr": lr, "momentum": 0.9, "dampening": 0,
                 "nesterov": True, "fused": None, **common}
    elif optimizer == "rmsprop":
        hyper = {"lr": lr, "momentum": 0.9, "alpha": 0.99, "eps": 1e-8,
                 "centered": False, "capturable": False, **common}
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return {"state": {}, "param_groups": [{**hyper, "params": list(range(n_params))}]}


def to_torch(src: str, dst: str, optimizer: str = "adam",
             weight_decay: float = 4e-4) -> str:
    """`checkpoint.npz` -> `model.pth.tar` (restorable by the reference)."""
    epoch, params, state, _, meta = ckpt.load_checkpoint(src)
    sd = state_dict_from_jax(params, state)
    n_params = sum(1 for k in sd if not k.endswith(_BN_BUFFERS))
    blob = {
        "epoch": int(epoch),
        "state_dict": sd,
        "optimizer": _fresh_torch_opt_state(n_params, meta, optimizer, weight_decay),
    }
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    torch.save(blob, dst)
    logger.info("to_torch: %s (epoch %d) -> %s", src, epoch, dst)
    return dst


def _convert_tree(direction: str, src: str, dst: str, optimizer: str,
                  weight_decay: float) -> int:
    """Weight-root directory mode: convert every `<metric>/` checkpoint."""
    n = 0
    for metric in sorted(os.listdir(src)):
        if direction == "to_jax":
            f = os.path.join(src, metric, TORCH_NAME)
            if os.path.isfile(f):
                to_jax(f, os.path.join(dst, metric, ckpt.CKPT_NAME))
                n += 1
        else:
            f = os.path.join(src, metric, ckpt.CKPT_NAME)
            if os.path.isfile(f):
                to_torch(f, os.path.join(dst, metric, TORCH_NAME), optimizer, weight_decay)
                n += 1
    return n


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("direction", choices=["to_jax", "to_torch"])
    parser.add_argument("--src", required=True,
                        help="checkpoint file or weight root directory")
    parser.add_argument("--dst", required=True,
                        help="output file or weight root directory")
    parser.add_argument("--optimizer", default="adam", choices=["adam", "sgd", "rmsprop"],
                        help="to_torch: the optimizer class the reference run will "
                             "restore into (the keys of the written optimizer state)")
    parser.add_argument("--weight_decay", type=float, default=4e-4,
                        help="to_torch: weight decay written into the optimizer state; "
                             "torch's load_state_dict installs it over the resuming "
                             "run's own flag, so pass the value that run will use")
    args = parser.parse_args(argv)
    if os.path.isdir(args.src):
        n = _convert_tree(args.direction, args.src, args.dst, args.optimizer,
                          args.weight_decay)
        if n == 0:
            parser.error(f"no checkpoints found under {args.src}/*/")
    elif args.direction == "to_jax":
        to_jax(args.src, args.dst)
    else:
        to_torch(args.src, args.dst, args.optimizer, args.weight_decay)


if __name__ == "__main__":
    main()
