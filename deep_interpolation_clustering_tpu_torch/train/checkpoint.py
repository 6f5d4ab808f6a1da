"""Checkpoints: per-metric best-model files, flags, early stop, partial
restore (counterpart of the JAX `train/checkpoint.py`, reference
utils.py:126-199).

The file is the JAX package's npz, so each package restores the other's:
  * `params/...` and `state/...`: the JAX parameter and state pytrees
    (`compat.jax_from_state_dict` of the port's `state_dict`) under their
    slash-joined paths;
  * `opt/00000`, `opt/00001`, ...: the JAX optimizer state's leaves in
    order (`compat.optimizer_to_jax`);
  * `__meta__`: JSON with `epoch` and what the caller adds (the trainer:
    `lr`, `metric`, `lr_schedule`, `flag_dict`, `model`).
`layout(cfg.model)` says how a network's weights take that form: the IPN's
as the JAX package's pytrees (`compat`), which both packages restore;
mTAN's, which the JAX package does not have, as its parameter names split
at the dots into nested dicts, with no state. Everything else here works
on NumPy arrays and nested dicts of them.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compat.jax_params import JAX_LAYOUT, Layout
from ..utils import tracing
from ..utils.logging import logger

CKPT_NAME = "checkpoint.npz"


def _flatten_nested(d: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_nested(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten_nested(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _by_name(sd: Dict[str, object]) -> Tuple[Dict, Dict]:
    """A state dict as (params, no state): nested dicts of float32 host
    arrays, the names split at the dots; a tensor is one host read."""
    params: Dict = {}
    for name, v in sd.items():
        *path, leaf = name.split(".")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        if isinstance(v, torch.Tensor):
            tracing.count("host_reads")
            v = v.detach().cpu().numpy()
        node[leaf] = np.array(v, np.float32, copy=True)
    return params, {}


def _from_names(params: Dict, state: Optional[Dict] = None,
                prefix: str = "") -> Dict[str, torch.Tensor]:
    """Inverse of `_by_name`."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_from_names(v, None, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.from_numpy(np.array(v, np.float32, copy=True))
    return out


def layout(model: str) -> Layout:
    """(to_tree, from_tree) for `Config.model`'s weights: a state dict to
    the (params, state) that `save_checkpoint` takes, and back."""
    return JAX_LAYOUT if model == "ipn" else (_by_name, _from_names)


def save_checkpoint(path: str, epoch: int, params: Dict, state: Dict,
                    opt_leaves: Optional[List[np.ndarray]] = None,
                    extra: Optional[Dict] = None) -> str:
    """Write one checkpoint file (atomically, through a rename); counted
    as `checkpoint.writes` and its arrays' bytes as `checkpoint.bytes`
    (`utils.tracing`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    arrays.update({f"params/{k}": v for k, v in _flatten_nested(params).items()})
    arrays.update({f"state/{k}": v for k, v in _flatten_nested(state).items()})
    for i, leaf in enumerate(opt_leaves or ()):
        arrays[f"opt/{i:05d}"] = np.asarray(leaf)
    meta = {"epoch": int(epoch)}
    meta.update(extra or {})
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    if tracing.enabled():
        tracing.count("checkpoint.writes")
        tracing.count("checkpoint.bytes", sum(a.nbytes for a in arrays.values()))
    return path


def load_meta(path: str) -> Dict:
    """Only the JSON meta of a checkpoint (npz entries load lazily)."""
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def _shapes(leaves: Sequence[np.ndarray]) -> str:
    return "[" + ", ".join(str(np.shape(x)) for x in leaves[:4]) + (
        ", ..." if len(leaves) > 4 else "") + "]"


def load_checkpoint(path: str, opt_template: Optional[List[np.ndarray]] = None
                    ) -> Tuple[int, Dict, Dict, Optional[List[np.ndarray]], Dict]:
    """Returns (epoch, params, state, opt_leaves, meta). `opt_leaves` is
    None unless `opt_template` (the live optimizer's leaves) is given and
    the file holds as many leaves; they come back in the template's dtypes
    and shapes. A weights-only file, or one of another layout, restores the
    weights and leaves the optimizer to start fresh."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode())
    params = _unflatten_nested({k[len("params/"):]: v for k, v in arrays.items()
                                if k.startswith("params/")})
    state = _unflatten_nested({k[len("state/"):]: v for k, v in arrays.items()
                               if k.startswith("state/")})
    opt_leaves = None
    if opt_template is not None:
        leaves = [arrays[k] for k in sorted(k for k in arrays if k.startswith("opt/"))]
        if not leaves:
            logger.info("checkpoint carries no optimizer state (weights-only): "
                        "optimizer starts fresh")
        elif len(leaves) != len(opt_template):
            logger.warning(
                "optimizer state layout mismatch — checkpoint %d leaves %s vs template %d "
                "leaves %s (%s): restoring params only, optimizer state restarts fresh",
                len(leaves), _shapes(leaves), len(opt_template), _shapes(opt_template),
                "looks like the pre-flat-vector legacy layout"
                if len(leaves) > len(opt_template)
                else "FEWER leaves than the template — possibly a truncated or corrupted "
                     "checkpoint",
            )
        else:
            opt_leaves = [np.asarray(x, dtype=np.asarray(t).dtype).reshape(np.shape(t))
                          for x, t in zip(leaves, opt_template)]
    return meta["epoch"], params, state, opt_leaves, meta


def partial_restore(target: Dict, source: Dict) -> Tuple[Dict, List[str]]:
    """Merge `source` leaves into `target` wherever paths and shapes match;
    returns (merged, loaded paths). Unmatched target leaves keep their
    values (the reference's filtered strict=False load,
    clustering_trainer.py:437-444)."""
    tgt_flat = _flatten_nested(target)
    loaded = []
    for k, v in _flatten_nested(source).items():
        if k in tgt_flat and tgt_flat[k].shape == v.shape:
            tgt_flat[k] = v.astype(tgt_flat[k].dtype)
            loaded.append(k)
    return _unflatten_nested(tgt_flat), loaded


class FlagDict:
    """Best metric values and their epochs (utils.py:126-138, 162-172). Every
    monitored metric is minimised."""

    def __init__(self, metrics: Sequence[str]):
        self.best = {m: float("inf") for m in metrics}
        self.best_epoch = {m: 0 for m in metrics}

    def improved(self, metric_dict: Dict[str, float], epoch: int) -> List[str]:
        """Record each monitored metric in `metric_dict` that is <= its best
        (as the reference); returns their names."""
        out = []
        for m in self.best:
            if m in metric_dict and metric_dict[m] <= self.best[m]:
                self.best[m] = float(metric_dict[m])
                self.best_epoch[m] = epoch
                out.append(m)
        return out

    def early_stop(self, epoch: int, patience: int) -> bool:
        latest = max(self.best_epoch.values()) if self.best_epoch else 0
        if epoch - latest + 1 > patience:
            logger.info("=== early stop at epoch %d (best %s) ===", epoch, self.best)
            return True
        return False

    def to_dict(self) -> Dict[str, float]:
        d: Dict[str, float] = {}
        for m in self.best:
            d[m] = self.best[m]
            d[m + "_epoch"] = self.best_epoch[m]
        return d

    def state_dict(self) -> Dict:
        """For a checkpoint's meta: a metric that never improved (still
        inf) is written as null, which strict JSON readers accept."""
        return {
            "best": {m: (None if v == float("inf") else v) for m, v in self.best.items()},
            "best_epoch": dict(self.best_epoch),
        }

    def merge_state(self, d: Dict) -> None:
        """Min-merge a saved snapshot into the live flags: merged over every
        metric's checkpoint, each metric gets its true best whichever
        checkpoint the weights came from."""
        best_epoch = d.get("best_epoch", {})
        for m, v in d.get("best", {}).items():
            if v is None:
                continue
            if m in self.best and float(v) <= self.best[m]:
                self.best[m] = float(v)
                self.best_epoch[m] = int(best_epoch.get(m, self.best_epoch[m]))


def weight_dirs(root: str, metrics: Sequence[str], create: bool = True) -> Dict[str, str]:
    """`weight/{metric}/` best-checkpoint directories (utils.py:195-199),
    made unless `create` is False (a rank that writes nothing)."""
    out = {}
    for m in metrics:
        d = os.path.join(root, m)
        if create:
            os.makedirs(d, exist_ok=True)
        out[m] = d
    return out
