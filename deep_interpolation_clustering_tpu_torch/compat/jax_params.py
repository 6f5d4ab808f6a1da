"""Weights carried across from the JAX package (the port's own copy of the
name map in the JAX `compat/torch_import.py`).

`state_dict_from_jax(params, state)` turns the JAX parameter and state
pytrees (nested dicts of arrays) into the port's `Net.state_dict()`, whose
keys are the reference torch model's names (the DEC centres, JAX
`params["cluster_centers"]`, are `cluster_assignment.cluster_centers`);
`jax_from_state_dict` is the inverse. Works on NumPy-convertible values, so JAX itself is not needed.

`optimizer_to_jax` and `optimizer_from_jax` carry a torch optimizer's state
to and from the flat leaves of the JAX optimizer state
(`train/optim.make_optimizer` there: `inject_hyperparams` around a chain on
one raveled parameter vector), in the order `tree_leaves` gives them:

    adam     count, learning_rate, inner count, mu, nu, nu_max
    sgd      count, learning_rate, trace
    rmsprop  count, learning_rate, nu, trace

The counts are int32 scalars, the rate a float32 scalar, and each vector
holds every parameter in the order `ravel_pytree` gives the JAX params:
dict keys sorted at every level (the centres between `cci` and `decoder`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

_HEADS = ("predict_future", "aux_head", "fake_det_head")
_CENTERS = "cluster_assignment.cluster_centers"


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32, copy=True))


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy().astype(np.float32, copy=True)


def state_dict_from_jax(params: Dict, state: Dict) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {
        "sci.kernel": _t(params["sci"]["kernel"]),
        "cci.kernel": _t(params["cci"]["kernel"]),
        "rbf.kernel": _t(params["rbf"]["kernel"]),
    }
    for name in ("encoder", "decoder"):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            d = params[name][direction]
            sd[f"{name}.lstm.weight_ih_l0{suffix}"] = _t(d["w_ih"])
            sd[f"{name}.lstm.weight_hh_l0{suffix}"] = _t(d["w_hh"])
            sd[f"{name}.lstm.bias_ih_l0{suffix}"] = _t(d["b_ih"])
            sd[f"{name}.lstm.bias_hh_l0{suffix}"] = _t(d["b_hh"])

    def head(prefix: str, p: Dict, s: Dict, fc2_idx: int):
        sd[f"{prefix}.0.weight"] = _t(p["fc1"]["w"])
        sd[f"{prefix}.0.bias"] = _t(p["fc1"]["b"])
        sd[f"{prefix}.1.weight"] = _t(p["bn"]["gamma"])
        sd[f"{prefix}.1.bias"] = _t(p["bn"]["beta"])
        sd[f"{prefix}.1.running_mean"] = _t(s["bn"]["mean"])
        sd[f"{prefix}.1.running_var"] = _t(s["bn"]["var"])
        sd[f"{prefix}.1.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        sd[f"{prefix}.{fc2_idx}.weight"] = _t(p["fc2"]["w"])
        sd[f"{prefix}.{fc2_idx}.bias"] = _t(p["fc2"]["b"])

    head("rbf.compress_fc.module.model", params["rbf"]["compress"],
         state["rbf"]["compress"], 4)
    for name in _HEADS:
        if name in params:
            head(f"{name}.model", params[name], state[name], 3)
    if "cluster_centers" in params:
        sd[_CENTERS] = _t(params["cluster_centers"])
    return sd


def jax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """Inverse of `state_dict_from_jax`: (params, state) as NumPy pytrees."""
    params: Dict = {
        "sci": {"kernel": _np(sd["sci.kernel"])},
        "cci": {"kernel": _np(sd["cci.kernel"])},
    }
    for name in ("encoder", "decoder"):
        params[name] = {
            direction: {
                "w_ih": _np(sd[f"{name}.lstm.weight_ih_l0{suffix}"]),
                "w_hh": _np(sd[f"{name}.lstm.weight_hh_l0{suffix}"]),
                "b_ih": _np(sd[f"{name}.lstm.bias_ih_l0{suffix}"]),
                "b_hh": _np(sd[f"{name}.lstm.bias_hh_l0{suffix}"]),
            }
            for direction, suffix in (("fwd", ""), ("bwd", "_reverse"))
        }

    def head(prefix: str, fc2_idx: int):
        p = {
            "fc1": {"w": _np(sd[f"{prefix}.0.weight"]), "b": _np(sd[f"{prefix}.0.bias"])},
            "bn": {"gamma": _np(sd[f"{prefix}.1.weight"]),
                   "beta": _np(sd[f"{prefix}.1.bias"])},
            "fc2": {"w": _np(sd[f"{prefix}.{fc2_idx}.weight"]),
                    "b": _np(sd[f"{prefix}.{fc2_idx}.bias"])},
        }
        s = {"bn": {"mean": _np(sd[f"{prefix}.1.running_mean"]),
                    "var": _np(sd[f"{prefix}.1.running_var"])}}
        return p, s

    compress_p, compress_s = head("rbf.compress_fc.module.model", 4)
    params["rbf"] = {"kernel": _np(sd["rbf.kernel"]), "compress": compress_p}
    state: Dict = {"rbf": {"compress": compress_s}}
    for name in _HEADS:
        if f"{name}.model.0.weight" in sd:
            params[name], state[name] = head(f"{name}.model", 3)
    if _CENTERS in sd:
        params["cluster_centers"] = _np(sd[_CENTERS])
    return params, state


# torch's per-parameter state behind each JAX vector leaf, by optimizer
OPT_VECTORS = {
    "Adam": ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"),  # mu, nu, nu_max
    "SGD": ("momentum_buffer",),  # trace
    "RMSprop": ("square_avg", "momentum_buffer"),  # nu, trace
}


def _sorted_leaves(tree: Dict) -> List[np.ndarray]:
    return [leaf for k in sorted(tree) for leaf in (
        _sorted_leaves(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _fill_sorted(tree: Dict, vec: np.ndarray, at: List[int]) -> Dict:
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out[k] = _fill_sorted(tree[k], vec, at)
        else:
            n = tree[k].size
            out[k] = vec[at[0]: at[0] + n].reshape(tree[k].shape)
            at[0] += n
    return out


def _vector(net: torch.nn.Module, per_param: Dict[str, torch.Tensor]) -> np.ndarray:
    """Per-parameter tensors (by name) as one vector in the JAX ravel order."""
    sd = dict(net.state_dict())
    sd.update(per_param)
    params, _ = jax_from_state_dict(sd)
    return np.concatenate([leaf.ravel() for leaf in _sorted_leaves(params)])


def _per_param(net: torch.nn.Module, vec: np.ndarray) -> Dict[str, torch.Tensor]:
    """Inverse of `_vector`."""
    params, state = jax_from_state_dict(net.state_dict())
    at = [0]
    filled = _fill_sorted(params, np.asarray(vec, np.float32), at)
    if at[0] != vec.size:
        raise ValueError(f"optimizer vector of {vec.size} values for {at[0]} parameters")
    sd = state_dict_from_jax(filled, state)
    return {name: sd[name] for name, _ in net.named_parameters()}


def optimizer_to_jax(opt: torch.optim.Optimizer, net: torch.nn.Module,
                     count: int) -> List[np.ndarray]:
    """The JAX optimizer state's leaves for `opt`, built over
    `net.parameters()`; `count` is the number of updates taken. A parameter
    without state yet (no step taken) gives zeros."""
    kind = type(opt).__name__
    named = list(net.named_parameters())
    leaves = [np.asarray(count, np.int32),
              np.asarray(opt.param_groups[0]["lr"], np.float32)]
    if kind == "Adam":
        steps = [float(opt.state[p]["step"]) for _, p in named if "step" in opt.state[p]]
        leaves.append(np.asarray(int(max(steps, default=0)), np.int32))
    for key in OPT_VECTORS[kind]:
        leaves.append(_vector(net, {
            n: (opt.state[p][key].detach().cpu() if key in opt.state[p]
                else torch.zeros_like(p, device="cpu")) for n, p in named}))
    return leaves


def optimizer_from_jax(opt: torch.optim.Optimizer, net: torch.nn.Module,
                       leaves: List[np.ndarray]) -> int:
    """Load the JAX optimizer state's leaves into `opt` (built over
    `net.parameters()`): the moments and the step count, not the rate (the
    trainer writes its schedule's). Returns the update count."""
    kind = type(opt).__name__
    vectors = OPT_VECTORS[kind]
    head = 3 if kind == "Adam" else 2
    if len(leaves) != head + len(vectors):
        raise ValueError(f"{kind}: {len(leaves)} optimizer leaves, expected "
                         f"{head + len(vectors)}")
    count = int(leaves[0])
    step = float(leaves[2]) if kind == "Adam" else float(count)
    moments = [_per_param(net, vec) for vec in leaves[head:]]
    for name, p in net.named_parameters():
        st = {key: m[name].to(p.device) for key, m in zip(vectors, moments)}
        if kind != "SGD":
            st["step"] = torch.tensor(step, dtype=torch.float32)
        opt.state[p] = st
    return count
