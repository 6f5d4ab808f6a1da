"""Weights carried across from the JAX package (the port's own copy of the
name map in the JAX `compat/torch_import.py`).

`state_dict_from_jax(params, state)` turns the JAX parameter and state
pytrees (nested dicts of arrays) into the port's `Net.state_dict()`, whose
keys are the reference torch model's names; `jax_from_state_dict` is the
inverse. Works on NumPy-convertible values, so JAX itself is not needed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

_HEADS = ("predict_future", "aux_head", "fake_det_head")


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
    return params, state
