"""The starting weights of a cell, made on the device from the seed in one
draw and handed to the program and to the reference alike.

The inits are the reference torch model's: every `nn.LSTM` and `nn.Linear`
tensor U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (an LSTM's fan-in is its hidden
size, a bias takes its weight's), the SCI and RBF kernels U[0, 1), CCI the
identity, BatchNorm's scale 1 and shift 0, the DEC centres Xavier-uniform.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _init(name: str, shape: Tuple[int, ...], shapes: Dict[str, Tuple[int, ...]]):
    """(low, high) of a uniform init, or a constant tensor's fill ("eye",
    1.0 or 0.0)."""
    if name in ("sci.kernel", "rbf.kernel"):
        return 0.0, 1.0
    if name == "cci.kernel":
        return "eye"
    if ".lstm." in name:
        hidden = shapes[name.rsplit(".", 1)[0] + ".weight_hh_l0"][1]
        return -1 / math.sqrt(hidden), 1 / math.sqrt(hidden)
    if name.endswith("cluster_centers"):
        a = math.sqrt(6.0 / (shape[0] + shape[1]))
        return -a, a
    layer, leaf = name.rsplit(".", 1)
    weight = shapes.get(layer + ".weight")
    if weight is not None and len(weight) == 2:  # a Linear
        a = 1 / math.sqrt(weight[1])
        return -a, a
    return 1.0 if leaf == "weight" else 0.0  # BatchNorm


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 weights under the state-dict names in `shapes`."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in sorted(shapes.items()):
        n = math.prod(shape)
        spec = _init(name, shape, shapes)
        if spec == "eye":
            out[name] = torch.eye(shape[0], device=device)
        elif isinstance(spec, float):
            out[name] = torch.full(shape, spec, device=device)
        else:
            lo, hi = spec
            out[name] = (flat[at:at + n] * (hi - lo) + lo).reshape(shape)
        at += n
    return out
