"""Plain `softplus` and `logsumexp` (counterpart of the JAX `ops/numerics.py`).

The JAX module Newton-refines `log` because the TPU's `log` is inaccurate;
the card's and the CPU's `log` are accurate to about an ulp, so the port
keeps the plain forms. The parity tests hold them to 1e-5 against the JAX
package.

`result_type` and `matmul` give a product of mixed float operands `jnp`'s
result type: `torch.matmul` raises on a bfloat16 operand beside a float32
one where `jnp` promotes both to float32 (the bfloat16 `compute_dtype`
meets such pairs; elementwise ops, `torch.where` and `torch.cat` promote
alike in both libraries).
"""

from __future__ import annotations

import functools

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`log(1 + exp(x))`, the reference's positivity transform
    (interpolation_layer.py:51, rbf.py:78), in its naive form."""
    return torch.log(1.0 + torch.exp(x))


def logsumexp(logits: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """Max-shifted logsumexp; a row whose entries are all -inf yields -inf
    (not NaN). The gradient is the exact softmax."""
    m = torch.amax(logits, dim=dim, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.sum(torch.exp(logits - m), dim=dim, keepdim=True)
    out = m + torch.log(s)
    if not keepdim:
        out = out.squeeze(dim)
    return out


def result_type(*xs: torch.Tensor) -> torch.dtype:
    """The operands' common type (`torch.promote_types`, which for floats is
    `jnp`'s result type)."""
    return functools.reduce(torch.promote_types, (x.dtype for x in xs))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b` in the operands' common type, as `jnp` computes it (an
    operand already of that type is not copied)."""
    dtype = result_type(a, b)
    return torch.matmul(a.to(dtype), b.to(dtype))
