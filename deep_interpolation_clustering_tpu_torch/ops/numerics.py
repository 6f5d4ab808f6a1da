"""Plain `softplus` and `logsumexp` (counterpart of the JAX `ops/numerics.py`).

The JAX module Newton-refines `log` because the TPU's `log` is inaccurate;
the card's and the CPU's `log` are accurate to about an ulp, so the port
keeps the plain forms. The parity tests hold them to 1e-5 against the JAX
package.
"""

from __future__ import annotations

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
