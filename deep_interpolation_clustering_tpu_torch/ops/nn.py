"""Primitive layers: linear, batch-norm, dropout, MLP heads (counterpart of
the JAX `ops/nn.py`, unfused: the JAX default `fused_heads=False`).

Modules keep the reference's torch parameter names so that a `state_dict`
maps 1:1 onto the reference checkpoints. Every random draw (init, dropout)
takes an explicit `torch.Generator`. BatchNorm updates its running buffers
in place in train mode (the JAX functions return the new state instead).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

BN_EPS = 1e-5  # torch BatchNorm1d default
BN_MOMENTUM = 0.1  # torch BatchNorm1d default


def uniform_(t: torch.Tensor, low: float, high: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(low, high, generator=generator)


class Linear(nn.Module):
    """`y = x @ weight.T + bias`, torch's (out, in) weight layout. Unlike
    nn.Linear it draws nothing at construction: `reset_parameters` draws
    torch's default init, U(-1/sqrt(in), 1/sqrt(in)), from `generator`."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        uniform_(self.weight, -bound, bound, generator)
        uniform_(self.bias, -bound, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.T + self.bias


class BatchNorm(nn.Module):
    """BatchNorm1d with the reference's parameter and buffer names, plus the
    JAX package's `row_mask`-weighted train moments (nn.py:47-85)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor, train: bool,
                row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Train: normalize with the biased batch variance and update the
        running stats with the unbiased one. Eval: running stats."""
        if train:
            if row_mask is None:
                mean = torch.mean(x, dim=0)
                var = torch.mean(torch.square(x - mean), dim=0)  # biased
                n = x.shape[0]
                unbiased = var * (n / max(n - 1, 1))
            else:
                m = row_mask[:, None]
                n = torch.sum(row_mask)
                mean = torch.sum(x * m, dim=0) / n
                var = torch.sum(torch.square(x - mean) * m, dim=0) / n  # biased
                unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
            with torch.no_grad():
                self.running_mean.copy_(
                    (1 - BN_MOMENTUM) * self.running_mean + BN_MOMENTUM * mean
                )
                self.running_var.copy_(
                    (1 - BN_MOMENTUM) * self.running_var + BN_MOMENTUM * unbiased
                )
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + BN_EPS) * self.weight + self.bias


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """torch nn.Dropout semantics with the mask drawn from `generator`."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Head(nn.Module):
    """Linear -> BN -> [ReLU] -> Dropout -> Linear trunk shared by
    CompressFC (`relu=True`, reference rbf.py:111-125) and the
    FuturePredFc / AuxFc / FakeDetFc heads (pretrain_interp.py:43-87).
    The ReLU and dropout slots carry no weights; they keep the reference's
    `model.<i>` indices."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, relu: bool = False):
        super().__init__()
        self.relu = relu
        layers = [Linear(in_dim, hidden), BatchNorm(hidden)]
        if relu:
            layers.append(nn.ReLU())
        layers += [nn.Identity(), Linear(hidden, out_dim)]  # Identity: dropout slot
        self.model = nn.Sequential(*layers)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.model[0].reset_parameters(generator)
        self.model[-1].reset_parameters(generator)

    def forward(self, x: torch.Tensor, rate: float, train: bool,
                generator: Optional[torch.Generator],
                row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.model[0](x)
        h = self.model[1](h, train, row_mask)
        if self.relu:
            h = torch.relu(h)
        h = dropout(h, rate, train, generator)
        return self.model[-1](h)
