"""Primitive layers: linear, batch-norm, dropout, MLP heads, and several
heads run as one batched chain (counterpart of the JAX `ops/nn.py`).

Modules keep the reference's torch parameter names so that a `state_dict`
maps 1:1 onto the reference checkpoints. Every random draw (init, dropout)
takes an explicit `torch.Generator`. BatchNorm updates its running buffers
in place in train mode (the JAX functions return the new state instead).

Data-parallel (`parallel.world_size() > 1`, each rank holding its block of
the global batch's rows): the train-mode moments are global-batch ones,
summed over ranks in two passes (the masked sum and count give the mean,
then the masked squared deviations give the variance), so the running
statistics are the same on every rank; dropout draws its mask at the
global shape from the generator every rank seeds alike and keeps the
rank's rows. In a world of one the single-device code runs unchanged.

Under the bfloat16 `compute_dtype` a product of mixed operands takes their
common type, as `jnp` gives it (`numerics.matmul`), and the dropout mask is
drawn from a float32 uniform whatever the input's type, so that a bfloat16
step draws the float32 step's masks.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import parallel
from .numerics import matmul

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
        return matmul(x, self.weight.T) + self.bias


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
            if parallel.world_size() > 1:
                mean, var, unbiased = global_moments(x, row_mask)
            elif row_mask is None:
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


def global_moments(x: torch.Tensor, row_mask: Optional[torch.Tensor]):
    """(mean, biased variance, unbiased variance) of the rows of `x` over
    every rank's rows, weighted by `row_mask` when given: the masked sum and
    the count summed over ranks give the mean, then the masked squared
    deviations summed over ranks give the variance. With autograd through
    both sums."""
    if row_mask is None:
        n = float(x.shape[0] * parallel.world_size())
        mean = parallel.all_sum_grad(torch.sum(x, dim=0)) / n
        var = parallel.all_sum_grad(torch.sum(torch.square(x - mean), dim=0)) / n
        return mean, var, var * (n / max(n - 1.0, 1.0))
    m = row_mask[:, None]
    n = parallel.all_sum(torch.sum(row_mask))
    mean = parallel.all_sum_grad(torch.sum(x * m, dim=0)) / n
    var = parallel.all_sum_grad(torch.sum(torch.square(x - mean) * m, dim=0)) / n
    return mean, var, var * (n / torch.clamp(n - 1.0, min=1.0))


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator],
            segments: Optional[Sequence[int]] = None) -> torch.Tensor:
    """torch nn.Dropout semantics with the mask drawn from `generator`.

    Data-parallel, the mask is drawn at the global shape and the rank's rows
    kept: `x`'s rows are its block of a global plane of D times as many
    rows, or with `segments` (local row counts) its block of each of the
    plane's segments (`parallel.segment_rows`)."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit generator")
    d = parallel.world_size()
    if d == 1:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    else:
        u = torch.rand((d * x.shape[0],) + tuple(x.shape[1:]), generator=generator,
                       device=x.device)
        keep = parallel.segment_rows(u, segments or [x.shape[0]]) < 1.0 - rate
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


def heads_apply_fused(
    heads: Sequence[Tuple[Head, torch.Tensor, Optional[torch.Tensor]]],
    rate: float, train: bool, generator: Optional[torch.Generator],
) -> List[torch.Tensor]:
    """Run several `Head` trunks as one batched chain (the JAX
    `heads_apply_fused`, `Config.fused_heads`): one fc1 product over the
    row-concat of every head's input and the column-concat of every fc1
    weight, one normalize pass, one masked ReLU, one dropout draw over the
    whole plane and one block-diagonal fc2 product.

    `heads`: (head, x, row_mask) triples with a shared input width; a
    row mask (train only) weights that head's moments as in `BatchNorm`.
    The BatchNorm statistics stay per head: a (heads, rows) row-segment
    indicator, with the row masks folded in, sums each head's column block
    over its own rows by one product. The off-segment blocks of the fc1
    product are finite, normalized by the owning head's statistics and
    multiplied by the exact zeros of the block-diagonal fc2, so each head's
    output equals its own chain up to float32 summation order. In train
    mode each head's running statistics are updated in place. Data-parallel,
    the sums and counts are summed over ranks (each head's moments are
    global-batch ones) and the dropout plane is drawn at the global shape.
    Returns the heads' outputs in order.
    """
    mods = [h for h, _, _ in heads]
    xs = [x for _, x, _ in heads]
    rows = [x.shape[0] for x in xs]
    fc1s = [h.model[0] for h in mods]
    bns = [h.model[1] for h in mods]
    fc2s = [h.model[-1] for h in mods]
    cols = [0]
    for fc1 in fc1s:
        cols.append(cols[-1] + fc1.weight.shape[0])
    row_off = [0]
    for n in rows:
        row_off.append(row_off[-1] + n)
    outs = [0]
    for fc2 in fc2s:
        outs.append(outs[-1] + fc2.weight.shape[0])

    x_cat = torch.cat(xs, dim=0)  # (N, in)
    w1 = torch.cat([fc1.weight for fc1 in fc1s], dim=0)
    b1 = torch.cat([fc1.bias for fc1 in fc1s])
    hid = matmul(x_cat, w1.T) + b1  # (N, HS)

    if train:
        # float32, as JAX builds it: under bfloat16 the sums come out float32
        seg = torch.zeros((len(heads), row_off[-1]), dtype=torch.float32, device=hid.device)
        for i in range(len(heads)):
            seg[i, row_off[i]:row_off[i + 1]] = 1.0
        masks = [m for _, _, m in heads]
        counts = [float(n) for n in rows]
        if any(m is not None for m in masks):
            seg = seg * torch.cat([m if m is not None else torch.ones(n, dtype=hid.dtype,
                                                                      device=hid.device)
                                   for m, n in zip(masks, rows)])[None, :]
            counts = [torch.sum(m) if m is not None else c for m, c in zip(masks, counts)]
        if parallel.world_size() > 1:
            counts = [parallel.all_sum(c) if isinstance(c, torch.Tensor)
                      else c * parallel.world_size() for c in counts]
        sums = parallel.all_sum_grad(matmul(seg, hid))  # (heads, HS): each head's column sums
        mean_blocks = [sums[i, cols[i]:cols[i + 1]] / counts[i] for i in range(len(heads))]
        mean_vec = torch.cat(mean_blocks)
        sq = parallel.all_sum_grad(matmul(seg, torch.square(hid - mean_vec)))
        var_blocks = [sq[i, cols[i]:cols[i + 1]] / counts[i] for i in range(len(heads))]
        var_vec = torch.cat(var_blocks)
        with torch.no_grad():
            for bn, n, mean, var in zip(bns, counts, mean_blocks, var_blocks):
                if isinstance(n, float):
                    unbiased = var * (n / max(n - 1.0, 1.0))
                else:
                    unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                bn.running_mean.copy_((1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * mean)
                bn.running_var.copy_((1 - BN_MOMENTUM) * bn.running_var
                                     + BN_MOMENTUM * unbiased)
    else:
        mean_vec = torch.cat([bn.running_mean for bn in bns])
        var_vec = torch.cat([bn.running_var for bn in bns])

    gamma = torch.cat([bn.weight for bn in bns])
    beta = torch.cat([bn.bias for bn in bns])
    y = (hid - mean_vec) * torch.rsqrt(var_vec + BN_EPS) * gamma + beta
    if any(h.relu for h in mods):
        relu_cols = torch.zeros(cols[-1], dtype=torch.bool, device=hid.device)
        for i, h in enumerate(mods):
            if h.relu:
                relu_cols[cols[i]:cols[i + 1]] = True
        y = torch.where(relu_cols, torch.clamp(y, min=0.0), y)
    y = dropout(y, rate, train, generator, rows)

    w2 = torch.block_diag(*[fc2.weight.T for fc2 in fc2s])  # (HS, OS)
    b2 = torch.cat([fc2.bias for fc2 in fc2s])
    out = matmul(y, w2) + b2  # (N, OS)
    return [out[row_off[i]:row_off[i + 1], outs[i]:outs[i + 1]] for i in range(len(heads))]
