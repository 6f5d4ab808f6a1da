"""Deep Embedded Clustering ops (counterpart of the JAX `ops/dec.py`,
reference dec.py:32-76): the centres' init, the Student-t soft assignment
and the target distribution.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import parallel


def centers_init(cluster_number: int, dim: int,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Xavier-uniform (K, dim) centres: U(-a, a), a = sqrt(6 / (K + dim)),
    torch's `nn.init.xavier_uniform_` drawn from `generator`."""
    bound = math.sqrt(6.0 / (cluster_number + dim))
    out = torch.empty((cluster_number, dim))
    return out.uniform_(-bound, bound, generator=generator)


def soft_assignment(centers: torch.Tensor, batch: torch.Tensor,
                    alpha: float = 1.0) -> torch.Tensor:
    """q_ij ∝ (1 + ||z_i - mu_j||^2 / alpha)^(-(alpha+1)/2), rows summing to
    1. The distances come from the (B, K, D) differences, as JAX computes
    them, not from the matmul identity."""
    norm_sq = torch.sum(torch.square(batch[:, None, :] - centers[None, :, :]), dim=2)
    numerator = (1.0 + norm_sq / alpha) ** (-(alpha + 1.0) / 2.0)
    return numerator / torch.sum(numerator, dim=1, keepdim=True)


def target_distribution(q: torch.Tensor,
                        sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """p_ij = (q_ij^2 / f_j) / sum_j' (q_ij'^2 / f_j'), f_j = sum_i q_ij over
    the rows `sample_mask` marks real (all rows without it), over every
    rank's rows when data-parallel. The caller detaches the result
    (reference clustering_interp.py:186)."""
    if sample_mask is None:
        f = torch.sum(q, dim=0)
    else:
        f = torch.sum(torch.where(sample_mask[:, None] > 0, q, torch.zeros_like(q)), dim=0)
    f = parallel.all_sum(f)
    weight = torch.square(q) / f
    return weight / torch.sum(weight, dim=1, keepdim=True)
