"""Internal cluster-validity metrics and the gap statistic's inertias on the
latents' device (counterpart of the JAX `cluster/metrics.py`, reference
internal_eval.py:15-147 and p2_clustering_optK.py:334-351).

Everything that needs pairwise distances is one blocked sweep: rows in
blocks of `block` against all N rows, one (block, N) slab at a time (N x N
is never held), giving each point's distance sums to every cluster and, for
the Dunn index, the nearest and farthest points of each pair of clusters.
Silhouette, Dunn and both inertias follow from those; Davies-Bouldin and
Calinski-Harabasz need only centroid distances.

Distances are plain Euclidean (sklearn's `pairwise_distances`), squared only
where the formula says so (CH), by the matmul identity of
`kmeans.pairwise_sq_dist`. The port runs with TF32 off
(`utils.device.resolve_device`): the k-distance knee and DBSCAN's eps are
read as absolute distances.

JAX takes each slab's per-cluster min and max with `segment_min`/`segment_max`
over the columns' labels. Here the rows are sorted by label once, so each
cluster's columns are one contiguous range of the slab and its rows one
range of the blocks: plain slices, no atomics. A cluster with no member
keeps JAX's identities, +inf for the min and -inf for the max. The slices
cost one host read of the cluster sizes a call, and only the Dunn index
asks for them. Rows are not padded, so every label lies in [0, k).

Functions take tensors (or arrays, which become CPU tensors) and compute on
the device of `x`. With `sharded=True`, `x` and `labels` are this rank's
block of rows of data row-sharded over the data-parallel ranks (p2 under
`--data_parallel N`): every rank gathers all rows, then takes its share of
the blocked sweep's rows against all of them, and the shares are combined
exactly (each rank's rows of the per-row sums in a zero buffer, summed over
ranks; the per-pair extrema by a min and a max over ranks). The metrics
are then one process's, computed from the same per-row sums.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import parallel
from .kmeans import pairwise_sq_dist


class PairwiseStats(NamedTuple):
    sums: torch.Tensor  # (N, K) sum of distances from point i to cluster j's points
    counts: torch.Tensor  # (K,) cluster sizes
    pair_min: Optional[torch.Tensor]  # (K, K) min inter-point distance between clusters
    pair_max: Optional[torch.Tensor]  # (K, K) max inter-point distance between clusters


def _rows(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _labels(labels, device) -> torch.Tensor:
    return torch.as_tensor(labels, device=device).to(torch.int64)


def sq_dist_slab(xb: torch.Tensor, x: torch.Tensor, x_sq: torch.Tensor) -> torch.Tensor:
    """(block, N) squared distances of the rows `xb` to all rows `x`
    (`x_sq` their squared norms), `pairwise_sq_dist`'s identity clamped at
    0, built in place: at 70,000 rows a slab is 287 MB, and the plain
    expression holds three of them."""
    d = torch.addmm(torch.sum(xb * xb, dim=1, keepdim=True), xb, x.T, alpha=-2.0)
    return d.add_(x_sq).clamp_min_(0.0)


def kth_neighbor_distance(x, k: int, block: int = 1024) -> torch.Tensor:
    """Euclidean distance to the k-th nearest neighbour (self EXCLUDED) of
    every row: the DBSCAN k-distance curve (reference sklearn
    NearestNeighbors, p2_clustering_optK.py:97-107), one blocked sweep."""
    x = _rows(x)
    n = x.shape[0]
    if not 1 <= k <= n - 1:
        raise ValueError(
            f"k={k} neighbors requested but only {n} rows exist "
            f"(valid range: 1..{n - 1})"
        )
    x_sq = torch.sum(x * x, dim=1)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        sq = sq_dist_slab(x[start:stop], x, x_sq)
        rows = torch.arange(stop - start, device=x.device)
        sq[rows, rows + start] = float("inf")
        out[start:stop] = torch.sqrt(torch.kthvalue(sq, k, dim=1).values)
        del sq
    return out


def _all_rows(x, labels, sharded: bool):
    """(x, labels) as tensors, every rank's rows when `sharded`."""
    x = _rows(x)
    labels = _labels(labels, x.device)
    if sharded:
        x, labels = parallel.gather_rows(x), parallel.gather_rows(labels)
    return x, labels


def pairwise_cluster_stats(x, labels, k: int, block: int = 1024,
                           extrema: bool = True, split: bool = False) -> PairwiseStats:
    """One blocked sweep over all pairwise distances; `extrema=False` skips
    the per-pair min and max (and their host read). `split`: `x` holds every
    rank's rows and this rank sweeps its contiguous share of the (label-
    sorted) rows, the shares combined exactly over ranks."""
    x = _rows(x)
    labels = _labels(labels, x.device)
    n = x.shape[0]
    lo, hi = 0, n
    if split and parallel.world_size() > 1:
        share = -(-n // parallel.world_size())
        lo, hi = min(n, parallel.rank() * share), min(n, (parallel.rank() + 1) * share)
    order = torch.argsort(labels, stable=True)
    xs, ls = x[order], labels[order]
    one_hot = F.one_hot(ls, k).to(torch.float32)  # (N, K)
    counts = torch.sum(one_hot, dim=0)
    x_sq = torch.sum(xs * xs, dim=1)
    sums = torch.zeros((n, k), dtype=torch.float32, device=x.device)
    pair_min = pair_max = None
    if extrema:
        ends = torch.cumsum(counts.to(torch.int64), 0).tolist()
        spans = list(zip([0] + ends[:-1], ends))  # each cluster's rows and columns
        pair_min = torch.full((k, k), float("inf"), device=x.device)
        pair_max = torch.full((k, k), float("-inf"), device=x.device)
    for start in range(lo, hi, block):
        stop = min(start + block, hi)
        dist = sq_dist_slab(xs[start:stop], xs, x_sq).sqrt_()  # (block, N)
        sums[start:stop] = dist @ one_hot
        if extrema:
            lows, highs = [], []
            for lo, hi in spans:  # per-row min/max distance to each cluster
                if hi > lo:
                    low, high = torch.aminmax(dist[:, lo:hi], dim=1)
                else:
                    low = torch.full((stop - start,), float("inf"), device=x.device)
                    high = torch.full((stop - start,), float("-inf"), device=x.device)
                lows.append(low)
                highs.append(high)
            row_min, row_max = torch.stack(lows, 1), torch.stack(highs, 1)
            for c, (lo, hi) in enumerate(spans):  # aggregate rows by their own label
                r0, r1 = max(lo, start) - start, min(hi, stop) - start
                if r1 > r0:
                    pair_min[c] = torch.minimum(pair_min[c], row_min[r0:r1].amin(0))
                    pair_max[c] = torch.maximum(pair_max[c], row_max[r0:r1].amax(0))
        del dist
    if split:
        sums = parallel.all_sum(sums)
        if extrema:
            pair_min, pair_max = parallel.all_min(pair_min), parallel.all_max(pair_max)
    out = torch.empty_like(sums)
    out[order] = sums
    return PairwiseStats(out, counts, pair_min, pair_max)


# ----------------------------------------------------------- silhouette
def silhouette_score(x, labels, k: int, block: int = 1024,
                     sharded: bool = False) -> torch.Tensor:
    """Mean silhouette coefficient (sklearn.metrics.silhouette_score)."""
    x, labels = _all_rows(x, labels, sharded)
    stats = pairwise_cluster_stats(x, labels, k, block, extrema=False, split=sharded)
    return _silhouette_from_stats(stats, labels, k)


def _silhouette_from_stats(stats: PairwiseStats, labels: torch.Tensor, k: int) -> torch.Tensor:
    own = F.one_hot(labels, k).to(torch.float32)
    n_own = stats.counts[labels]  # (N,)
    a = torch.sum(stats.sums * own, dim=1) / torch.clamp_min(n_own - 1.0, 1.0)
    inf = torch.tensor(float("inf"), device=own.device)
    mean_other = torch.where(own > 0, inf,
                             stats.sums / torch.clamp_min(stats.counts, 1.0)[None, :])
    # an empty cluster's 0/1 = 0 would win the min: mask it
    mean_other = torch.where(stats.counts[None, :] > 0, mean_other, inf)
    b = torch.amin(mean_other, dim=1)
    s = (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-30)
    s = torch.where(n_own > 1, s, 0.0)  # singleton clusters score 0
    return torch.mean(s)


# ------------------------------------------------- centroid-based scores
def _centers(x: torch.Tensor, labels: torch.Tensor, k: int):
    one_hot = F.one_hot(labels, k).to(torch.float32)
    counts = torch.sum(one_hot, dim=0)
    return one_hot, counts, (one_hot.T @ x) / torch.clamp_min(counts, 1.0)[:, None]


def calinski_harabasz_score(x, labels, k: int, sharded: bool = False) -> torch.Tensor:
    """(B/(k-1)) / (W/(n-k)) with squared Euclidean dispersions
    (sklearn.metrics.calinski_harabasz_score; internal_eval.py:131-138)."""
    x, labels = _all_rows(x, labels, sharded)
    n = x.shape[0]
    _, counts, centers = _centers(x, labels, k)
    mean = torch.mean(x, dim=0)
    b = torch.sum(counts * torch.sum(torch.square(centers - mean), dim=1))
    w = torch.sum(torch.square(x - centers[labels]))
    return (b / (k - 1)) / (w / (n - k))


def davies_bouldin_score(x, labels, k: int, sharded: bool = False) -> torch.Tensor:
    """Mean over clusters of the worst (s_i + s_j) / d_ij ratio
    (sklearn.metrics.davies_bouldin_score; internal_eval.py:141-147)."""
    x, labels = _all_rows(x, labels, sharded)
    one_hot, counts, centers = _centers(x, labels, k)
    dist_to_center = torch.sqrt(torch.sum(torch.square(x - centers[labels]), dim=1))
    s = (one_hot.T @ dist_to_center) / torch.clamp_min(counts, 1.0)  # (K,)
    d = torch.sqrt(pairwise_sq_dist(centers, centers))
    ratio = (s[:, None] + s[None, :]) / torch.where(d > 0, d, float("inf"))
    eye = torch.eye(k, dtype=torch.bool, device=x.device)
    ratio = torch.where(eye, float("-inf"), ratio)
    return torch.mean(torch.amax(ratio, dim=1))


def dunn_index(x, labels, k: int, block: int = 1024, sharded: bool = False) -> torch.Tensor:
    """min inter-cluster nearest-point distance / max cluster diameter (the
    reference's O(n^2) Python double loop, internal_eval.py:37-109)."""
    x, labels = _all_rows(x, labels, sharded)
    stats = pairwise_cluster_stats(x, labels, k, block, split=sharded)
    eye = torch.eye(k, dtype=torch.bool, device=stats.sums.device)
    min_inter = torch.amin(torch.where(eye, float("inf"), stats.pair_min))
    max_diam = torch.amax(torch.diagonal(stats.pair_max))
    return min_inter / max_diam


# -------------------------------------------------- gap-statistic inertia
def _within_sums(x, labels, k: int, block: int, sharded: bool):
    x, labels = _all_rows(x, labels, sharded)
    stats = pairwise_cluster_stats(x, labels, k, block, extrema=False, split=sharded)
    own = F.one_hot(labels, k).to(torch.float32)
    return torch.sum(stats.sums * own, dim=0), stats.counts  # (K,), (K,)


def inertia_v1(x, labels, k: int, block: int = 1024, sharded: bool = False) -> torch.Tensor:
    """W = mean over clusters of mean(full pairwise-distance matrix within
    the cluster, diagonal zeros included) (p2_clustering_optK.py:334-342)."""
    per_cluster_sum, counts = _within_sums(x, labels, k, block, sharded)
    w = per_cluster_sum / torch.clamp_min(torch.square(counts), 1.0)
    present = counts > 0
    return torch.sum(torch.where(present, w, 0.0)) / torch.sum(present)


def inertia_v2(x, labels, k: int, block: int = 1024, sharded: bool = False) -> torch.Tensor:
    """Tibshirani W_k = sum_c D_c / (2 n_c), D_c the full within-cluster
    pairwise-distance sum (p2_clustering_optK.py:344-351)."""
    per_cluster_sum, counts = _within_sums(x, labels, k, block, sharded)
    w = per_cluster_sum / (2.0 * torch.clamp_min(counts, 1.0))
    return torch.sum(torch.where(counts > 0, w, 0.0))


INTERNAL_METRICS = {
    "Sihouette": silhouette_score,  # [sic]: the reference's spelling (internal_eval.py:112)
    "Davies-Bouldin_Index": davies_bouldin_score,
    "Calinski-Harabasz": calinski_harabasz_score,
    "Dunn_Index": dunn_index,
}


def compute_internal_metrics(names, x, labels, k: int, sharded: bool = False
                             ) -> Dict[str, float]:
    """The named metrics as floats (one host read each); `sharded` as the
    module docstring says."""
    return {name: float(INTERNAL_METRICS[name](x, labels, k, sharded=sharded))
            for name in names}
