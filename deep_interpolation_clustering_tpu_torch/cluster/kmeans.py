"""k-means on the latents' device: k-means++ init, Lloyd iterations, best
of `n_init` (counterpart of the JAX `cluster/kmeans.py`).

The `n_init` restarts run as one batch, as the JAX package's `vmap` runs
them: every distance is one matmul for all restarts, and the Lloyd loop
steps each restart until its own shift falls to `tol`, then holds it, so
each restart ends where it would alone. The loop's one host read an
iteration is whether any restart is still moving.

Semantics are sklearn.cluster.KMeans's, as in JAX: greedy k-means++ with
`2 + floor(log k)` candidates per centre, Lloyd to `max_iter=300` with
`tol=1e-4` scaled by the mean per-feature (population) variance, empty
clusters reseeded from the points farthest from their centre, the best
restart by inertia (the first on ties). Draws come from an explicit
`torch.Generator` on the latents' device; they are not JAX's, so the same
seed gives another (equally valid) clustering. Run with TF32 off
(`utils.device.resolve_device`): a TF32 distance can flip a borderline
assignment, which is why JAX asks for `precision="highest"`.

`sharded=True` fits rows that are row-sharded over the data-parallel ranks
(p2 under `--data_parallel N`, as JAX row-shards them over its mesh): rank
r holds rows [r*n, (r+1)*n) as `x`. The tolerance's variance comes from
moments summed over ranks; k-means++ gathers the per-row potentials, so
every rank's generator draws the same candidates from the same weights, and
takes the candidate rows from their owners (`parallel.take_rows`); Lloyd's
one-hot sums and counts are summed over ranks; the empty-cluster reseed
orders the gathered distances; a sum over rows (a restart's potential, the
inertia, the distortion) runs over the gathered per-row values, in one
process's order. Every rank then holds the same centres and leaves the
loop on the same round. Against one process only the one-hot sums (and the
tolerance) are added in another order: on data whose sums are exact (a
grid) the fit is one process's bit for bit, elsewhere within float32
rounding. The labels are the rank's rows'.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import parallel


class KMeansResult(NamedTuple):
    centers: torch.Tensor  # (K, D)
    labels: torch.Tensor  # (N,)
    inertia: torch.Tensor  # scalar
    n_iter: torch.Tensor  # scalar


def pairwise_sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances (N, M) by the matmul identity, clamped at
    0; `y` may carry a leading batch of restarts, (I, M, D) -> (I, N, M)."""
    x_sq = torch.sum(torch.square(x), dim=1, keepdim=True)
    y_sq = torch.sum(torch.square(y), dim=-1)
    d = x_sq - 2.0 * torch.matmul(x, y.transpose(-1, -2)) + y_sq[..., None, :]
    return torch.clamp_min(d, 0.0)


def _gathered(t: torch.Tensor, sharded: bool, dim: int = 0) -> torch.Tensor:
    """A per-row tensor (rows on `dim`) with every rank's rows, in order."""
    if not sharded:
        return t
    return parallel.gather_rows(t.movedim(dim, 0)).movedim(0, dim)


def _take(x: torch.Tensor, idx: torch.Tensor, sharded: bool) -> torch.Tensor:
    return parallel.take_rows(x, idx) if sharded else x[idx]


def _kmeanspp_init(generator: torch.Generator, x: torch.Tensor, k: int,
                   n_init: int = 1, sharded: bool = False) -> torch.Tensor:
    """Greedy k-means++ for `n_init` restarts at once: (n_init, k, D) centres,
    each a row of `x`. The first centre is uniform; each next one is the
    best by potential of `2 + floor(log k)` candidates drawn in proportion
    to the squared distance to the closest centre so far."""
    n, d = x.shape
    if sharded:
        n *= parallel.world_size()
    n_trials = 2 + int(math.floor(math.log(k))) if k > 1 else 1
    rows = torch.arange(n_init, device=x.device)
    first = torch.randint(0, n, (n_init,), generator=generator, device=x.device)
    centers = torch.zeros((n_init, k, d), dtype=x.dtype, device=x.device)
    centers[:, 0] = _take(x, first, sharded)
    closest = pairwise_sq_dist(x, centers[:, 0]).T  # (I, N): this rank's rows
    closest_all = _gathered(closest, sharded, 1)  # every rank's
    for i in range(1, k):
        cand_idx = torch.multinomial(torch.clamp_min(closest_all, 1e-30), n_trials,
                                     replacement=True, generator=generator)  # (I, T)
        cand = _take(x, cand_idx, sharded)  # (I, T, D)
        new_closest = torch.minimum(closest[:, :, None], pairwise_sq_dist(x, cand))
        new_all = _gathered(new_closest, sharded, 1)
        best = torch.argmin(torch.sum(new_all, dim=1), dim=1)  # (I,)
        centers[:, i] = cand[rows, best]
        closest = new_closest[rows, :, best]
        closest_all = new_all[rows, :, best]
    return centers


def _assign(x: torch.Tensor, centers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels (I, N) and each point's squared distance to its centre."""
    dist = pairwise_sq_dist(x, centers)
    labels = torch.argmin(dist, dim=-1)
    return labels, torch.gather(dist, -1, labels[..., None])[..., 0]


def _lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int, tol,
           sharded: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd iterations from `centers` ((K, D), or (I, K, D) restarts):
    assign, update, reseed empty clusters from the farthest points, and
    stop a restart once its centres' squared shift is <= `tol`; then a
    final assign. Returns (centers, labels, inertia, n_iter)."""
    single = centers.dim() == 2
    if single:
        centers = centers[None]
    n = x.shape[0] * (parallel.world_size() if sharded else 1)
    n_init, k, _ = centers.shape
    shift = torch.full((n_init,), float("inf"), dtype=x.dtype, device=x.device)
    n_iter = torch.zeros((n_init,), dtype=torch.int64, device=x.device)
    for _ in range(max_iter):
        active = shift > tol
        if not bool(active.any()):
            break
        labels, min_dist = _assign(x, centers)
        one_hot = torch.nn.functional.one_hot(labels, k).to(x.dtype)  # (I, N, K)
        counts = torch.sum(one_hot, dim=1)  # (I, K)
        sums = torch.matmul(one_hot.transpose(1, 2), x)  # (I, K, D)
        if sharded:
            counts, sums = parallel.all_sum(counts), parallel.all_sum(sums)
        new_centers = sums / torch.clamp_min(counts, 1.0)[..., None]
        # empty clusters: the farthest points from their centres, in order
        far_order = torch.argsort(-_gathered(min_dist, sharded, 1), dim=1, stable=True)
        empty = counts == 0
        empty_rank = torch.cumsum(empty.to(torch.int64), dim=1) - 1
        reseed = _take(x, torch.gather(far_order, 1, torch.clamp(empty_rank, 0, n - 1)),
                       sharded)
        new_centers = torch.where(empty[..., None], reseed, new_centers)
        new_shift = torch.sum(torch.square(new_centers - centers), dim=(1, 2))
        centers = torch.where(active[:, None, None], new_centers, centers)
        shift = torch.where(active, new_shift, shift)
        n_iter = n_iter + active.to(torch.int64)
    labels, min_dist = _assign(x, centers)
    inertia = torch.sum(_gathered(min_dist, sharded, 1), dim=1)
    if single:
        return centers[0], labels[0], inertia[0], n_iter[0]
    return centers, labels, inertia, n_iter


def kmeans_fit(generator: torch.Generator, x: torch.Tensor, k: int, n_init: int = 10,
               max_iter: int = 300, tol: float = 1e-4, sharded: bool = False
               ) -> KMeansResult:
    """Fit k-means on `x`'s device; the best of `n_init` restarts by
    inertia (the first on ties). `sharded`: `x` is this rank's block of
    rows (the module docstring); the labels are its rows'."""
    x = x.to(torch.float32)
    # sklearn scales tol by the mean per-feature population variance;
    # sharded, from float64 moments summed over ranks
    if sharded:
        x64 = x.to(torch.float64)
        moments = parallel.all_sum(torch.stack([torch.sum(x64, dim=0),
                                                torch.sum(x64 * x64, dim=0)]))
        n = x.shape[0] * parallel.world_size()
        mean = moments[0] / n
        var = torch.clamp_min(moments[1] / n - mean * mean, 0.0).to(torch.float32)
    else:
        var = torch.var(x, dim=0, correction=0)
    tol_scaled = tol * torch.mean(var)
    centers0 = _kmeanspp_init(generator, x, k, n_init, sharded)
    centers, labels, inertia, n_iter = _lloyd(x, centers0, max_iter, tol_scaled, sharded)
    best = torch.argmin(inertia)
    return KMeansResult(centers[best], labels[best], inertia[best], n_iter[best])


def kmeans_predict(centers: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.argmin(pairwise_sq_dist(x.to(torch.float32), centers), dim=1)


def kmeans_inertia(centers: torch.Tensor, x: torch.Tensor,
                   sharded: bool = False) -> torch.Tensor:
    d = pairwise_sq_dist(x.to(torch.float32), centers)
    return torch.sum(_gathered(torch.min(d, dim=1).values, sharded))


def mean_min_distance(centers: torch.Tensor, x: torch.Tensor,
                      sharded: bool = False) -> torch.Tensor:
    """Mean distance to the closest centre, the elbow's 'distortion'
    (reference p2_clustering_optK.py:260-265)."""
    d = pairwise_sq_dist(x.to(torch.float32), centers)
    return torch.mean(_gathered(torch.sqrt(torch.min(d, dim=1).values), sharded))


def fit_kmeans_impl(cfg, seed: int, x, k: int, n_init: int) -> KMeansResult:
    """By `cfg.kmeans_impl`: "device" runs `kmeans_fit` on the device of the
    tensor `x`; "sklearn" the NumPy mirror of sklearn's path on the host
    array `x` (its fields then NumPy). Shared by p3's centre init and p4."""
    if cfg.kmeans_impl == "sklearn":
        from .sklearn_compat import kmeans_fit_sklearn

        return kmeans_fit_sklearn(np.asarray(x), k, n_init=n_init, random_state=seed)
    if cfg.kmeans_impl != "device":
        raise ValueError(f"unknown kmeans_impl {cfg.kmeans_impl!r}")
    if not isinstance(x, torch.Tensor):
        raise TypeError("kmeans_impl='device' fits a tensor on its device; got "
                        f"{type(x).__name__}")
    generator = torch.Generator(device=x.device).manual_seed(seed)
    return kmeans_fit(generator, x, k, n_init=n_init)
