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
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch


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


def _kmeanspp_init(generator: torch.Generator, x: torch.Tensor, k: int,
                   n_init: int = 1) -> torch.Tensor:
    """Greedy k-means++ for `n_init` restarts at once: (n_init, k, D) centres,
    each a row of `x`. The first centre is uniform; each next one is the
    best by potential of `2 + floor(log k)` candidates drawn in proportion
    to the squared distance to the closest centre so far."""
    n, d = x.shape
    n_trials = 2 + int(math.floor(math.log(k))) if k > 1 else 1
    rows = torch.arange(n_init, device=x.device)
    first = torch.randint(0, n, (n_init,), generator=generator, device=x.device)
    centers = torch.zeros((n_init, k, d), dtype=x.dtype, device=x.device)
    centers[:, 0] = x[first]
    closest = pairwise_sq_dist(x, x[first]).T  # (I, N)
    for i in range(1, k):
        cand_idx = torch.multinomial(torch.clamp_min(closest, 1e-30), n_trials,
                                     replacement=True, generator=generator)  # (I, T)
        cand = x[cand_idx]  # (I, T, D)
        new_closest = torch.minimum(closest[:, :, None], pairwise_sq_dist(x, cand))
        best = torch.argmin(torch.sum(new_closest, dim=1), dim=1)  # (I,)
        centers[:, i] = cand[rows, best]
        closest = new_closest[rows, :, best]
    return centers


def _assign(x: torch.Tensor, centers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels (I, N) and each point's squared distance to its centre."""
    dist = pairwise_sq_dist(x, centers)
    labels = torch.argmin(dist, dim=-1)
    return labels, torch.gather(dist, -1, labels[..., None])[..., 0]


def _lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int, tol
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd iterations from `centers` ((K, D), or (I, K, D) restarts):
    assign, update, reseed empty clusters from the farthest points, and
    stop a restart once its centres' squared shift is <= `tol`; then a
    final assign. Returns (centers, labels, inertia, n_iter)."""
    single = centers.dim() == 2
    if single:
        centers = centers[None]
    n = x.shape[0]
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
        new_centers = sums / torch.clamp_min(counts, 1.0)[..., None]
        # empty clusters: the farthest points from their centres, in order
        far_order = torch.argsort(-min_dist, dim=1, stable=True)
        empty = counts == 0
        empty_rank = torch.cumsum(empty.to(torch.int64), dim=1) - 1
        reseed = x[torch.gather(far_order, 1, torch.clamp(empty_rank, 0, n - 1))]
        new_centers = torch.where(empty[..., None], reseed, new_centers)
        new_shift = torch.sum(torch.square(new_centers - centers), dim=(1, 2))
        centers = torch.where(active[:, None, None], new_centers, centers)
        shift = torch.where(active, new_shift, shift)
        n_iter = n_iter + active.to(torch.int64)
    labels, min_dist = _assign(x, centers)
    inertia = torch.sum(min_dist, dim=1)
    if single:
        return centers[0], labels[0], inertia[0], n_iter[0]
    return centers, labels, inertia, n_iter


def kmeans_fit(generator: torch.Generator, x: torch.Tensor, k: int, n_init: int = 10,
               max_iter: int = 300, tol: float = 1e-4) -> KMeansResult:
    """Fit k-means on `x`'s device; the best of `n_init` restarts by
    inertia (the first on ties)."""
    x = x.to(torch.float32)
    # sklearn scales tol by the mean per-feature population variance
    tol_scaled = tol * torch.mean(torch.var(x, dim=0, correction=0))
    centers0 = _kmeanspp_init(generator, x, k, n_init)
    centers, labels, inertia, n_iter = _lloyd(x, centers0, max_iter, tol_scaled)
    best = torch.argmin(inertia)
    return KMeansResult(centers[best], labels[best], inertia[best], n_iter[best])


def kmeans_predict(centers: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.argmin(pairwise_sq_dist(x.to(torch.float32), centers), dim=1)


def kmeans_inertia(centers: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    d = pairwise_sq_dist(x.to(torch.float32), centers)
    return torch.sum(torch.min(d, dim=1).values)


def mean_min_distance(centers: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Mean distance to the closest centre, the elbow's 'distortion'
    (reference p2_clustering_optK.py:260-265)."""
    d = pairwise_sq_dist(x.to(torch.float32), centers)
    return torch.mean(torch.sqrt(torch.min(d, dim=1).values))


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
