"""Host-side k-means that reproduces `sklearn.cluster.KMeans` bit for bit
(the port's own copy of the JAX package's `cluster/sklearn_compat.py`; it is
NumPy in both packages and must agree with that one bit for bit).

The reference labels cohorts with `sklearn.KMeans(n_init=20)`
(p4_clustering_final.py:159) and seeds DEC centres the same way
(clustering_trainer.py:75). This module walks sklearn's random path in
NumPy, so sklearn itself is not needed:

  * k-means++ consumes the same RandomState calls in the same order
    (`choice(p=...)` for the first centre, `uniform(n_local_trials)` per
    centre) with distances computed as sklearn computes them (float32 data
    upcast to float64, clipped at 0);
  * Lloyd follows `_kmeans_single_lloyd`: float32 gemm assignment, summed
    centre updates, sklearn's empty-cluster relocation (farthest points,
    no label rewrite), the strict-convergence check before the tol check,
    and the final extra E-step;
  * fit mean-centres the data, scales tol by the mean per-feature variance,
    and keeps a new best restart only when the inertia improves and the
    partition differs (`_is_same_clustering`).

It agrees with sklearn >= 1.3 run single-threaded; multi-threaded sklearn
sums centres in another order and a Voronoi-boundary point may flip. For
the device path use `kmeans.kmeans_fit`.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from .kmeans import KMeansResult


def _eucl_sq_upcast(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """sklearn `_euclidean_distances` for float32 inputs: compute in float64,
    cast back to float32, clip at 0."""
    a64 = a.astype(np.float64)
    b64 = b.astype(np.float64)
    d = (
        np.sum(a64 * a64, axis=1)[:, None]
        - 2.0 * (a64 @ b64.T)
        + np.sum(b64 * b64, axis=1)[None, :]
    )
    d = d.astype(np.float32)
    np.maximum(d, 0.0, out=d)
    return d


def kmeanspp_sklearn(
    x: np.ndarray,
    k: int,
    random_state: np.random.RandomState,
    n_local_trials: Optional[int] = None,
    sample_weight: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Greedy k-means++ init consuming `random_state` exactly like sklearn's
    `_kmeans_plusplus`: `choice(n, p=w/sum)` then, per remaining center,
    `uniform(size=n_local_trials)` scaled by the current potential and
    mapped through the cumulative distance mass."""
    n = x.shape[0]
    if sample_weight is None:
        sample_weight = np.ones(n, dtype=x.dtype)
    if n_local_trials is None:
        n_local_trials = 2 + int(np.log(k))

    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    center_id = random_state.choice(n, p=sample_weight / sample_weight.sum())
    centers[0] = x[center_id]

    closest = _eucl_sq_upcast(centers[0:1], x)[0]  # (N,)
    current_pot = closest @ sample_weight
    for c in range(1, k):
        rand_vals = random_state.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(
            np.cumsum(sample_weight * closest), rand_vals
        )
        np.clip(candidate_ids, None, closest.size - 1, out=candidate_ids)
        dist_to_cand = _eucl_sq_upcast(x[candidate_ids], x)  # (T, N)
        np.minimum(closest, dist_to_cand, out=dist_to_cand)
        cand_pot = dist_to_cand @ sample_weight.reshape(-1, 1)
        best = int(np.argmin(cand_pot))
        current_pot = cand_pot[best]
        closest = dist_to_cand[best]
        centers[c] = x[candidate_ids[best]]
    return centers


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Lloyd E-step the way sklearn's chunked dense kernel computes it:
    argmin of `||c||^2 - 2 x.c` in the data dtype (no upcast)."""
    c_sq = np.sum(centers * centers, axis=1)
    d = c_sq[None, :] - 2.0 * (x @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_sklearn(x, sample_weight, centers_init, max_iter, tol):
    """Mirror of `_kmeans_single_lloyd` + `_relocate_empty_clusters_dense`."""
    n, d = x.shape
    k = centers_init.shape[0]
    centers = centers_init.copy()
    labels_old = np.full(n, -1, np.int32)
    strict = False
    labels = labels_old
    i = 0
    for i in range(max_iter):
        labels = _assign(x, centers)
        one_hot_w = np.zeros((k,), x.dtype)
        np.add.at(one_hot_w, labels, sample_weight)
        sums = np.zeros((k, d), x.dtype)
        np.add.at(sums, labels, x * sample_weight[:, None])

        # empty-cluster relocation on the SUMS (sklearn order): move the
        # n_empty farthest-from-their-center points, one per empty cluster;
        # labels are NOT rewritten
        empty = np.where(one_hot_w == 0)[0]
        if empty.size:
            dist_own = np.sum((x - centers[labels]) ** 2, axis=1)
            if np.max(dist_own) > 0:
                far = np.argpartition(dist_own, -empty.size)[: -empty.size - 1 : -1]
                for idx in range(empty.size):
                    far_idx = far[idx]
                    w = sample_weight[far_idx]
                    old = labels[far_idx]
                    sums[old] -= x[far_idx] * w
                    sums[empty[idx]] = x[far_idx] * w
                    one_hot_w[empty[idx]] = w
                    one_hot_w[old] -= w

        centers_new = sums / np.maximum(one_hot_w, np.finfo(x.dtype).tiny)[:, None]
        center_shift_tot = np.sum((centers_new - centers) ** 2)
        centers = centers_new

        if np.array_equal(labels, labels_old):
            strict = True
            break
        if center_shift_tot <= tol:
            break
        labels_old = labels

    if not strict:
        labels = _assign(x, centers)
    inertia = float(np.sum(np.sum((x - centers[labels]) ** 2, axis=1) * sample_weight))
    return labels, inertia, centers, i + 1


def _is_same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """Same partition up to label permutation (sklearn's check that keeps
    the first of two inertia-equal-but-identical clusterings)."""
    mapping = np.full(k, -1, np.int64)
    for i in range(a.shape[0]):
        if mapping[a[i]] == -1:
            mapping[a[i]] = b[i]
        elif mapping[a[i]] != b[i]:
            return False
    return True


def kmeans_fit_sklearn(
    x: np.ndarray,
    k: int,
    n_init: int = 10,
    random_state: Union[int, np.random.RandomState] = 0,
    max_iter: int = 300,
    tol: float = 1e-4,
) -> KMeansResult:
    """Fit k-means with sklearn-identical results for a given seed:
    `kmeans_fit_sklearn(x, k, n_init, s)` produces the same labels, centers,
    inertia and n_iter as `sklearn.KMeans(k, n_init=n_init, random_state=s,
    algorithm="lloyd").fit(x)` on float32 data."""
    rs = (
        random_state
        if isinstance(random_state, np.random.RandomState)
        else np.random.RandomState(random_state)
    )
    x = np.array(x, np.float32, copy=True)
    x_mean = x.mean(axis=0)
    x -= x_mean
    tol_scaled = float(np.mean(np.var(x, axis=0)) * tol) if tol else 0.0
    sample_weight = np.ones(x.shape[0], dtype=x.dtype)

    best = None
    for _ in range(n_init):
        centers_init = kmeanspp_sklearn(x, k, rs, sample_weight=sample_weight)
        labels, inertia, centers, n_iter = _lloyd_sklearn(
            x, sample_weight, centers_init, max_iter, tol_scaled
        )
        if best is None or (
            inertia < best[1] and not _is_same_clustering(labels, best[0], k)
        ):
            best = (labels, inertia, centers, n_iter)

    labels, inertia, centers, n_iter = best
    return KMeansResult(
        centers=centers + x_mean,
        labels=labels.astype(np.int64),
        inertia=np.float32(inertia),
        n_iter=np.int32(n_iter),
    )
