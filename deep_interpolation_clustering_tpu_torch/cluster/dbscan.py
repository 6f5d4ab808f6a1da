"""DBSCAN on the latents' device (counterpart of the JAX `cluster/dbscan.py`;
the reference runs sklearn's on the host, p2_clustering_optK.py:109-168 and
p4_clustering_final.py:175-233):

  * core mask: one blocked pass counts |{j : d(i,j) <= eps}| (self
    included, sklearn's min_samples convention), a (block, N) slab of
    squared distances at a time (`metrics.sq_dist_slab`);
  * clusters: connected components of the core-core eps-graph by min-label
    propagation. Every core starts with its own index; each round takes the
    min label over its core neighbours (one blocked N^2 pass) and then jumps
    pointers (`new = min(new, new[new])`), which squares the reach, so the
    rounds grow with the log of a component's diameter. The loop ends after
    the first round that changes nothing: one host read a round, the JAX
    `while_loop`'s condition;
  * borders: a non-core point takes the min component label among its
    core neighbours; points with none are noise (-1).

The labels equal sklearn's exactly, not approximately: sklearn numbers its
clusters in the order its scan creates them, which is ascending minimum
core index, and a border point joins the earliest-created neighbouring
cluster, which is the min-label rule (the JAX module's docstring gives the
argument). The labels and the core mask are therefore the JAX package's
too; only a distance within float32 rounding of eps could tip a membership.
"""

from __future__ import annotations

import numpy as np
import torch

from .metrics import sq_dist_slab


def _dbscan_labels(x: torch.Tensor, eps: float, min_samples: int, block: int):
    """Component labels per row (a core's component is the min core index
    in it, a border's the min neighbouring component, noise -1) and the core
    mask, both on `x`'s device."""
    n = x.shape[0]
    x_sq = torch.sum(x * x, dim=1)
    eps32 = np.float32(eps)
    eps_sq = float(eps32 * eps32)  # squared in float32, as JAX squares it
    spans = [(start, min(start + block, n)) for start in range(0, n, block)]

    def neighbours(start, stop):
        """(block, N) eps-neighbourhood of rows start..stop."""
        return sq_dist_slab(x[start:stop], x, x_sq) <= eps_sq

    counts = torch.cat([torch.sum(neighbours(*span), dim=1) for span in spans])
    core = counts >= min_samples  # self counted through d(i, i) = 0
    sentinel = n

    def min_core_neighbour(labels, want):
        """Per row: the min label among its CORE eps-neighbours, or the
        sentinel where it has none or `want` is False."""
        out = []
        for start, stop in spans:
            m = neighbours(start, stop) & core[None, :]
            cand = torch.amin(torch.where(m, labels[None, :], sentinel), dim=1)
            out.append(torch.where(want[start:stop], cand, sentinel))
        return torch.cat(out)

    labels = torch.arange(n, dtype=torch.int32, device=x.device)
    while True:
        new = torch.minimum(labels, min_core_neighbour(labels, core))
        # pointer jumping: a label's label, squaring the reach
        new = torch.minimum(new, torch.index_select(new, 0, new))
        changed = bool(torch.any(new != labels))
        labels = new
        if not changed:
            break

    border = min_core_neighbour(labels, ~core)
    out = torch.where(core, labels, torch.where(border < sentinel, border, -1))
    return out, core


def dbscan_fit(x, eps: float, min_samples: int, block: int = 1024) -> tuple:
    """sklearn-identical DBSCAN on the device of `x` (an array runs on the
    CPU). Returns (labels, core_mask) as NumPy arrays; labels use sklearn's
    ids (consecutive ints in cluster-creation order, noise = -1)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    raw, core = _dbscan_labels(x, eps, min_samples, block)
    raw = raw.cpu().numpy()
    core = core.cpu().numpy()
    out = np.full(len(raw), -1, np.int64)
    clustered = raw >= 0
    if clustered.any():
        # component keys are min-core indices; ascending order IS sklearn's
        # cluster-creation order
        _, inv = np.unique(raw[clustered], return_inverse=True)
        out[clustered] = inv
    return out, core


def fit_dbscan_impl(cfg, x, eps: float, min_samples: int):
    """By `cfg.dbscan_impl`: "device" fits on the device of the tensor `x`;
    "sklearn" runs sklearn's DBSCAN on a host copy (the reference's path),
    which needs scikit-learn installed. Shared by the p2 eps sweep and the
    p4 dbscan labels."""
    if cfg.dbscan_impl == "sklearn":
        try:
            from sklearn.cluster import DBSCAN
        except ImportError as e:
            raise ImportError("dbscan_impl='sklearn' runs scikit-learn's DBSCAN on the "
                              "host and scikit-learn is not installed; "
                              "dbscan_impl='device' runs DBSCAN on the card") from e
        host = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        fit = DBSCAN(eps=eps, min_samples=min_samples).fit(host)
        labels = fit.labels_
        core = np.zeros(len(labels), bool)
        core[fit.core_sample_indices_] = True
        return labels, core
    if cfg.dbscan_impl != "device":
        raise ValueError(f"unknown dbscan_impl {cfg.dbscan_impl!r}")
    return dbscan_fit(x, eps, min_samples)
