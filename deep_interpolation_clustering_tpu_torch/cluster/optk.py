"""p2 K selection: elbow, gap statistic, DBSCAN and OPTICS explorers
(counterpart of the JAX `cluster/optk.py`, reference
p2_clustering_optK.py:45-420).

The k-means fits, distortions, both gap inertias and the internal indices
run on the latents' device (`cluster.kmeans`, `cluster.metrics`), and so
does the DBSCAN explorer (`cluster.dbscan`). OPTICS and
`dbscan_impl="sklearn"` stay scikit-learn on the host, as in JAX. The
outputs are JAX's: `elbow.csv`, `gap_sts_v{1,2}.csv` with its fingerprint
sidecar, the plots when matplotlib is installed, and the suggestions the
reference leaves to a human: the Kneedle elbow of the distortion curve and
the Tibshirani rule `min k : gap(k) >= gap(k+1) - s(k+1)`, with the
argmax-gap fallback.

Inputs: a host array (what `cli.p2` passes) is moved to the device given to
`KSelection` or `DbscanExplorer`; a tensor stays on its device. Under a
multi-process launch every rank computes the same tables and rank 0 alone
writes files (`parallel.is_main_process`). `KSelection(shard=True)` in a
group of D ranks (p2 under `--data_parallel N`, JAX `optk.py:130-146`)
row-shards the latents instead: rank r keeps rows [r*n/D, (r+1)*n/D) of
each array on its device, and the k-means fits, the distortions, the gap
inertias and the internal metrics run split by rows (`cluster.kmeans`,
`cluster.metrics`), each reference cohort drawn at the full shape and
sliced; an array whose rows D does not divide stays whole on every rank, as
in JAX, with a warning. The tables are one process's. Random draws:
  * every k-means fit gets a `torch.Generator` on its data's device, seeded
    from (seed, stream, k, b) by `np.random.SeedSequence` (a hash, not an
    arithmetic composition that could make a reference fit's seed equal
    the data fit's);
  * the uniform reference cohorts of a host input come from
    `np.random.RandomState(seed)` as JAX draws them, and its gap subsample
    from `RandomState(seed).choice`; so with the same fits the `ref` and
    `act` columns are JAX's. A tensor input's are drawn on its device.
"""

from __future__ import annotations

import csv
import hashlib
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import parallel
from ..config import Config
from ..info import LEGEND_INFO
from ..parallel import is_main_process
from ..utils.device import resolve_device
from ..utils.logging import logger
from .dbscan import fit_dbscan_impl
from .kmeans import kmeans_fit, mean_min_distance
from .kneedle import kneedle
from .metrics import (
    compute_internal_metrics,
    inertia_v1,
    inertia_v2,
    kth_neighbor_distance,
    silhouette_score,
)

# generator streams: disjoint by construction (_generator hashes them)
_REF, _DATA, _DRAW, _SUBSAMPLE, _ELBOW = range(5)

Device = Optional[Union[str, torch.device]]


def _generator(device, seed: int, *stream: int) -> torch.Generator:
    """A generator on `device` seeded from the tuple (seed, *stream)."""
    words = np.random.SeedSequence([seed, *stream]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(words[0]) << 32 | int(words[1]))


def _rows_f32(x):
    """A tensor stays on its device; anything else becomes float32 NumPy."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return np.asarray(x, np.float32)


def _on(x, device: torch.device) -> torch.Tensor:
    """A host array onto `device` (float32); a tensor stays where it is."""
    x = _rows_f32(x)
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, device=device)


def _read_gap_csv(path: str) -> List[Dict]:
    """Reload a previous gap sweep's table (k as int, everything else float)."""
    with open(path, newline="") as f:
        return [
            {k: (int(v) if k == "k" else float(v)) for k, v in row.items()}
            for row in csv.DictReader(f)
        ]


def _maybe_plot(fn):
    """Run a plotting closure if matplotlib is importable, on rank 0 only;
    never fatal. The style is a seaborn-whitegrid/poster look from plain
    matplotlib rcParams (the reference styles its p2 figures with seaborn,
    p2_clustering_optK.py:299-330)."""
    if not is_main_process():
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        style = {
            "axes.grid": True,
            "grid.color": "#b0b0b0",
            "grid.linewidth": 0.8,
            "axes.edgecolor": "#cccccc",
            "axes.facecolor": "white",
            "axes.axisbelow": True,
            "axes.spines.top": False,
            "axes.spines.right": False,
            "axes.prop_cycle": plt.cycler(color=plt.cm.tab10(np.linspace(0, 1, 10))),
            "lines.linewidth": 3,
            "lines.markersize": 9,
            "axes.labelsize": 22,
            "xtick.labelsize": 18,
            "ytick.labelsize": 18,
            "legend.fontsize": 18,
            "axes.titlesize": 24,
            "figure.autolayout": False,
        }
        with plt.rc_context(style):
            fn(plt)
    except Exception as e:  # a figure is optional output: log and go on
        logger.warning("plotting skipped: %s", e)


def _relabel_legend(ax):
    """Map legend labels through LEGEND_INFO as the reference does for every
    styled figure (p2_clustering_optK.py:316-319)."""
    leg = ax.get_legend()
    if leg is not None:
        for t in leg.get_texts():
            t.set_text(LEGEND_INFO.get(t.get_text(), t.get_text()))
    return leg


class KSelection:
    """k-means-based K selection (reference `KM`, p2:226-410), on the card
    unless `device="cpu"`; `shard=True` row-shards the latents over the
    ranks of the process group (the module docstring)."""

    def __init__(self, cfg: Config, out_path: str, device: Device = None,
                 shard: bool = False):
        self.cfg = cfg
        self.out_path = os.path.join(out_path, "plot")
        self.device = resolve_device(device)
        self.shard = shard and parallel.world_size() > 1
        if is_main_process():
            os.makedirs(self.out_path, exist_ok=True)

    def _put_rows(self, x, shard: Optional[bool] = None):
        """(this rank's rows of `x` on the device, whether they are a
        block of row-sharded data): the whole array unless sharding, or when
        the ranks do not divide its rows (JAX `_put_rows`). `shard` given:
        that decision, taken for an array of the same shape."""
        if self.shard if shard is None else shard:
            d = parallel.world_size()
            if len(x) % d == 0:
                n = len(x) // d
                if shard is None:
                    logger.info("%d rows row-sharded over %d ranks: %d a rank", len(x), d, n)
                return _on(x[parallel.rank() * n:(parallel.rank() + 1) * n], self.device), True
            logger.warning("%d rows not divisible by %d ranks: running unsharded",
                           len(x), d)
        return _on(x, self.device), False

    # ------------------------------------------------------------ elbow
    def elbow(self, train_feat, valid_feat, seed: int = 0, plot: bool = True) -> Dict:
        """Distortion (mean min distance to a centre) for K=2..k_max on train
        and valid (reference p2:254-274), plus the Kneedle elbow."""
        ks = list(range(2, self.cfg.k_max + 1))
        train, train_sh = self._put_rows(train_feat)
        valid, valid_sh = self._put_rows(valid_feat)
        train_d, valid_d = [], []
        for k in ks:
            logger.info("elbow: running K=%d", k)
            result = kmeans_fit(_generator(train.device, seed, _ELBOW, k), train, k,
                                n_init=self.cfg.n_init, sharded=train_sh)
            centers = torch.as_tensor(result.centers, device=train.device)
            train_d.append(float(mean_min_distance(centers, train, train_sh)))
            valid_d.append(float(mean_min_distance(centers, valid, valid_sh)))
        knee = kneedle(np.array(ks), np.array(train_d), "convex", "decreasing")
        out = {"k": ks, "train": train_d, "valid": valid_d, "elbow_k": knee}
        if is_main_process():
            with open(os.path.join(self.out_path, "elbow.csv"), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["k", "train_distortion", "valid_distortion"])
                w.writerows(zip(ks, train_d, valid_d))
        if plot:
            def draw(plt):
                for cohort, d in (("train", train_d), ("valid", valid_d)):
                    plt.figure()
                    plt.plot(ks, d, "bx-")
                    plt.xlabel("Cluster Count", fontsize=18)
                    plt.ylabel("Distortion", fontsize=18)
                    plt.title("The Elbow method showing the optimal k", fontsize=20)
                    plt.savefig(os.path.join(self.out_path, f"{cohort}_elbow.png"))
                    plt.close()
            _maybe_plot(draw)
        return out

    # ----------------------------------------------------- gap statistic
    def gap_statistic(self, data, version: int = 1, seed: int = 0,
                      internal_metric_names: Optional[Sequence[str]] = None,
                      plot: bool = True) -> Dict:
        """Gap = E[log W_ref] - log W_act over `gap_b` uniform reference
        draws spanning the data's global scalar range (reference
        p2:353-410). `version` selects the inertia (1: mean of the clusters'
        mean pairwise distances; 2: Tibshirani's sum D_r/(2 n_r))."""
        cfg = self.cfg
        names = list(internal_metric_names or cfg.internal_metrics)
        csv_path = os.path.join(self.out_path, f"gap_sts_v{version}.csv")
        data = _rows_f32(data)
        on_device = isinstance(data, torch.Tensor)
        fp = self._gap_fingerprint(data, version, seed, names)
        if os.path.exists(csv_path) and not cfg.overwrite:
            # reuse the previous sweep's table (reference p2:281-287) only
            # if the sidecar ties it to these latents and this sweep config
            rows = self._reload_gap_csv(csv_path, fp)
            if rows is not None:
                logger.info("loading previous %s (overwrite=False)", csv_path)
                return self._gap_summary(rows, names, csv_path, plot, write_csv=False)
        inertia = inertia_v1 if version == 1 else inertia_v2
        # opt-in seeded uniform subsample, drawn once for the whole sweep;
        # its size is in the fingerprint, so cached tables never mix regimes
        if cfg.gap_subsample and data.shape[0] > cfg.gap_subsample:
            logger.info("gap subsample: %d of %d rows (seeded uniform)",
                        cfg.gap_subsample, data.shape[0])
            if on_device:
                sel = torch.randperm(data.shape[0], device=data.device,
                                     generator=_generator(data.device, seed, _SUBSAMPLE))
                data = data[torch.sort(sel[: cfg.gap_subsample]).values]
            else:
                sel = np.random.RandomState(seed).choice(data.shape[0], cfg.gap_subsample,
                                                         replace=False)
                data = data[np.sort(sel)]
        # invalidate first: a crash before the new fingerprint is written
        # leaves a table without one, which the next run recomputes
        if is_main_process():
            try:
                os.remove(csv_path + ".fp")
            except FileNotFoundError:
                pass
        if on_device:
            lo, rng_width = torch.stack([data.min(), data.max() - data.min()]).tolist()
        else:
            lo, rng_width = float(data.min()), float(data.max() - data.min())
        data_dev, sharded = self._put_rows(data)
        rng = np.random.RandomState(seed)
        rows: List[Dict] = []
        for k in range(2, cfg.k_max + 1):
            logs = []
            for b in range(cfg.gap_b):
                # drawn at the full shape on every rank, then this rank's rows
                if on_device:
                    draw = _generator(data.device, seed, _DRAW, k, b)
                    ref = torch.rand(data.shape, generator=draw, device=data.device) \
                        * rng_width + lo
                else:
                    ref = rng.random_sample(data.shape).astype(np.float32) * rng_width + lo
                ref, _ = self._put_rows(ref, sharded)
                r = kmeans_fit(_generator(ref.device, seed, _REF, k, b), ref, k,
                               n_init=cfg.n_init, sharded=sharded)
                logs.append(np.log(float(inertia(ref, r.labels, k, sharded=sharded))))
            ref_mean, ref_std = float(np.mean(logs)), float(np.std(logs))
            ref_s = float(np.sqrt(1 + 1 / cfg.gap_b) * ref_std)
            r = kmeans_fit(_generator(data_dev.device, seed, _DATA, k), data_dev, k,
                           n_init=cfg.n_init, sharded=sharded)
            act = float(np.log(float(inertia(data_dev, r.labels, k, sharded=sharded))))
            row = {"k": k, "gap": ref_mean - act, "ref": ref_mean, "act": act, "ref_s": ref_s}
            row.update(compute_internal_metrics(names, data_dev, r.labels, k, sharded))
            logger.info("k: %d, gap: %.4f, ref: %.4f, act: %.4f, ref_s: %.4f",
                        k, row["gap"], ref_mean, act, ref_s)
            rows.append(row)
        out = self._gap_summary(rows, names, csv_path, plot)
        if is_main_process():
            with open(csv_path + ".fp", "w") as f:
                f.write(fp)
        return out

    def _gap_fingerprint(self, data, version: int, seed: int, names: Sequence[str]) -> str:
        """Content hash of everything that determines the gap table: the
        latents and every sweep parameter. A host array hashes its bytes
        (as the JAX package does, so a table JAX wrote reloads here); a
        tensor hashes per-dimension sums and squared sums and the extrema,
        computed on its device, not its bytes fetched to the host."""
        h = hashlib.blake2b(digest_size=16)
        if isinstance(data, torch.Tensor):
            digest = torch.cat([torch.sum(data, dim=0), torch.sum(data * data, dim=0),
                                torch.stack([data.min(), data.max()])])
            h.update(b"device-moments-v1")
            h.update(digest.cpu().numpy().tobytes())
        else:
            h.update(np.ascontiguousarray(data).tobytes())
        h.update(repr((tuple(data.shape), version, seed, tuple(names), self.cfg.k_max,
                       self.cfg.n_init, self.cfg.gap_b, self.cfg.gap_subsample)).encode())
        return h.hexdigest()

    def _reload_gap_csv(self, csv_path: str, fp: str) -> Optional[List[Dict]]:
        """The table iff the sidecar fingerprint matches and the table parses
        to at least one row; otherwise log why and return None (recompute)."""
        try:
            with open(csv_path + ".fp") as f:
                saved = f.read().strip()
        except OSError:
            saved = None
        if saved != fp:
            logger.warning(
                "existing %s %s the current data/config — recomputing "
                "(pass --overwrite to silence this path entirely)",
                csv_path,
                "has no fingerprint sidecar for" if saved is None else "does not match",
            )
            return None
        try:
            rows = _read_gap_csv(csv_path)
        except (ValueError, KeyError, OSError) as e:
            logger.warning("failed to reload %s (%s) — recomputing", csv_path, e)
            return None
        if not rows:
            logger.warning("%s is empty — recomputing", csv_path)
            return None
        return rows

    def _gap_summary(self, rows: List[Dict], names: Sequence[str], csv_path: str,
                     plot: bool, write_csv: bool = True) -> Dict:
        """Tibshirani rule + CSV + plots over a gap table (fresh or reloaded)."""
        ks = [r["k"] for r in rows]
        # a reloaded CSV may predate a change in the configured metrics
        names = [n for n in names if n in rows[0]]
        # Tibshirani: smallest k with gap(k) >= gap(k+1) - s(k+1); when the
        # gap rises monotonically it never fires, and the argmax is the
        # fallback suggestion
        opt_k = None
        for i in range(len(rows) - 1):
            if rows[i]["gap"] >= rows[i + 1]["gap"] - rows[i + 1]["ref_s"]:
                opt_k = rows[i]["k"]
                break
        opt_k_argmax = max(rows, key=lambda r: r["gap"])["k"]

        if write_csv and is_main_process():
            # atomic: a process killed mid-write leaves no partial table
            tmp = csv_path + ".tmp"
            with open(tmp, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
                w.writeheader()
                w.writerows(rows)
            os.replace(tmp, csv_path)
        version = os.path.basename(csv_path).rsplit("_v", 1)[-1].split(".")[0]
        if plot:
            def draw(plt):
                xticks = list(range(0, self.cfg.k_max + 1, 2))
                # figure 1: the gap with the Tibshirani s_k error bars
                # (reference gap_statistic-1, p2:304-309)
                fig, ax = plt.subplots(figsize=(12, 8))
                ax.errorbar(ks, [r["gap"] for r in rows], yerr=[r["ref_s"] for r in rows],
                            marker="o", capsize=4, label="gap")
                ax.legend(loc="best")
                _relabel_legend(ax)
                ax.set_xlabel("Number of clusters K")
                ax.set_ylabel(LEGEND_INFO.get("gap", "gap"))
                ax.set_xticks(xticks)
                fig.savefig(os.path.join(self.out_path, f"gap_statistic-1_v{version}.png"),
                            bbox_inches="tight")
                plt.close(fig)
                # figure 2: gap, ref and act, legend outside the axes
                # (reference gap_statistic-2, p2:310-330)
                fig, ax = plt.subplots(figsize=(12, 8))
                markers = {"gap": "o", "ref": "s", "act": "^"}
                for key in ("gap", "ref", "act"):
                    ax.plot(ks, [r[key] for r in rows], marker=markers[key], label=key)
                ax.legend(loc=2, ncol=1, borderaxespad=0.0, bbox_to_anchor=(1.02, 1))
                leg = _relabel_legend(ax)
                ax.set_xlabel("Number of clusters K")
                ax.set_ylabel(LEGEND_INFO.get("log(inertia)", "log(inertia)"))
                ax.set_xticks(xticks)
                fig.savefig(os.path.join(self.out_path, f"gap_statistic-2_v{version}.png"),
                            bbox_extra_artists=(leg,) if leg else None, bbox_inches="tight")
                plt.close(fig)
                # the internal validity metrics per K, a panel each
                if names:
                    fig, axes = plt.subplots(1, len(names), figsize=(6 * len(names), 5),
                                             squeeze=False)
                    for ax, name in zip(axes[0], names):
                        ax.plot(ks, [r[name] for r in rows], marker="o")
                        ax.set_xlabel("Number of clusters K")
                        ax.set_ylabel(name)
                    fig.tight_layout()
                    fig.savefig(os.path.join(self.out_path,
                                             f"internal_metrics_v{version}.png"))
                    plt.close(fig)
            _maybe_plot(draw)
        return {"rows": rows, "opt_k": opt_k, "opt_k_argmax": opt_k_argmax, "csv": csv_path}

    def select_opt_k(self, train_feat, valid_feat, seed: int = 0) -> Dict:
        """Dispatch over the configured methods (reference Cluster.select_opt_k)."""
        out = {}
        for method in self.cfg.select_opt_k:
            if method == "elbow":
                out["elbow"] = self.elbow(train_feat, valid_feat, seed)
            elif method == "gap_sts":
                out["gap_sts"] = self.gap_statistic(train_feat, version=1, seed=seed)
            else:
                raise ValueError(f"unknown K-selection method {method!r}")
        return out


# --------------------------------------------------- density explorers
def _derive_min_samples(explicit: Optional[int], feat) -> int:
    """None -> feat_dim + 1, the reference's choice for both density
    explorers (p2_clustering_optK.py:84,87)."""
    return explicit if explicit else feat.shape[-1] + 1


def dbscan_quality(feat, labels) -> Dict:
    """Cluster and noise counts of DBSCAN labels, and the silhouette with
    and without the noise points: the pair the reference logs in the p2 eps
    sweep (p2_clustering_optK.py:148-166) and for the p4 dbscan labels
    (p4_clustering_final.py:209-233). Noise (-1) is its own cluster in the
    with-noise score, as sklearn's silhouette treats it. The scores run as
    the blocked sweep of `metrics.silhouette_score` on `feat`'s device."""
    labels = np.asarray(labels)
    n_clusters = len(set(labels.tolist())) - (1 if -1 in labels else 0)
    row: Dict = {"n_clusters": n_clusters, "n_noise": int(np.sum(labels == -1))}
    mask = labels != -1
    if n_clusters >= 2:
        x = torch.as_tensor(feat, dtype=torch.float32)
        row["silhouette_with_noise"] = _device_silhouette(x, labels)
        if mask.sum() and len(set(labels[mask].tolist())) >= 2:
            row["silhouette_wo_noise"] = _device_silhouette(
                x[torch.as_tensor(mask, device=x.device)], labels[mask])
    return row


def _device_silhouette(x: torch.Tensor, labels: np.ndarray) -> float:
    """Silhouette over arbitrary label values (noise -1 included): densify,
    score on `x`'s device."""
    uniq, dense = np.unique(labels, return_inverse=True)
    return float(silhouette_score(x, dense, int(len(uniq))))


class DbscanExplorer:
    """k-distance graph and eps sweep (reference `Dbscan`, p2:90-168), on
    the card unless `device="cpu"`; the eps knee by Kneedle."""

    def __init__(self, cfg: Config, out_path: str, min_samples: Optional[int] = None,
                 device: Device = None):
        self.cfg = cfg
        self.min_samples = min_samples  # None -> feat_dim + 1 per fit
        self.out_path = os.path.join(out_path, "plot")
        self.device = resolve_device(device)
        if is_main_process():
            os.makedirs(self.out_path, exist_ok=True)

    def _min_samples(self, feat) -> int:
        return _derive_min_samples(self.min_samples, feat)

    def k_distance_graph(self, feat, plot: bool = True) -> Dict:
        x = _on(feat, self.device)
        k = self._min_samples(x) - 1
        # sklearn's kneighbors(k) columns are [self, nn1, ..., nn_{k-1}], so
        # the reference's dist[:, -1] is the (k-1)-th TRUE neighbour; the
        # sweep excludes self, hence k - 1 (p2:97-107)
        if k - 1 > len(x) - 1:
            # min_samples = feat_dim + 1 exceeds the cohort: the reference
            # crashes here ("n_neighbors <= n_samples"); clamp to the
            # farthest existing neighbour
            logger.warning("k-distance: %d neighbors requested but only %d rows; "
                           "clamping to %d", k - 1, len(x), len(x) - 1)
            k = len(x)
        if k <= 1:
            kth = np.zeros(len(x), np.float32)  # degenerate: the self column
        else:
            kth = kth_neighbor_distance(x, k - 1).cpu().numpy()
        kth = np.sort(kth)
        idx = np.arange(len(kth))
        knee_x = kneedle(idx, kth, curve="convex", direction="increasing")
        knee_eps = float(kth[int(knee_x)]) if knee_x is not None else None
        if plot:
            def draw(plt):
                plt.figure()
                plt.plot(idx, kth)
                plt.xlabel("Points sorted by distance")
                plt.ylabel(f"{k}-NN distance")
                plt.savefig(os.path.join(self.out_path, "k_distance_graph.png"))
                plt.close()
            _maybe_plot(draw)
        return {"kth_distances": kth, "knee_eps": knee_eps}

    def eps_sweep(self, feat, eps_values: Optional[Sequence[float]] = None) -> List[Dict]:
        x = _on(feat, self.device)
        if eps_values is None:
            eps_values = np.arange(0.5, 5.0, 0.5)
        rows = []
        for eps in eps_values:
            labels, _ = fit_dbscan_impl(self.cfg, x, float(eps), self._min_samples(x))
            row = {"eps": float(eps)}
            row.update(dbscan_quality(x, labels))
            rows.append(row)
            logger.info("dbscan eps sweep: %s", row)
        return rows


class OpticsExplorer:
    """OPTICS reachability (reference `Optics`, p2:171-223): scikit-learn on
    the host, as in JAX; without scikit-learn it raises."""

    def __init__(self, cfg: Config, out_path: str, min_samples: Optional[int] = None):
        self.cfg = cfg
        self.min_samples = min_samples  # None -> feat_dim + 1 per fit
        self.out_path = os.path.join(out_path, "plot")
        if is_main_process():
            os.makedirs(self.out_path, exist_ok=True)

    def _min_samples(self, feat) -> int:
        return _derive_min_samples(self.min_samples, feat)

    def run(self, feat, method: str = "xi", plot: bool = True) -> Dict:
        try:
            from sklearn.cluster import OPTICS
        except ImportError as e:
            raise ImportError("the OPTICS explorer runs scikit-learn's OPTICS on the host "
                              "and scikit-learn is not installed") from e
        if isinstance(feat, torch.Tensor):
            feat = feat.cpu().numpy()
        kwargs = ({"cluster_method": "xi", "xi": 0.05} if method == "xi"
                  else {"cluster_method": "dbscan", "eps": self.cfg.opt_eps})
        model = OPTICS(min_samples=self._min_samples(feat), **kwargs).fit(feat)
        reach = model.reachability_[model.ordering_]
        if plot:
            def draw(plt):
                plt.figure()
                plt.plot(np.arange(len(reach)), reach)
                plt.ylabel("Reachability distance")
                plt.savefig(os.path.join(self.out_path, "optics_reachability.png"))
                plt.close()
            _maybe_plot(draw)
        return {"labels": model.labels_, "reachability": reach}
