"""p2 — optimal-K selection (counterpart of the JAX `cli/p2.py`, reference
p2_clustering_optK.py:45-88, 413-420): for each restore metric, read the
latent dumps of a run and explore K with k-means (elbow and gap statistic),
DBSCAN (k-distance graph and eps sweep) or OPTICS; tables and plots go to
`{results_path}/{stage}/opt_k/{metric}/plot/`.

    python -m deep_interpolation_clustering_tpu_torch.cli.p2 [--stage Pretrain|Clustering] [--restore_metrics M ...] [--cluster_algo kmeans|dbscan|optics] [--<Config field> VALUE ...]

Runs on the card; from Python, `main(argv, device="cpu")` runs on the CPU.
OPTICS runs scikit-learn on the host and needs it installed. Under
`--data_parallel N` (N > 1) N ranks are spawned, one device each (the CPU
with gloo when `device="cpu"`), every rank loads the dumps and keeps its
contiguous block of each cohort's rows on its device, and the k-means sweeps
run row-sharded over them (`cluster.optk.KSelection(shard=True)`, JAX
`cluster/optk.py:130-146`); an array whose rows N does not divide stays
whole on every rank, with a warning, as in JAX. DBSCAN and OPTICS run whole
on every rank. Under `--num_processes P` every process computes the same
tables on its own card (row-sharded too when `--data_parallel` is set). In
every case rank 0 alone writes.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Sequence, Union

import torch

from ..cluster import DbscanExplorer, KSelection, OpticsExplorer, load_feature_dumps
from ..utils.logging import logger
from .common import build_parser, config_from_args, run_stage


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None,
         backend: Optional[str] = None) -> Dict[str, Dict]:
    """Run p2; returns {metric: what the chosen explorer returned} (for
    dbscan, {"k_distance": ..., "eps_sweep": [...]}). `backend="gloo"` lets
    data-parallel ranks share a card."""
    parser = build_parser(__doc__)
    parser.add_argument("--stage", default="Pretrain", choices=["Pretrain", "Clustering"])
    parser.add_argument("--restore_metrics", nargs="+", default=["ae_mse", "loss"])
    parser.add_argument("--cluster_algo", default="kmeans",
                        choices=["kmeans", "dbscan", "optics"])
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    return run_stage(functools.partial(_run, args=args), cfg, device, backend,
                     data_parallel=cfg.data_parallel != 0)


def _run(cfg, dev: torch.device, args) -> Dict[str, Dict]:
    exp_path = os.path.join(cfg.results_path, args.stage)
    results = {}
    for metric in args.restore_metrics:
        data = load_feature_dumps(os.path.join(exp_path, "out_feat", metric))
        out_path = os.path.join(exp_path, "opt_k", metric)
        train_h = data["training"]["hidden"]
        if args.cluster_algo == "kmeans":
            out = KSelection(cfg, out_path, device=dev,
                             shard=cfg.data_parallel != 0).select_opt_k(
                train_h, data["validation"]["hidden"], seed=cfg.seed)
            for method, r in out.items():
                logger.info("[%s] %s -> %s", metric, method,
                            {k: v for k, v in r.items()
                             if k.startswith("opt_k") or k.startswith("elbow")})
        elif args.cluster_algo == "dbscan":
            ex = DbscanExplorer(cfg, out_path, device=dev)
            kd = ex.k_distance_graph(train_h)
            logger.info("[%s] dbscan knee eps: %s", metric, kd["knee_eps"])
            out = {"k_distance": kd, "eps_sweep": ex.eps_sweep(train_h)}
        else:
            out = OpticsExplorer(cfg, out_path).run(train_h)
        results[metric] = out
    logger.info("p2 done")
    return results


if __name__ == "__main__":
    main()
