"""p4 — final cluster labels (counterpart of the JAX `cli/p4.py`, reference
p4_clustering_final.py:141-309): label every cohort of a run's feature
dumps with `cluster_method` (kmeans, dbscan, dl or consensus) and write
`{cohort}_{K}.npy` dicts carrying `cluster_id` (`{cohort}_eps-{opt_eps}.npy`
for dbscan).

    python -m deep_interpolation_clustering_tpu_torch.cli.p4 [--stage Clustering|Pretrain] [--restore_metrics M ...] [--<Config field> VALUE ...]

Runs on the card; from Python, `main(argv, device="cpu")` runs on the CPU.
Under `--num_processes P` every process labels on its own card and rank 0
alone writes; `--data_parallel` has no effect here, as in the JAX p4.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..cluster import FinalLabeler
from ..utils.logging import logger
from .common import build_parser, config_from_args, run_stage


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None
         ) -> Dict[str, Dict[str, np.ndarray]]:
    """Run p4; returns {metric: {cohort: labels}}."""
    parser = build_parser(__doc__)
    parser.add_argument("--stage", default="Clustering", choices=["Pretrain", "Clustering"])
    parser.add_argument("--restore_metrics", nargs="+", default=["ae_mse", "loss", "delta"])
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    return run_stage(functools.partial(_run, args=args), cfg, device, data_parallel=False)


def _run(cfg, dev: torch.device, args) -> Dict[str, Dict[str, np.ndarray]]:
    exp_path = os.path.join(cfg.results_path, args.stage)
    results = FinalLabeler(cfg, exp_path, device=dev).pred(
        metrics=args.restore_metrics, seed=cfg.seed)
    for metric, cohorts in results.items():
        for cohort, labels in cohorts.items():
            logger.info("[%s] %s: %d samples, %d clusters",
                        metric, cohort, len(labels), len(set(labels.tolist()) - {-1}))
    logger.info("p4 done")
    return results


if __name__ == "__main__":
    main()
