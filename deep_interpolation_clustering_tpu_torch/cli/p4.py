"""p4 — final cluster labels (counterpart of the JAX `cli/p4.py`, reference
p4_clustering_final.py:141-309): label every cohort of a run's feature
dumps with `cluster_method` (kmeans, dbscan, dl or consensus) and write
`{cohort}_{K}.npy` dicts carrying `cluster_id` (`{cohort}_eps-{opt_eps}.npy`
for dbscan).

    python -m deep_interpolation_clustering_tpu_torch.cli.p4 [--stage Clustering|Pretrain] [--restore_metrics M ...] [--<Config field> VALUE ...]

Runs on the card; from Python, `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..cluster import FinalLabeler
from ..utils.logging import logger
from .common import build_parser, config_from_args, require_single_process


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None
         ) -> Dict[str, Dict[str, np.ndarray]]:
    """Run p4; returns {metric: {cohort: labels}}."""
    parser = build_parser(__doc__)
    parser.add_argument("--stage", default="Clustering", choices=["Pretrain", "Clustering"])
    parser.add_argument("--restore_metrics", nargs="+", default=["ae_mse", "loss", "delta"])
    args = parser.parse_args(argv)
    cfg = require_single_process(config_from_args(args))
    exp_path = os.path.join(cfg.results_path, args.stage)
    results = FinalLabeler(cfg, exp_path, device=device).pred(
        metrics=args.restore_metrics, seed=cfg.seed)
    for metric, cohorts in results.items():
        for cohort, labels in cohorts.items():
            logger.info("[%s] %s: %d samples, %d clusters",
                        metric, cohort, len(labels), len(set(labels.tolist()) - {-1}))
    logger.info("p4 done")
    return results


if __name__ == "__main__":
    main()
