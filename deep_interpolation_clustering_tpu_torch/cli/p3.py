"""p3 — DEC joint fine-tuning (counterpart of the JAX `cli/p3.py`, reference
p3_clustering_main.py:107-147): k-means centre init from the p1 latents,
joint training with the KL loss and label-delta stopping, then feature
dumps for the metrics loss, ae_mse and delta over all three cohorts.

    python -m deep_interpolation_clustering_tpu_torch.cli.p3 [--pretrain_path DIR] [--<Config field> VALUE ...]

`--pretrain_path` is the p1 run directory (default `{results_path}/Pretrain`);
without `--loss` or `--config` the loss is `ae_mse_sup_fake_detect_kl`.
Runs on the card; from Python, `main(argv, device="cpu")` runs on the CPU.
`--data_parallel` and `--num_processes` as in p1.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence, Union

import torch

from ..info import COHORTS, METRICS
from ..train import ClusterTrainer
from ..utils.logging import logger
from .common import build_parser, config_from_args, init_run, make_datasets, run_stage


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None,
         backend: Optional[str] = None) -> str:
    """Run p3; returns the run directory. `backend="gloo"` lets data-parallel
    ranks share a card."""
    parser = build_parser(__doc__)
    parser.add_argument("--pretrain_path", default=None,
                        help="p1 run dir (default {results_path}/Pretrain)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if args.loss is None and not args.config:
        cfg = cfg.replace(loss="ae_mse_sup_fake_detect_kl")  # the p3 default (p3:82)
    pretrain_path = args.pretrain_path or os.path.join(cfg.results_path, "Pretrain")
    return run_stage(functools.partial(_run, pretrain_path=pretrain_path), cfg, device,
                     backend)


def _run(cfg, device: torch.device, pretrain_path: str) -> str:
    exp_path = init_run(cfg, "Clustering")
    trainer = ClusterTrainer(cfg, make_datasets(cfg), exp_path,
                             pretrain_exp_path=pretrain_path, device=device)
    try:
        if cfg.mode == "train":
            trainer.train()
        for metric in METRICS:  # reference p3:140-143 dumps all three
            for cohort in COHORTS:
                trainer.eval(cohort, generate_feat=True, viz_feat=True, metric=metric)
    finally:
        trainer.close()
    logger.info("p3 done: %s", exp_path)
    return exp_path


if __name__ == "__main__":
    main()
