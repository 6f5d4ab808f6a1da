"""p1 — interpolation-autoencoder pretraining (counterpart of the JAX
`cli/p1.py`, reference p1_pretrain_main.py:103-151): build the model and
the cohorts from the p0 pickles, train with per-metric best checkpoints and
early stop, then dump per-encounter features for the metrics loss and
ae_mse over all three cohorts.

    python -m deep_interpolation_clustering_tpu_torch.cli.p1 [--<Config field> VALUE ...]

Runs on the card; from Python, `main(argv, device="cpu")` runs on the CPU.
`--data_parallel N` trains data-parallel over N local ranks (one card each;
-1 every visible card), `--num_processes P --process_id i
--coordinator_address host:port` (or torchrun's env:// without an address)
as one rank of P processes; rank 0 writes (`common.run_stage`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..info import COHORTS
from ..train import Trainer
from ..utils.logging import logger
from .common import build_parser, config_from_args, init_run, make_datasets, run_stage

PRETRAIN_FEAT_METRICS = ("loss", "ae_mse")  # reference p1:143


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None,
         backend: Optional[str] = None) -> str:
    """Run p1; returns the run directory. `backend="gloo"` lets data-parallel
    ranks share a card."""
    cfg = config_from_args(build_parser(__doc__).parse_args(argv))
    return run_stage(_run, cfg, device, backend)


def _run(cfg, device: torch.device) -> str:
    exp_path = init_run(cfg, "Pretrain")
    trainer = Trainer(cfg, make_datasets(cfg), exp_path, device=device)
    try:
        if cfg.mode == "train":
            trainer.train()
        for metric in PRETRAIN_FEAT_METRICS:
            for cohort in COHORTS:
                trainer.eval(cohort, generate_feat=True, viz_feat=True, metric=metric)
    finally:
        trainer.close()
    logger.info("p1 done: %s", exp_path)
    return exp_path


if __name__ == "__main__":
    main()
