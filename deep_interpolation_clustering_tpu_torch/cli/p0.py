"""p0 — offline preprocessing (counterpart of the JAX `cli/p0.py`, reference
p0_data_process.py:135-204): grid raw per-vital long-format data into dense
planes, mean-impute empty channels with training means, hold out 20% of
observations for the denoising-AE loss, and min-max normalize, then write
`{base_path}/model_data/split_processed/{cohort}.pickle`.

    python -m deep_interpolation_clustering_tpu_torch.cli.p0 --synthetic N [--<Config field> VALUE ...]
    python -m deep_interpolation_clustering_tpu_torch.cli.p0 --raw_dir DIR [...]

Two sources:
  * `--raw_dir DIR` — a directory with `encounter.csv`, `vitals.pickle`
    (dict vital -> long dataframe), `split_ids.pickle` (cohort -> id list),
    the reference's private-cohort format. Needs pandas.
  * `--synthetic N` — the synthetic cohort generator; needs no pandas.

Host work in NumPy, as in the JAX package. The processed pickles are reused
when their `p0.fp` sidecar matches the inputs and the config, and the
gridded raw slices (`split_org/`) when only the hold-out or normalization
changed; the fingerprints are the JAX package's, so either package's cache
is a hit for the other. With `--num_processes > 1` rank 0 alone writes.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

import numpy as np

from ..data import generate_data, make_synthetic_cohorts, process_splits
from ..data.abnormal import extract_abnormal_vitals
from ..info import COHORTS, USE_FEATURES
from ..utils.logging import logger
from .common import (
    build_parser,
    config_from_args,
    p0_cache_valid,
    p0_fingerprint,
    p0_invalidate,
    p0_load_raw,
    p0_raw_cache_valid,
    p0_raw_fingerprint,
    p0_save_raw,
    p0_write_fp,
    save_processed,
    set_seed,
)

AUX_CSV = "next_hour_abnormal_norm_val.csv"


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = build_parser(__doc__)
    parser.add_argument("--raw_dir", default=None)
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--synthetic_max_obs", type=int, default=48)
    parser.add_argument("--synthetic_phenotypes", type=int, default=4)
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    # host-side preprocessing with no collective: under a multi-process
    # launch one rank writes (concurrent writers on a shared filesystem
    # tear the pickles), the others return
    if cfg.num_processes > 1:
        if cfg.process_id < 0:
            parser.error(
                "p0 with --num_processes > 1 needs an explicit --process_id "
                "(it is host-side preprocessing: rank 0 writes, others skip; "
                "simplest is to run p0 once on one host before the launch)"
            )
        if cfg.process_id != 0:
            logger.info("p0: process %d skipping (rank 0 writes the pickles)",
                        cfg.process_id)
            return
    set_seed(cfg.seed)
    rng = np.random.RandomState(cfg.seed)

    if args.synthetic:
        sources = [("synthetic", args.synthetic, args.synthetic_max_obs,
                    args.synthetic_phenotypes)]
    elif args.raw_dir:
        sources = [os.path.join(args.raw_dir, n)
                   for n in ("encounter.csv", "vitals.pickle", "split_ids.pickle")]
    else:
        parser.error("one of --raw_dir or --synthetic is required")
    fp = p0_fingerprint(cfg, sources)
    # raw mode also writes the aux CSV; a cache hit must vouch for it too
    extra_outputs = [os.path.join(cfg.base_path, AUX_CSV)] if args.raw_dir else []
    if not cfg.overwrite and p0_cache_valid(cfg, fp, extra_outputs):
        logger.info("p0: split_processed pickles match the current inputs/config — "
                    "skipping recompute (pass --overwrite true to force)")
        return
    p0_invalidate(cfg)

    raw_sources = list(sources) + ([("seed", cfg.seed)] if args.synthetic else [])
    raw_fp = p0_raw_fingerprint(cfg, raw_sources)
    splits = None
    if not cfg.overwrite and p0_raw_cache_valid(cfg, raw_fp, extra_outputs):
        logger.info("p0: split_org raw slices match the current sources — skipping "
                    "the gridding stage")
        splits = p0_load_raw(cfg)

    if splits is None:
        if args.synthetic:
            splits = make_synthetic_cohorts(
                n_total=args.synthetic,
                hours=cfg.hours_from_admission,
                max_obs=args.synthetic_max_obs,
                n_phenotypes=args.synthetic_phenotypes,
                seed=cfg.seed,
            )
        else:
            splits = _grid_raw(cfg, args.raw_dir)
        p0_save_raw(cfg, splits, raw_fp)
    process_splits(splits, holdout_frac=cfg.holdout_frac, rng=rng,
                   norm_method=cfg.norm_method)
    save_processed(cfg, splits)
    p0_write_fp(cfg, fp)


def _grid_raw(cfg, raw_dir: str):
    """The raw path: the first `hours_from_admission` of each vital gridded
    per cohort, the hour-(h+1) abnormal-vital aux CSV, and the future-vital
    and outcome columns joined per cohort."""
    import pandas as pd

    encounter = pd.read_csv(os.path.join(raw_dir, "encounter.csv"))
    with open(os.path.join(raw_dir, "vitals.pickle"), "rb") as f:
        vital_24h = pickle.load(f)
    with open(os.path.join(raw_dir, "split_ids.pickle"), "rb") as f:
        split_ids = pickle.load(f)
    # the first `hours` only, as the reference (p0:27-28)
    vital_data = {k: df[df["time_stamp"] <= cfg.hours_from_admission]
                  for k, df in vital_24h.items()}
    splits = {cohort: generate_data(split_ids[cohort], vital_data) for cohort in COHORTS}
    # hour-(h+1) abnormal-vital aux targets (get_abnormal_vital.py:55-78)
    aux = extract_abnormal_vitals(vital_24h, encounter, cfg.hours_from_admission)
    aux_path = os.path.join(cfg.base_path, AUX_CSV)
    os.makedirs(cfg.base_path, exist_ok=True)
    aux.to_csv(aux_path, index=False)
    logger.info("wrote %s", aux_path)
    aux = aux.set_index("encounter_deiden_id")
    # binary outcome labels ride along from the encounter table when present
    # (reference dataloader.py:81-113 joins outcome CSVs)
    outcome_cols = [c for c in ("AKI_overall", "mort_status_30d", "ICU")
                    if c in encounter.columns]
    enc_idx = encounter.set_index("encounter_deiden_id")
    for cohort in COHORTS:
        ids = splits[cohort]["encounter_id"]
        fv = np.full((len(ids), len(USE_FEATURES)), np.nan)
        present = [i for i, e in enumerate(ids) if e in aux.index]
        fv[present] = aux.loc[[ids[i] for i in present], list(USE_FEATURES)].values
        splits[cohort]["future_vital"] = fv
        for col in outcome_cols:
            splits[cohort][col] = enc_idx[col].reindex(ids).fillna(0).to_numpy(np.float32)
    return splits


if __name__ == "__main__":
    main()
