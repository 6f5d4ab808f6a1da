"""Shared CLI plumbing (counterpart of the JAX `cli/common.py`): a flag for
every `Config` field (dict- and tuple-valued fields take JSON), `--config`
to reload a saved `config.json` with the flags given winning, the p0
pickles' I/O and the run directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import random
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..data import ArrayDataset
from ..info import COHORTS
from ..utils.logging import logger


def _str2bool(v: str) -> bool:
    s = str(v).lower()
    if s in ("1", "true", "yes", "y"):
        return True
    if s in ("0", "false", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def build_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--config", default=None, help="path to a saved config.json")
    for f in dataclasses.fields(Config):
        flag = f"--{f.name}"
        default = f.default
        if f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        if isinstance(default, bool):
            p.add_argument(flag, type=_str2bool, default=None, metavar="BOOL")
        elif isinstance(default, (int, float)):
            p.add_argument(flag, type=type(default), default=None)
        elif isinstance(default, (dict, tuple)):
            p.add_argument(flag, type=str, default=None, help="JSON value")
        else:
            p.add_argument(flag, type=str, default=None)
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    overrides = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is None:
            continue
        if f.default_factory is not dataclasses.MISSING:
            v = json.loads(v)
        elif isinstance(f.default, tuple):
            v = tuple(json.loads(v))
        overrides[f.name] = v
    if args.config:
        return Config.load(args.config, **overrides)
    return Config(**overrides)


# ------------------------------------------------------------- data io
def processed_dir(cfg: Config) -> str:
    return os.path.join(cfg.base_path, "model_data", "split_processed")


def save_processed(cfg: Config, splits: Dict[str, Dict[str, np.ndarray]]) -> None:
    """Write `{cohort}.pickle` as the p0 stage of either package does."""
    d = processed_dir(cfg)
    os.makedirs(d, exist_ok=True)
    for cohort, data in splits.items():
        path = os.path.join(d, f"{cohort}.pickle")
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        logger.info("wrote %s (%d encounters)", path, len(data["encounter_id"]))


def load_processed(cfg: Config) -> Dict[str, Dict[str, np.ndarray]]:
    """The p0 pickles (written by this repo's p0 stages)."""
    d = processed_dir(cfg)
    out = {}
    for cohort in COHORTS:
        with open(os.path.join(d, f"{cohort}.pickle"), "rb") as f:
            out[cohort] = pickle.load(f)
    return out


def make_datasets(cfg: Config) -> Dict[str, ArrayDataset]:
    return {c: ArrayDataset(cfg, d, c) for c, d in load_processed(cfg).items()}


def init_run(cfg: Config, stage: str) -> str:
    """Seed the host's generators, make `{results_path}/{stage}` and write
    its `config.json`; returns the run directory."""
    logger.info("The global seed: %s", cfg.seed)
    np.random.seed(cfg.seed)
    random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    exp_path = os.path.join(cfg.results_path, stage)
    os.makedirs(exp_path, exist_ok=True)
    cfg.save(exp_path)
    logger.info("run dir: %s", exp_path)
    return exp_path
