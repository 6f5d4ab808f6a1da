"""Shared CLI plumbing (counterpart of the JAX `cli/common.py`): a flag for
every `Config` field (dict- and tuple-valued fields take JSON), `--config`
to reload a saved `config.json` with the flags given winning, the p0
pickles' I/O and caches, the run directory, and the ranks a stage runs as
(`run_stage`).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import pickle
import random
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from .. import parallel
from ..config import Config
from ..data import ArrayDataset
from ..info import COHORTS
from ..utils.device import resolve_device
from ..utils.logging import logger

Device = Optional[Union[str, torch.device]]


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


# -------------------------------------------------- p0 cache fingerprint
# The processed pickles are reused only when a content fingerprint of
# everything that determines them matches the `p0.fp` sidecar beside them:
# the raw input files' bytes (or the synthetic generator's parameters) and
# the preprocessing config. The hashes are the JAX package's, byte for
# byte, so a cache either package wrote is a hit for the other. The sidecar
# is removed before a rewrite and written after it: a crash in between
# recomputes on the next run.
def _hash_sources(source_items, tail) -> str:
    """blake2b-128 over the bytes of each item that is a file path, the
    `repr` of each other item, then `repr(tail)`."""
    h = hashlib.blake2b(digest_size=16)
    for item in source_items:
        if isinstance(item, str) and os.path.isfile(item):
            with open(item, "rb") as f:
                for chunk in iter(lambda: f.read(1 << 22), b""):
                    h.update(chunk)
        else:
            h.update(repr(item).encode())
    h.update(repr(tail).encode())
    return h.hexdigest()


def _p0_fp_path(cfg: Config) -> str:
    return os.path.join(processed_dir(cfg), "p0.fp")


def p0_fingerprint(cfg: Config, source_items) -> str:
    """Content hash of the p0 inputs. `source_items` is a list of either
    file paths (raw mode: bytes are hashed) or repr-able values (synthetic
    mode: generator parameters)."""
    return _hash_sources(source_items, (cfg.seed, cfg.holdout_frac, cfg.norm_method,
                                        cfg.hours_from_admission))


def p0_cache_valid(cfg: Config, fp: str, extra_outputs=()) -> bool:
    """True iff every cohort pickle (plus any `extra_outputs` the mode also
    writes, e.g. raw mode's abnormal-vital aux CSV) exists and the sidecar
    matches `fp`."""
    d = processed_dir(cfg)
    if not all(os.path.exists(os.path.join(d, f"{c}.pickle")) for c in COHORTS):
        return False
    for path in extra_outputs:
        if not os.path.exists(path):
            logger.warning("p0 pickles exist but %s is missing — recomputing", path)
            return False
    try:
        with open(_p0_fp_path(cfg)) as f:
            saved = f.read().strip()
    except OSError:
        logger.warning("existing %s/*.pickle have no p0.fp sidecar — recomputing "
                       "(pass --overwrite true to always recompute)", d)
        return False
    if saved != fp:
        logger.warning("existing %s/*.pickle were built from different inputs/config "
                       "— recomputing", d)
        return False
    return True


def p0_invalidate(cfg: Config) -> None:
    try:
        os.remove(_p0_fp_path(cfg))
    except OSError:
        pass


def p0_write_fp(cfg: Config, fp: str) -> None:
    with open(_p0_fp_path(cfg), "w") as f:
        f.write(fp)


# The gridded raw slices (`split_org/`, reference p0_data_process.py:172-185)
# depend only on the sources and the admission window, not on the hold-out
# fraction, the normalization or the hold-out draws: a re-run that changes
# only those restores the slices instead of gridding again.
def _p0_raw_dir(cfg: Config) -> str:
    return os.path.join(cfg.base_path, "model_data", "split_org")


def _p0_raw_fp_path(cfg: Config) -> str:
    return os.path.join(_p0_raw_dir(cfg), "p0_raw.fp")


def p0_raw_fingerprint(cfg: Config, source_items) -> str:
    """Raw-stage content hash: the sources and `hours_from_admission` only
    (the synthetic caller appends its seed to `source_items`)."""
    return _hash_sources(source_items, ("raw-v1", cfg.hours_from_admission))


def p0_raw_cache_valid(cfg: Config, fp: str, extra_outputs=()) -> bool:
    """True iff every cohort's raw-slice pickle (plus `extra_outputs` built
    from the same raw stage) exists and the sidecar matches `fp`."""
    d = _p0_raw_dir(cfg)
    if not all(os.path.exists(os.path.join(d, f"{c}.pickle")) for c in COHORTS):
        return False
    if not all(os.path.exists(path) for path in extra_outputs):
        return False
    try:
        with open(_p0_raw_fp_path(cfg)) as f:
            return f.read().strip() == fp
    except OSError:
        return False


def p0_load_raw(cfg: Config) -> Dict[str, Dict[str, np.ndarray]]:
    d = _p0_raw_dir(cfg)
    out = {}
    for cohort in COHORTS:
        with open(os.path.join(d, f"{cohort}.pickle"), "rb") as f:
            out[cohort] = pickle.load(f)
    return out


def p0_save_raw(cfg: Config, splits, fp: str) -> None:
    """Write the raw slices, then their sidecar (the old sidecar removed
    first)."""
    d = _p0_raw_dir(cfg)
    os.makedirs(d, exist_ok=True)
    try:
        os.remove(_p0_raw_fp_path(cfg))
    except OSError:
        pass
    for cohort, data in splits.items():
        with open(os.path.join(d, f"{cohort}.pickle"), "wb") as f:
            pickle.dump(data, f)
    with open(_p0_raw_fp_path(cfg), "w") as f:
        f.write(fp)
    logger.info("p0: cached raw slices in %s", d)


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


def set_seed(seed: int) -> None:
    """Seed the host's generators (the JAX `utils.prng.set_seed`)."""
    logger.info("The global seed: %s", seed)
    np.random.seed(seed)
    random.seed(seed)


def init_multihost(cfg: Config, device: Device = None, backend: Optional[str] = None
                   ) -> torch.device:
    """Join the process group of a multi-process launch (`--num_processes
    P --process_id i --coordinator_address host:port`, or torchrun's
    `env://` without an address) as one rank with one device: the card
    unless `device="cpu"`. Returns the rank's device; raises, naming the
    missing flag or variable, before anything is written."""
    dev = torch.device("cuda" if device is None else device)
    out = parallel.initialize(cfg.coordinator_address, cfg.num_processes,
                              cfg.process_id, dev.type, backend)
    logger.info("multihost: rank %d of %d on %s (%s)", parallel.rank(),
                parallel.process_count(), out, torch.distributed.get_backend())
    return resolve_device(out)


def data_parallel_ranks(cfg: Config, device: Device = None) -> int:
    """The local ranks `--data_parallel` asks for: 0 none, -1 every visible
    card."""
    n = cfg.data_parallel
    if n == -1:
        if torch.device("cuda" if device is None else device).type != "cuda":
            raise ValueError("--data_parallel -1 counts the visible cards; on the CPU "
                             "give the number of ranks")
        if not torch.cuda.is_available():
            raise RuntimeError("--data_parallel -1: no CUDA device found")
        n = torch.cuda.device_count()
    return n


def _as_rank(body: Callable, cfg: Config, dev: torch.device, build: bool = False) -> Any:
    """Run `body(cfg, dev)` as this rank of the group, which it leaves after
    a barrier that ends every rank's run. With `build`, rank 0 builds the
    CUDA kernels before the others load them."""
    try:
        if build and dev.type == "cuda":
            from ..ops import _cuda_build as cb

            if parallel.is_main_process():
                cb.build_all()
            parallel.barrier("build")
            cb.build_all()
        out = body(cfg, dev)
        parallel.barrier("exit")
    finally:
        parallel.shutdown()
    return out


def _stage_rank(r: int, body: Callable, cfg: Config, device: str, backend: str,
                address: str, world: int) -> Any:
    """One spawned rank of `run_stage`."""
    return _as_rank(body, cfg,
                    resolve_device(parallel.initialize(address, world, r, device, backend)))


def run_stage(body: Callable[[Config, torch.device], Any], cfg: Config, device: Device = None,
              backend: Optional[str] = None, data_parallel: bool = True) -> Any:
    """Run `body(cfg, device)` as the ranks the config asks for and return
    rank 0's result (each process's own under `--num_processes`).

      * `--num_processes P` (> 0): this process is one rank of P
        (`init_multihost`); with `data_parallel` (p1 and p3; p2 when
        `--data_parallel` is set) the ranks train data-parallel or
        row-shard p2's latents, else (p2, p4) each computes the same result
        and rank 0 writes. `--data_parallel` must then be 0, -1 or P.
      * `--data_parallel N` (> 0; -1 every visible card), with
        `data_parallel`: N local ranks spawned here (`parallel.spawn`), one
        device each: card r with NCCL, the CPU with gloo when
        `device="cpu"`. 1 is a one-rank group. The CUDA kernels are built
        here once before the ranks start.
      * otherwise one process without a group.

    `backend` (Python only, for tests and the smoke run): "gloo" lets ranks
    share a card. A barrier ends every rank's run before the group is left.
    """
    dev = torch.device("cuda" if device is None else device)
    if cfg.num_processes > 0:
        if data_parallel and cfg.data_parallel not in (0, -1, cfg.num_processes):
            raise ValueError(f"--data_parallel {cfg.data_parallel} with --num_processes "
                             f"{cfg.num_processes}: one rank per process")
        local = init_multihost(cfg, dev, backend if data_parallel else "gloo")
        return _as_rank(body, cfg, local, build=data_parallel)
    n = data_parallel_ranks(cfg, dev) if data_parallel else 0
    if n == 0:
        return body(cfg, resolve_device(dev))
    backend = backend or parallel.multihost.default_backend(dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
        if backend == "nccl" and n > torch.cuda.device_count():
            raise ValueError(f"--data_parallel {n} over NCCL needs {n} cards, "
                             f"{torch.cuda.device_count()} visible")
        from ..ops import _cuda_build as cb

        cb.build_all()
    address = f"127.0.0.1:{parallel.free_port()}"
    logger.info("data_parallel: spawning %d ranks on %s (%s)", n, dev.type, backend)
    return parallel.spawn(_stage_rank, n, (body, cfg, dev.type, backend, address, n))[0]


def init_run(cfg: Config, stage: str) -> str:
    """Seed the host's generators and torch's, make `{results_path}/{stage}`
    and write its `config.json` (rank 0 alone); returns the run directory."""
    set_seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    exp_path = os.path.join(cfg.results_path, stage)
    if parallel.is_main_process():
        os.makedirs(exp_path, exist_ok=True)
        cfg.save(exp_path)
    logger.info("run dir: %s", exp_path)
    return exp_path
