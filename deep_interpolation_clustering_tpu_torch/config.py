"""Typed configuration of the port (counterpart of the JAX package's
`config.py`).

It carries the fields the ported p1 step reads, with the JAX `Config`'s
defaults, and loads a `config.json` written by the JAX `Config`. Fields of
the JAX config that only steer the TPU build (Pallas switches, XLA matmul
precision, scan unrolling, PRNG implementation, mesh layout, compilation
cache) or belong to stages not ported yet are accepted on load and ignored
with one log line.

Matmul precision: the port runs float32 matmuls in full float32 on the
card (TF32 off, `utils.device.resolve_device`); that is its counterpart of
the JAX `matmul_precision` / `eval_matmul_precision` knobs, which it
ignores.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass, field
from typing import Dict

log = logging.getLogger("dicl.torch")

# Fields of the JAX Config that the port accepts in a config.json and ignores.
_IGNORED = (
    # TPU / XLA / mesh switches: no counterpart on the card
    "use_pallas", "use_pallas_bwd", "use_pallas_lstm", "matmul_precision",
    "eval_matmul_precision", "epoch_scan_unroll", "prng_impl", "shard_cohort",
    "compilation_cache_dir", "perf_profile", "fused_epoch", "device_data",
    "sci_share_weights", "data_parallel", "num_processes", "process_id",
    "coordinator_address",
    # options and stages the port has not reached yet (ROADMAP.md, queue A)
    "fused_heads", "compute_dtype", "mode", "restore", "restore_metric",
    "dc_restore_metric", "log_train_freq", "log_valid_freq",
    "evaluate_interpolation", "feat_dump", "cluster_number", "dec_alpha",
    "init_cluster_center", "stopping_delta", "stopping_mode", "stopping_count",
    "stopping_patience", "update_interval", "pipeline_delta", "kmeans_n_init",
    "kmeans_impl", "dbscan_impl", "max_epochs", "min_lr", "lr_decay_mode",
    "lr_decay_step_or_patience", "lr_decay_rate", "warmup_multiplier",
    "warmup_epochs", "early_stopping", "eval_interval", "k_max",
    "select_opt_k", "n_init", "gap_b", "gap_subsample", "opt_eps",
    "internal_metrics", "overwrite", "cluster_method", "num_clusters",
    "dl_cluster_label_type", "base_path", "results_path",
)


@dataclass
class Config:
    # ---- general -------------------------------------------------------
    seed: int = 7529
    log_level: str = "INFO"

    # ---- data ----------------------------------------------------------
    hours_from_admission: int = 6
    batch_size: int = 256
    norm_method: str = "minmax"
    aug_input: bool = False
    aug_std: float = 0.1
    # affine input scaling x -> scale*x - scale/2 (reference dataloader.py:74-79)
    scale: float = 5.0
    denoise: bool = False
    num_variables: int = 6
    num_timestamps: int = 354
    holdout_frac: float = 0.2

    # ---- model ---------------------------------------------------------
    ref_points: int = 6
    dropout: float = 0.2
    lstm_hidden: int = 128
    head_hidden: int = 128
    fake_detection: bool = True
    triple_margin: float = 0.0
    triple_pos_std: float = 0.1
    rbf_basis: str = "gaussian"

    # ---- learning ------------------------------------------------------
    loss: str = "ae_mse_sup_fake_detect"
    aux_tasks: Dict[str, float] = field(default_factory=lambda: {"future_vital": 0.5})
    aux_pos_weights: Dict[str, float] = field(
        default_factory=lambda: {
            "future_vital": 1.0,
            "AKI_overall": 1.0,
            "mort_status_30d": 1.0,
            "ICU": 1.0,
        }
    )
    unsup_aux_tasks: Dict[str, float] = field(
        default_factory=lambda: {"fake_detection": 1.0, "triplet": 1.0, "kl": 10.0}
    )
    optimizer: str = "adam"  # adam (amsgrad) | sgd | rmsprop
    init_lr: float = 3e-3
    grad_clip: float = 15.0
    weight_decay_rate: float = 4e-4
    # bit width of the fake-select keys and noise draws; only 32 is ported
    rng_draw_bits: int = 32

    # ------------------------------------------------------------------
    @property
    def dim_enc_hidden(self) -> int:
        """Latent width: concat of fwd/bwd final LSTM hidden states."""
        return 2 * self.lstm_hidden

    @property
    def loss_components(self) -> frozenset:
        """Decode the loss-mode string into a component set (the JAX
        `Config.loss_components`)."""
        name = self.loss
        comps = set()
        if "_sup" in name:
            comps.add("sup")
        if "fake_detect" in name:
            comps.add("fake")
        if name.endswith("_kl") or "_kl_" in name:
            comps.add("kl")
        if "triplet" in name:
            comps.add("triplet")
        return frozenset(comps)

    _CHOICES = {
        "optimizer": ("adam", "sgd", "rmsprop"),
        "rng_draw_bits": (32, 16),
    }
    _MIN_ONE = ("batch_size", "num_timestamps")

    def __post_init__(self):
        for name, allowed in self._CHOICES.items():
            v = getattr(self, name)
            if v not in allowed:
                raise ValueError(f"Config.{name}={v!r}: must be one of {allowed}")
        for name in self._MIN_ONE:
            if getattr(self, name) < 1:
                raise ValueError(f"Config.{name}={getattr(self, name)} must be >= 1")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict, **overrides) -> "Config":
        """Build from a dict of JAX `Config` fields. Ignored fields are
        logged once; a key neither field nor ignored raises."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(k for k in d if k not in known and k not in _IGNORED)
        if unknown:
            raise ValueError(f"Config: unknown fields {unknown}")
        ignored = sorted(k for k in d if k in _IGNORED)
        if ignored:
            log.info("Config: ignoring fields the port does not read: %s",
                     ", ".join(ignored))
        kw = {k: v for k, v in d.items() if k in known}
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def load(cls, path: str, **overrides) -> "Config":
        """Load a `config.json` written by the JAX or the port's `Config`."""
        with open(path) as f:
            return cls.from_dict(json.load(f), **overrides)
