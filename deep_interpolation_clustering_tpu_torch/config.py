"""Typed configuration of the port (counterpart of the JAX package's
`config.py`).

It carries the fields the ported p1 stage reads (the step, the trainer and
its CLI), with the JAX `Config`'s defaults, loads a `config.json` written by
the JAX `Config` and writes one (`save`) that the JAX `Config.load` reads.
It also carries the K-selection fields of p2, the DEC fields of p3 and the
final-label fields of p4. Fields of the JAX config that only steer the TPU
build (Pallas switches, XLA matmul precision, scan unrolling, PRNG
implementation, compilation cache) are accepted on load and ignored with
one log line.
`data_parallel`, `num_processes`, `process_id` and `coordinator_address`
are read: p1 and p3 train data-parallel over the ranks they give, p2 and p4
compute on every rank and write on rank 0, p0 writes on rank 0
(`parallel/`, `cli/common.run_stage`); p2 row-shards the latents over
`--data_parallel` ranks. Like the JAX `Config`, `save` leaves
the last three out of `config.json` and `load` drops them from a file that
has them. `shard_cohort` (on by default, as in JAX) row-shards each cohort
over the data-parallel ranks (`parallel.cohort`).
`fused_epoch` (on by default, as in JAX) runs each epoch as replays of
captured CUDA graphs on one card (`train/graphs.py`), and `pipeline_delta`
lags p3's changed-label fetch one epoch under `eval_interval > 1`
(`train/cluster_trainer.py`).
Tuple fields come back from JSON as lists and are made tuples again.
`compute_dtype` is "float32" or "bfloat16": the train step's forward in
that type, gradients and optimizer state in float32 (`train.steps`).
`model` chooses p1's network: "ipn", the paper's interpolation-prediction
autoencoder (`models/net.py`), or "mtan", the multi-time attention network
(`models/mtan.py`), whose widths are the `mtan_*` fields. The JAX package
has no mTAN: with "mtan", `compute_dtype="bfloat16"` and data-parallel
ranks raise here, and p3's DEC head and the converter raise where they
are built.

Matmul precision: the port runs float32 matmuls in full float32 on the
card (TF32 off, `utils.device.resolve_device`); that is its counterpart of
the JAX `matmul_precision` / `eval_matmul_precision` knobs, which it
ignores.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

log = logging.getLogger("dicl.torch")

# Fields of the JAX Config that the port accepts in a config.json and ignores.
_IGNORED = (
    # TPU / XLA / mesh switches: no counterpart on the card
    "use_pallas", "use_pallas_bwd", "use_pallas_lstm", "matmul_precision",
    "eval_matmul_precision", "prng_impl", "compilation_cache_dir", "perf_profile",
    "sci_share_weights",
    # the scan's unroll lets XLA co-schedule steps (not bit-preserving even
    # in JAX); a CUDA graph replays one step at a time
    "epoch_scan_unroll",
    # the port's cohorts always live on the device (uploaded once a run)
    "device_data",
)
# per-process topology: never written to, nor read from, a config.json
# (the JAX `Config._RUNTIME_ONLY`)
_RUNTIME_ONLY = ("num_processes", "process_id", "coordinator_address")
# fields of the port that the JAX Config does not have (the JAX package has
# no mTAN): written to config.json, where the JAX `Config.load` drops them;
# a JAX config.json leaves them at their defaults
PORT_ONLY = ("model", "mtan_ref_points", "mtan_embed_time", "mtan_rec_hidden",
             "mtan_gen_hidden", "mtan_latent_dim", "mtan_alpha")


@dataclass
class Config:
    # ---- general -------------------------------------------------------
    seed: int = 7529
    log_level: str = "INFO"
    mode: str = "train"  # train | eval
    restore: bool = False
    # metric whose best checkpoint a restore reads (reference p1:33-34)
    restore_metric: str = "ae_mse"
    # metric whose best checkpoint a DEC restore reads (reference p3:29)
    dc_restore_metric: str = "ae_mse"
    log_train_freq: int = 20
    log_valid_freq: int = 20
    # data-parallel ranks that p1 and p3 spawn on this host, one device
    # each: 0 = no group, -1 = every visible card, N = N ranks (1 is a
    # one-rank group); with num_processes set, 0, -1 or num_processes
    data_parallel: int = 0
    # data-parallel ranks store each cohort row-sharded, B/D columns of
    # every batch block a rank, and re-lay it out once an epoch with one
    # all_to_all (`parallel.cohort`); False: every rank holds the whole
    # cohort. The results are the same bits either way.
    shard_cohort: bool = True
    # cooperating processes, one rank each (0 = single-process), this
    # process's rank, and rank 0's "host:port" (empty: torchrun's env://)
    num_processes: int = 0
    process_id: int = -1
    coordinator_address: str = ""

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
    evaluate_interpolation: bool = False
    # feature-dump payload of eval(generate_feat=True): "full" every
    # per-encounter output (rec_ob included), "lean" only `hidden`
    feat_dump: str = "full"
    holdout_frac: float = 0.2

    # ---- model ---------------------------------------------------------
    # "ipn" | "mtan" (the module docstring)
    model: str = "ipn"
    ref_points: int = 6
    dropout: float = 0.2
    lstm_hidden: int = 128
    head_hidden: int = 128
    fake_detection: bool = True
    triple_margin: float = 0.0
    triple_pos_std: float = 0.1
    rbf_basis: str = "gaussian"
    # run the CompressFC trunk and the aux heads as one batched chain
    # (`ops.nn.heads_apply_fused`); off by default, as in JAX
    fused_heads: bool = False
    # mTAN (Shukla & Marlin, ICLR 2021, mTAND-Full with a classifier head;
    # github.com/reml-lab/mTAN, its PhysioNet classification command and
    # argparse defaults): reference points, time-embedding width, the
    # encoder's and the classifier's GRU width, the decoder's GRU width and
    # the latent width; the supervised term's weight alpha (`--alpha`)
    mtan_ref_points: int = 128
    mtan_embed_time: int = 128
    mtan_rec_hidden: int = 256
    mtan_gen_hidden: int = 50
    mtan_latent_dim: int = 20
    mtan_alpha: float = 100.0

    # ---- clustering (DEC, p3) -----------------------------------------
    cluster_number: int = 4
    dec_alpha: float = 1.0
    init_cluster_center: str = "kmeans"  # kmeans | random | none
    stopping_delta: Optional[float] = 1e-4
    # checked every update_interval-th epoch: "delta" stops when the
    # fraction of changed validation labels < stopping_delta (the
    # reference's rule), "count" when their number <= stopping_count,
    # "patience" when the running delta minimum has not improved for
    # stopping_patience checks
    stopping_mode: str = "delta"
    stopping_count: int = 0
    stopping_patience: int = 20
    update_interval: int = 1
    # under the fused epoch's deferred cadence (eval_interval > 1), fetch
    # each epoch's changed-label count one epoch late, while the next epoch
    # runs; a stop found late rolls the speculative epoch back, so the stop
    # epoch, the deltas and the weights are those of the unlagged loop
    pipeline_delta: bool = False
    kmeans_n_init: int = 20
    # "device": k-means on the latents' device (cluster/kmeans.py);
    # "sklearn": the NumPy mirror of sklearn.KMeans's random path
    # (cluster/sklearn_compat.py)
    kmeans_impl: str = "device"
    # "device": DBSCAN on the latents' device (cluster/dbscan.py), labels
    # identical to sklearn's; "sklearn": sklearn.cluster.DBSCAN on the host
    dbscan_impl: str = "device"

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
    max_epochs: int = 10000
    optimizer: str = "adam"  # adam (amsgrad) | sgd | rmsprop
    init_lr: float = 3e-3
    min_lr: float = 1e-6
    lr_decay_mode: str = "step"  # step | plateau | warmup
    lr_decay_step_or_patience: int = 20
    lr_decay_rate: float = 0.2
    warmup_multiplier: float = 8.0
    warmup_epochs: int = 10
    grad_clip: float = 15.0
    weight_decay_rate: float = 4e-4
    early_stopping: int = 50
    # validate, checkpoint and test early stop every k-th epoch and at the
    # last one; between, "step" and "warmup" still step the rate (and the
    # fused epochs' losses are fetched at the next eval)
    eval_interval: int = 1
    # run each epoch (and eval pass) as replays of captured CUDA graphs of
    # the step, one per batch (`train/graphs.py`; JAX's one lax.scan an
    # epoch), on one card and on the ranks of a NCCL group (their
    # collectives captured too); False runs them uncaptured, as gloo does.
    fused_epoch: bool = True
    # bit width of the random draws of the fake sample and the
    # augmentation: 16 draws 16-bit select keys, float16 noise and normals
    rng_draw_bits: int = 32
    # the train step's forward dtype: "bfloat16" runs it on bfloat16 copies
    # of the float parameters and batch planes (the kernels compute float32
    # inside); gradients, optimizer state and BatchNorm statistics stay
    # float32, and eval forwards and dumps run in float32
    compute_dtype: str = "float32"

    # ---- K selection (p2) ---------------------------------------------
    k_max: int = 10
    select_opt_k: Tuple[str, ...] = ("gap_sts", "elbow")
    n_init: int = 10
    gap_b: int = 10
    # > 0: the gap sweep runs on a seeded uniform subsample of this many rows
    gap_subsample: int = 0
    opt_eps: float = 1.9
    internal_metrics: Tuple[str, ...] = (
        "Sihouette",
        "Davies-Bouldin_Index",
        "Calinski-Harabasz",
    )
    # recompute a gap table even when a matching one exists
    overwrite: bool = False

    # ---- final labels (p4) --------------------------------------------
    cluster_method: str = "kmeans"  # kmeans | dbscan | dl | consensus
    num_clusters: int = 4
    dl_cluster_label_type: str = "pred"  # pred | label

    # ---- paths ---------------------------------------------------------
    base_path: str = "Data"
    results_path: str = "Results"

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
        "mode": ("train", "eval"),
        "optimizer": ("adam", "sgd", "rmsprop"),
        "lr_decay_mode": ("step", "plateau", "warmup"),
        "rng_draw_bits": (32, 16),
        "feat_dump": ("full", "lean"),
        "stopping_mode": ("delta", "count", "patience"),
        "kmeans_impl": ("device", "sklearn"),
        "dbscan_impl": ("device", "sklearn"),
        "compute_dtype": ("float32", "bfloat16"),
        "model": ("ipn", "mtan"),
    }
    _MIN_ONE = ("eval_interval", "batch_size", "num_timestamps", "max_epochs")

    def __post_init__(self):
        for name, allowed in self._CHOICES.items():
            v = getattr(self, name)
            if v not in allowed:
                raise ValueError(f"Config.{name}={v!r}: must be one of {allowed}")
        for name in self._MIN_ONE:
            if getattr(self, name) < 1:
                raise ValueError(f"Config.{name}={getattr(self, name)} must be >= 1")
        if self.data_parallel < -1:
            raise ValueError(f"Config.data_parallel={self.data_parallel} must be >= -1")
        if self.k_max < 2:  # the K sweeps run 2..k_max
            raise ValueError(f"Config.k_max={self.k_max} must be >= 2")
        if self.model == "mtan":
            if self.compute_dtype != "float32":
                raise ValueError(f"Config.model='mtan' runs in float32 only: "
                                 f"compute_dtype={self.compute_dtype!r} is not supported")
            if self.data_parallel != 0 or self.num_processes > 0:
                raise ValueError("Config.model='mtan' runs on one device: data-parallel "
                                 f"ranks (data_parallel={self.data_parallel}, "
                                 f"num_processes={self.num_processes}) are not supported")

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
        for f in dataclasses.fields(cls):
            if isinstance(f.default, tuple) and isinstance(kw.get(f.name), list):
                kw[f.name] = tuple(kw[f.name])
        return cls(**kw)

    def save(self, run_dir: str, name: str = "config") -> str:
        """Write `{run_dir}/{name}.json`, which the JAX `Config.load` reads
        (it keeps the fields it knows, every field here but `PORT_ONLY`)."""
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, f"{name}.json")
        d = dataclasses.asdict(self)
        for k in _RUNTIME_ONLY:
            d.pop(k)
        with open(path, "w") as f:
            f.write(json.dumps(d, indent=2, sort_keys=True))
        return path

    @classmethod
    def load(cls, path: str, **overrides) -> "Config":
        """Load a `config.json` written by the JAX or the port's `Config`
        (the runtime-only fields of an older file are dropped)."""
        with open(path) as f:
            d = json.load(f)
        return cls.from_dict({k: v for k, v in d.items() if k not in _RUNTIME_ONLY},
                             **overrides)
