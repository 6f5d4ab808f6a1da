"""The p1 trainer (counterpart of the JAX `train/trainer.py`, reference
pretrain_trainer.py:17-438), on one device or data-parallel over the ranks
of a process group.

`train()` is the reference's epoch loop: a training epoch, then (every
`eval_interval` epochs and at the last) a validation pass and `aly_pred`
(the learning-rate schedule, per-metric best checkpoints, the summary row,
patience early stop). `eval()` restores a metric's best checkpoint and
dumps per-encounter features as the `{cohort}.npy` dict that p2-p4 of
either package read. Checkpoints are the JAX npz (`checkpoint.py`).

Each cohort is uploaded to the device once and batches are gathered there.
Every encounter trains once per epoch: a short final batch is padded to the
full batch by repeating its real rows and trained as one masked step
(`sample_mask` 1 on the real rows), as the JAX `_tail_train_step` does. An
eval pass pads its last batch the same way and masks it out of the losses.

One body an epoch and one an eval pass (JAX `_train_one_epoch_fused`,
`_eval_one_epoch_fused`). An epoch uploads its (n_batches, B) index matrix
once and runs its steps through `graphs.GraphedStep` (a full-batch step and
the masked tail's), their losses stacking into a table on the device that
the host fetches once, after the epoch, for the `log_train_freq` batch
lines and `train_batch` summary rows. An eval pass copies each step's
losses and outputs into the pass's device buffers: one fetch (with the
`log_valid_freq` lines), or none with `device_dumps`, and with
`defer_losses` its per-batch losses stay on the device too. `GraphedStep`
alone decides whether a step is captured as a CUDA graph and replayed:
under `fused_epoch` (on by default, as in JAX) on the card, alone or on the
ranks of a NCCL group, their collectives captured (`parallel.capturable()`);
elsewhere (the CPU, a gloo group, whose collectives run on the host,
`fused_epoch=False`) the same body runs uncaptured, with the same bits
(`tests/test_torch_fused*.py`). A step reads the rank's B/D rows of each
batch, or with a sharded cohort the block's number; the eval's outputs are
gathered after the pass. Under `eval_interval > 1` and `_can_fuse`,
`train()` dispatches the epochs between evals and fetches their losses at
the next eval (JAX `train()`'s `drain`).

Data-parallel (`parallel.world_size()` D > 1, one rank a device): every
rank shuffles alike (`RandomState(seed + epoch)`) and takes its B/D rows of
each global batch, the padded tail's included. With `shard_cohort` (the
default, as in JAX) a rank stores only those rows of each cohort
(`parallel.cohort.ShardedCohort`, cohort/D bytes a rank): the training
cohort is re-laid out into the epoch's order once an epoch (one
`all_to_all` a plane) and each step slices its block, and an eval pass
reads the cohort in its identity order; with `shard_cohort=False` every
rank holds the whole cohort and gathers its rows each step. Both give the
same bits; the step's draws, moments,
losses and gradient sum are global ones (`steps`), so the ranks take the
same step and hold the same weights, which `train_one_epoch` checks bit
for bit at each epoch's end. Rank 0's weights are broadcast at start. An
eval pass shards each batch the same way; its metrics are per-batch global
losses and its dumps are gathered, so every rank holds them. Rank 0 alone
writes `config.json`, checkpoints, the summary and the dumps; `load_weight`
waits at a barrier first. Every decision of the host (early stop, the
schedule, logging) reads global values, the same on every rank.

`cfg.model` chooses the network (`_build_net`): the IPN (`models/net.py`)
or mTAN (`models/mtan.py`, one device, no DEC head); the loop, the graphs,
the optimizer, checkpoints (mTAN's weights in the port's own layout,
`checkpoint.layout`) and dumps are the same. mTAN's KL weight follows the
epoch (`set_epoch`, called by `_epoch_batches`).

Tracing (`utils.tracing`, off by default): `train()` is the root span
`train`, each loop iteration an `epoch` span (attribute `epoch`); inside
it `train_epoch` (children `train_epoch.plan`: the shuffle, the index
upload and a sharded cohort's `relayout`; `train_epoch.replay`: the steps,
replayed or uncaptured), `fetch` (an epoch's losses to the host),
`eval` (attribute `scope`; `eval.replay`, `eval.fetch`), `checkpoint`
(`checkpoint.copy`: the state to the host; `checkpoint.write`: the files)
and the summary's `summary` rows. Counters: `train.steps`, `eval.batches`
and `host_reads`, one for each transfer of card data to the host (a loss
table, a dump, a checkpoint's tensors), counted on the CPU
too, so that the count is the same on both devices.
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import parallel
from ..compat import optimizer_from_jax, optimizer_to_jax
from ..config import Config
from ..data.loader import ArrayDataset
from ..info import COHORT2SCOPE, METRICS, MIN_MAX_VALUES
from ..models.mtan import MTAN
from ..models.net import Net
from ..parallel.cohort import ShardedCohort
from ..utils import tracing
from ..utils.device import resolve_device
from ..utils.logging import logger, timer
from . import checkpoint as ckpt
from .graphs import GraphedStep, SharedPool
from .optim import LRSchedule, make_optimizer, set_learning_rate
from .steps import eval_step, gather_batch, train_step
from .summary import Summary

# (rows, sample mask): the rows are an index tensor into the replicated
# cohort, or with a sharded cohort the block's number
Batch = Tuple[Union[torch.Tensor, int], Optional[torch.Tensor]]


class Trainer:
    """Interpolation-autoencoder pretraining on one device: the card unless
    `device="cpu"`, one rank's device in a process group. Writes under
    `exp_path`: `config.json`, `summary/`, `weight/{metric}/checkpoint.npz`
    and `out_feat/{metric}/{cohort}.npy`."""

    # the DEC head (`ClusterTrainer`)
    clustering = False

    def __init__(self, cfg: Config, datasets: Dict[str, ArrayDataset], exp_path: str,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.datasets = datasets
        self.exp_path = exp_path
        self.device = resolve_device(device)
        self.world = parallel.world_size()
        if cfg.batch_size % self.world:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by the "
                             f"{self.world} data-parallel ranks")
        self.main = parallel.is_main_process()
        init_gen = torch.Generator().manual_seed(cfg.seed)
        self.net = self._build_net(init_gen).to(self.device)
        parallel.broadcast_(list(self.net.parameters()) + list(self.net.buffers()))
        self.opt = make_optimizer(cfg, self.net.parameters())
        self._layout = ckpt.layout(cfg.model)  # the weights' form in a checkpoint
        self.num_updates = 0  # the JAX optimizer state's count
        self.lr_schedule = LRSchedule(cfg)
        # batch draws (fake select bits and noise, permutation, dropout)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self._cohorts: Dict[str, Dict[str, torch.Tensor]] = {}
        # the JAX `_shard_cohort`: row-sharded storage on a group of ranks
        self.shard_cohort = self.world > 1 and cfg.shard_cohort
        self._blocks: Dict[str, ShardedCohort] = {}
        # the fused epoch's steps, by (what, cohort, masked, ...); the loss
        # names each one stacks
        self._graphs: Dict[tuple, GraphedStep] = {}
        self._graph_pool = SharedPool()  # one memory pool for all of them
        self._loss_keys: Dict[tuple, List[str]] = {}
        self._said_why = False
        self.epoch = 1
        self.flag_dict = ckpt.FlagDict(METRICS)
        self.weight_paths = ckpt.weight_dirs(os.path.join(exp_path, "weight"), METRICS,
                                             create=self.main)
        self.summary = Summary(os.path.join(exp_path, "summary"), enabled=self.main)
        if self.main:
            cfg.save(exp_path)
        n_train = len(datasets["training"]) if "training" in datasets else 0
        if n_train:  # uploaded once, kept on the device
            if self.shard_cohort:
                self.cohort_blocks("training")
            else:
                self.cohort_data("training")
        n_params = sum(p.numel() for p in self.net.parameters())
        logger.info("trainable params: %d; train samples: %d; ratio %.3f",
                    n_params, n_train, n_params / max(n_train, 1))

    def _build_net(self, generator: torch.Generator) -> torch.nn.Module:
        """`cfg.model`'s network: the IPN (`Net`, with the DEC head in a
        clustering trainer) or mTAN, which has no DEC head and runs on one
        device."""
        cfg = self.cfg
        if cfg.model != "mtan":
            return Net(cfg, generator=generator, clustering=self.clustering)
        if self.clustering:
            raise ValueError("model='mtan' has no DEC head: p3 (ClusterTrainer) is not "
                             "supported")
        if self.world > 1:
            raise ValueError(f"model='mtan' runs on one device: {self.world} data-parallel "
                             f"ranks are not supported")
        return MTAN(cfg, generator=generator)

    def cohort_data(self, cohort: str) -> Dict[str, torch.Tensor]:
        """The whole cohort on the device (the replicated storage)."""
        if cohort not in self._cohorts:
            self._cohorts[cohort] = {
                k: torch.as_tensor(v, device=self.device)
                for k, v in self.datasets[cohort].arrays().items()
            }
        return self._cohorts[cohort]

    def cohort_blocks(self, cohort: str) -> ShardedCohort:
        """This rank's row-sharded storage of the cohort, made once (JAX
        `_cohort_block_data`)."""
        if cohort not in self._blocks:
            arrays = self.datasets[cohort].arrays()
            blocks = ShardedCohort(arrays, self.cfg.batch_size, self.device)
            whole = sum(v.nbytes for v in arrays.values())
            logger.info("cohort '%s' row-sharded over %d ranks: %d bytes (%.1f MB) a rank, "
                        "%d bytes (%.1f MB) in all, which each rank holds replicated "
                        "(rank %d)", cohort, self.world, blocks.nbytes_per_device(),
                        blocks.nbytes_per_device() / 2**20, whole, whole / 2**20,
                        parallel.rank())
            self._blocks[cohort] = blocks
        return self._blocks[cohort]

    def _relayout(self, blocks: ShardedCohort, order: np.ndarray, what: str) -> None:
        """`blocks.ensure(order)`, the span `relayout`, when it moves storage;
        the log line gives the host's seconds (the dispatch: nothing waits for
        the card, whose time is the span's device interval)."""
        if np.array_equal(order, blocks.order):
            return
        t0 = time.perf_counter()
        with tracing.span("relayout"):
            blocks.ensure(order)
        logger.info("cohort relayout for %s in %.4f s (rank %d of %d)", what,
                    time.perf_counter() - t0, parallel.rank(), self.world)

    # ------------------------------------------------------------- train
    def train(self) -> Dict[str, float]:
        """Train until `max_epochs` or early stop; returns the last
        validation metrics (JAX `Trainer.train`). The root span `train`
        around `_train`, the loop; under a profiler with the tracer off,
        the call traces itself (`tracing.call`)."""
        with tracing.call(self.device):
            return self._train()

    def _train(self) -> Dict[str, float]:
        cfg = self.cfg
        if cfg.restore:
            self.load_weight()
        last_valid: Dict[str, float] = {}
        # eval_interval > 1: fused epochs dispatched and not yet fetched; the
        # epochs between evals need nothing from the device (the shuffle is
        # the host's, "step" and "warmup" rates are closed-form, checkpoints
        # and early stop wait for an eval), so their losses are fetched at
        # the next eval
        pending: List[tuple] = []
        with timer("Duration of training"):
            while self.epoch < cfg.max_epochs:
                with tracing.span("epoch", epoch=self.epoch):
                    is_eval = (cfg.eval_interval <= 1 or self.epoch % cfg.eval_interval == 0
                               or self.epoch + 1 >= cfg.max_epochs)
                    if cfg.eval_interval > 1 and self._can_fuse(self.datasets["training"]):
                        pending.append((self.epoch, self._dispatch_fused_epoch(),
                                        self.datasets["training"].num_batches(cfg.batch_size)))
                    else:
                        logger.info("==> Epoch %d train %s", self.epoch,
                                    _fmt(self.train_one_epoch()))
                    if is_eval:
                        self._drain(pending)
                        last_valid, _ = self.eval_one_epoch(
                            "valid", self.datasets["validation"], cfg.denoise)
                        early_stop = self.aly_pred("valid", last_valid)["early_stop"]
                    else:
                        # the epoch-indexed schedules step every epoch; plateau
                        # needs the validation loss, so it steps at evals only
                        if cfg.lr_decay_mode != "plateau":
                            self._step_schedule(None)
                        early_stop = False
                    self.epoch += 1
                if early_stop:
                    logger.info("======== best model: %s", self.flag_dict.to_dict())
                    break
            self._drain(pending)  # every eval already drained; the last epoch is one
        return last_valid

    def _drain(self, pending: List[tuple]) -> None:
        """Fetch the dispatched epochs' losses and write their log lines and
        summary rows (JAX `train()`'s `drain`). Each entry is (epoch,
        handles, n_batches, *more), `more` going to `_drained`."""
        if not pending:
            return
        for epoch, handles, n_batches, *more in pending:
            logger.info("==> Epoch %d train %s", epoch,
                        _fmt(self._finalize_fused_epoch(epoch, handles, n_batches)))
            self._drained(epoch, *more)
        first = pending[0][0]
        logger.info("epochs %d-%d fetched (deferred, eval_interval %d)", first,
                    pending[-1][0], self.cfg.eval_interval)
        pending.clear()

    def _drained(self, epoch: int, *more) -> None:
        """What a trainer writes for a drained epoch beside its train row:
        nothing here."""

    def _can_fuse(self, ds: Optional[ArrayDataset] = None) -> bool:
        """Whether the epochs between evals are deferred (JAX `_can_fuse`:
        the switch and, for a train epoch over `ds`, a full batch), here
        also a world whose collectives a CUDA graph can capture
        (`parallel.capturable()`: no group, or a NCCL group); a gloo group
        runs uncaptured and fetches each epoch. Where the switch is on and
        the epochs are not deferred all the same, the log says why, once."""
        cfg = self.cfg
        if not cfg.fused_epoch:
            return False
        why = None
        if ds is not None and len(ds) < cfg.batch_size:
            why = f"{len(ds)} encounters, fewer than a batch of {cfg.batch_size}"
        elif not parallel.capturable():
            why = (f"the {torch.distributed.get_backend()} group of {self.world} ranks, "
                   f"whose collectives a CUDA graph cannot capture: the steps run uncaptured")
        if why and not self._said_why:
            logger.info("fused_epoch: each epoch is fetched at its end: %s", why)
            self._said_why = True
        return why is None

    def _epoch_batches(self, epoch: int) -> List[Batch]:
        """The epoch's shuffled batches as (rows, sample mask) on the
        device, this rank's rows of each. Full batches have no mask; a short
        final batch is padded to the batch size by cyclically repeating its
        real rows (`parallel.pad_batch_to`: finite values everywhere, as the
        JAX `_tail_train_step`), its mask 1 on them. A sharded cohort is
        first re-laid out into the epoch's order; its batches are then the
        block numbers (the tail block holds the same padded rows). A net
        whose loss changes with the epoch (mTAN's KL weight, `set_epoch`) is
        given the epoch first, in place, where its captured steps read it."""
        set_epoch = getattr(self.net, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(epoch)
        n, bs = len(self.datasets["training"]), self.cfg.batch_size
        order = np.arange(n)
        np.random.RandomState(self.cfg.seed + epoch).shuffle(order)
        n_full = n // bs * bs
        rows = parallel.shard_rows(bs)
        if self.shard_cohort:
            blocks = self.cohort_blocks("training")
            self._relayout(blocks, blocks.epoch_order(order), f"epoch {epoch}")
            sharded: List[Batch] = [(k, None) for k in range(n_full // bs)]
            if n_full < n:
                sharded.append((n_full // bs, torch.as_tensor(blocks.tail_mask()[rows],
                                                              device=self.device)))
            return sharded
        idx = torch.as_tensor(order[:n_full], device=self.device)
        batches: List[Batch] = [(i[rows], None) for i in idx.reshape(-1, bs)]
        if n_full < n:
            tail, _ = parallel.pad_batch_to({"idx": order[n_full:]}, bs)
            batches.append((torch.as_tensor(tail["idx"][rows], device=self.device),
                            torch.as_tensor(tail["sample_mask"][rows], device=self.device)))
        return batches

    def step(self, idx: Union[torch.Tensor, int], sample_mask: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One uncaptured train step (`_train_fn`) on the encounters `idx` (a
        sharded cohort's block `idx`); `sample_mask` (B,) leaves the padded
        rows of a tail batch out of the losses and BatchNorm."""
        if isinstance(idx, int):  # a block's number, as a (1,) index
            idx = torch.tensor([idx], device=self.device)
        losses = self._train_fn()(idx, sample_mask)
        self.num_updates += 1
        return losses

    def _step_schedule(self, valid_loss: Optional[float]) -> None:
        """Step the rate schedule and give the optimizer its rate ('plateau'
        raises without a validation loss)."""
        set_learning_rate(self.opt, self.lr_schedule.step(valid_loss))

    def _stream(self) -> Iterator[Batch]:
        while True:
            yield from self._epoch_batches(self.epoch)
            self._step_schedule(None)
            self.epoch += 1

    def train_steps(self, n: int) -> List[Dict[str, torch.Tensor]]:
        """Take `n` steps over the shuffled epochs, each epoch's end stepping
        the schedule; the losses stay on the device. No eval, checkpoint or
        summary: the loop of `train()` without them."""
        stream = self._stream()
        return [self.step(*next(stream)) for _ in range(n)]

    def train_one_epoch(self) -> Dict[str, float]:
        """One epoch over every training encounter, dispatched and fetched;
        returns the mean losses over its batches (the masked tail counts as
        one, as in JAX), the summary's `train` row. The epoch's log line
        says "(fused)" when its steps were replayed."""
        t0 = time.perf_counter()
        n = len(self.datasets["training"])
        out = self._finalize_fused_epoch(self.epoch, self._dispatch_fused_epoch(),
                                         self.datasets["training"].num_batches(
                                             self.cfg.batch_size))
        seconds = time.perf_counter() - t0
        rank = f" (rank {parallel.rank()} of {self.world})" if self.world > 1 else ""
        captured = any(g.capture for k, g in self._graphs.items() if k[0] == "train")
        logger.info("epoch %d trained in %.4f s, %.1f encounters/s%s%s", self.epoch, seconds,
                    n / seconds, rank, " (fused)" if captured else "")
        return out

    def _check_replicated(self) -> None:
        """Data-parallel: raise unless every rank holds rank 0's parameters,
        BatchNorm buffers and optimizer state, bit for bit."""
        if self.world == 1:
            return
        tracing.count("host_reads")  # the ranks' verdict
        named = list(self.net.named_parameters()) + list(self.net.named_buffers())
        for i, p in enumerate(self.net.parameters()):
            named += [(f"opt.{i}.{k}", v) for k, v in sorted(self.opt.state[p].items())
                      if isinstance(v, torch.Tensor)]
        differ = parallel.replicated(named)
        if differ:
            raise RuntimeError(f"data-parallel ranks drifted apart after epoch {self.epoch}: "
                               f"{differ[:8]}")

    # ------------------------------------------------------------ epoch
    def _mutable_state(self) -> List[torch.Tensor]:
        """What a train step changes in place: the parameters, the BatchNorm
        buffers and the optimizer's state tensors."""
        out = list(self.net.parameters()) + list(self.net.buffers())
        for p in self.net.parameters():
            out += [v for _, v in sorted(self.opt.state.get(p, {}).items())
                    if isinstance(v, torch.Tensor)]
        return out

    def _graph(self, key: tuple, fn, masked: bool, warmup: int) -> GraphedStep:
        """The step `key`, made on first use: over this rank's B/D rows, read
        through B/D row indices or, with a sharded cohort, one block number."""
        if key not in self._graphs:
            self._graphs[key] = GraphedStep(
                fn, self.cfg.batch_size // self.world, self.device, masked, self.generator,
                self._mutable_state, warmup, self._graph_pool,
                index_size=1 if self.shard_cohort else None, capture=self.cfg.fused_epoch)
        return self._graphs[key]

    def _reader(self, cohort: str):
        """`rows -> batch` for a step over `cohort`: its rows
        gathered from the replicated storage, or the block whose number
        `rows` holds from the sharded one (`ShardedCohort.block_at`)."""
        if self.shard_cohort:
            return self.cohort_blocks(cohort).block_at
        data = self.cohort_data(cohort)
        return lambda rows: gather_batch(data, rows)

    def _train_fn(self):
        """The train step `fn(rows, mask) -> {name: loss}` over the training
        cohort (`_reader`), `mask` a tail's `sample_mask` or None."""
        read, cfg = self._reader("training"), self.cfg

        def fn(rows, mask):
            batch = read(rows)
            if mask is not None:
                batch["sample_mask"] = mask
            return train_step(self.net, self.opt, cfg, batch, self.generator, cfg.denoise)
        return fn

    def _train_graph(self, masked: bool) -> GraphedStep:
        """The epoch's train step (`_train_fn`, its losses stacked): the full
        batch, or the masked tail (`sample_mask` from its mask buffer)."""
        key = ("train", masked)
        train = self._train_fn()

        def fn(rows, mask):
            losses = train(rows, mask)
            self._loss_keys[key] = list(losses)
            return {"losses": torch.stack(list(losses.values()))}

        # two warm-up steps: the first makes the optimizer's state
        return self._graph(key, fn, masked, warmup=2)

    def _dispatch_fused_epoch(self) -> Tuple[torch.Tensor, List[str]]:
        """Run the epoch's steps with no host sync: the batches of
        `_epoch_batches` (its index matrix uploaded once, the tail padded; a
        sharded cohort re-laid out into the epoch's order first, its blocks'
        numbers uploaded once), each batch's rows copied into the graph's
        buffer, its losses into the epoch's (n_batches, K) table on the
        device. Returns (the table, the loss names)."""
        with tracing.span("train_epoch"):
            with tracing.span("train_epoch.plan"):
                batches = self._epoch_batches(self.epoch)
                if self.shard_cohort:
                    blocks = torch.arange(len(batches), device=self.device)
                    batches = [(blocks[k:k + 1], mask) for k, mask in batches]
            tracing.count("train.steps", len(batches))
            table = None
            with tracing.span("train_epoch.replay"):
                for i, (rows, mask) in enumerate(batches):
                    out = self._train_graph(mask is not None)(rows, mask)["losses"]
                    if table is None:
                        table = torch.empty((len(batches),) + tuple(out.shape),
                                            dtype=out.dtype, device=self.device)
                    table[i].copy_(out)
        self.num_updates += len(batches)
        return table, self._loss_keys[("train", mask is not None)]

    def _finalize_fused_epoch(self, epoch: int, handles: Tuple[torch.Tensor, List[str]],
                              n_batches: int) -> Dict[str, float]:
        """Fetch a dispatched epoch's losses and write its batch log lines and
        `train_batch` rows (every `log_train_freq` batches) and its `train`
        row (JAX `_finalize_fused_epoch`): the span `fetch`."""
        with tracing.span("fetch"):
            table, keys = handles
            table = table.cpu().numpy()
            tracing.count("host_reads")
            for i, fetched in _log_batches(epoch, "train", table, keys, self.cfg.log_train_freq):
                self.summary.add_summary(epoch * n_batches + i, scope="train_batch", **fetched)
            out = _batch_means((table, keys))
            self.summary.add_summary(epoch, scope="train", **out)
            self._check_replicated()
        return out

    # -------------------------------------------------------------- eval
    @staticmethod
    def _dumps(bufs: Iterable[Tuple[str, torch.Tensor]], n_batches: int, n: int,
               device_dumps: bool) -> Dict[str, list]:
        """An eval pass's outputs, (key, this rank's rows of each batch) in
        `bufs`, as the cohort's `n` rows ({key: [rows]} with `__index__`),
        gathered over ranks; fetched to the host unless `device_dumps`."""
        dumps: Dict[str, list] = defaultdict(list)
        for k, buf in bufs:
            out = parallel.gather_blocks(buf, n_batches)[:n]
            if not device_dumps:
                out = out.cpu().numpy()
                tracing.count("host_reads")
            dumps[k].append(out)
        dumps["__index__"].append(np.arange(n))
        return dumps

    @staticmethod
    def _eval_rows(n: int, b: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """An eval pass's rows over `n` encounters in order: the (n_batches,
        b) index matrix, the last batch padded to b by repeating its real
        rows (`parallel.pad_batch_to`), and that batch's sample mask (None
        when b divides n)."""
        n_batches, n_full = -(-n // b), n // b
        idx = np.arange(n_batches * b).reshape(n_batches, b)
        mask = None
        if n_full < n_batches:
            padded, _ = parallel.pad_batch_to({"idx": np.arange(n_full * b, n)}, b)
            idx[n_full] = padded["idx"]
            mask = padded["sample_mask"]
        return idx, mask

    def _eval_graph(self, cohort: str, denoise: bool, dump_keys: Optional[Tuple[str, ...]],
                    masked: bool) -> GraphedStep:
        """The eval forward step over `cohort`: its losses stacked and the
        per-encounter outputs (`dump_keys` of them when given), this rank's
        rows of them."""
        key = ("eval", cohort, denoise, dump_keys, masked)
        read, cfg = self._reader(cohort), self.cfg

        def fn(rows, mask):
            losses, outputs = eval_step(self.net, cfg, read(rows),
                                        self.generator, denoise, mask, dump_keys)
            self._loss_keys[key] = list(losses)
            return {"__losses__": torch.stack(list(losses.values())), **outputs}

        return self._graph(key, fn, masked, warmup=1)

    def eval_one_epoch(self, scope: str, ds: ArrayDataset, denoise: bool,
                       dump_keys: Optional[Tuple[str, ...]] = None,
                       device_dumps: bool = False, defer_losses: bool = False
                       ) -> Tuple[Dict[str, object], Dict[str, list]]:
        """Every encounter of `ds` once, in order, in batches of B: the last
        one padded to B by repeating its real rows, `sample_mask` 1 on them
        (JAX `eval_one_epoch`, `_eval_one_epoch_fused`). Each batch (this
        rank's rows of it; a sharded cohort read in its identity order, the
        last block's padding masked by `eval_mask`) runs through the eval
        step (`_eval_graph`), whose losses and outputs are copied into the
        pass's device buffers; their rows are gathered over ranks after the
        pass. The metrics are the mean over batches of each masked batch
        loss, fetched in one read with the `log_valid_freq` batch lines; the
        dumps ({key: [array]} with `__index__`) hold exactly the cohort's N
        rows, fetched once or with `device_dumps` left on the device (for a
        consumer that runs there: p3's k-means and label delta). With
        `defer_losses` too the metrics are the per-batch losses on the
        device ({name: (n_batches,)}), unfetched and unlogged. The span
        `eval`: its batches (`eval.replay`), then what goes to the host
        (`eval.fetch`)."""
        n, b = len(ds), self.cfg.batch_size
        n_batches, n_full = ds.num_batches(b), n // b
        rows = parallel.shard_rows(b)
        with tracing.span("eval", scope=scope):
            tracing.count("eval.batches", n_batches)
            if self.shard_cohort:
                blocks = self.cohort_blocks(ds.cohort)
                self._relayout(blocks, blocks.identity_order(), f"{scope} eval")
                idx = torch.arange(n_batches, device=self.device)[:, None]
                mask = blocks.eval_mask[-1][rows] if n_full < n_batches else None
            else:
                idx, mask = self._eval_rows(n, b)
                idx = torch.as_tensor(idx[:, rows], device=self.device)
                mask = None if mask is None else mask[rows]
            if mask is not None:
                mask = torch.as_tensor(mask, device=self.device)
            b = rows.stop - rows.start  # the rows a rank's step takes
            table, bufs = None, {}
            with tracing.span("eval.replay"):
                for i in range(n_batches):
                    tail = i == n_full
                    out = self._eval_graph(ds.cohort, denoise, dump_keys, tail)(
                        idx[i], mask if tail else None)
                    if table is None:
                        table = torch.empty((n_batches,) + tuple(out["__losses__"].shape),
                                            device=self.device)
                        bufs = {k: torch.empty((n_batches * b,) + tuple(v.shape[1:]),
                                               dtype=v.dtype, device=self.device)
                                for k, v in out.items() if k != "__losses__"}
                    table[i].copy_(out["__losses__"])
                    for k, buf in bufs.items():
                        buf[i * b:(i + 1) * b].copy_(out[k])
            keys = self._loss_keys[("eval", ds.cohort, denoise, dump_keys, tail)]
            with tracing.span("eval.fetch"):
                if defer_losses and device_dumps:
                    metrics: Dict[str, object] = {k: table[:, j] for j, k in enumerate(keys)}
                else:
                    table = table.cpu().numpy()
                    tracing.count("host_reads")
                    _log_batches(self.epoch, scope, table, keys, self.cfg.log_valid_freq)
                    metrics = _batch_means((table, keys))
                    logger.info("%d: %s-%s", self.epoch, scope, _fmt(metrics))
                return metrics, self._dumps(bufs.items(), n_batches, n, device_dumps)

    def merge_ob_pred(self, ds: ArrayDataset, dumps: Dict[str, list]) -> Dict[str, np.ndarray]:
        """The dumps and the cohort's planes as one dict of arrays (reference
        merge_ob_pred, pretrain_trainer.py:406-414)."""
        idx = np.concatenate(dumps.pop("__index__"))
        out: Dict[str, np.ndarray] = {
            "encounter_id": np.asarray([ds.encounter_ids[j] for j in idx]),
            "ob": ds.ob[idx].copy(),
            "padding_mask": ds.padding_mask[idx],
            "timestamp": ds.timestamp[idx],
            "ae_mask": ds.ae_mask[idx],
        }
        for k, v in ds.aux.items():
            out[k] = v[idx]
        for k, v in dumps.items():
            out[k] = np.concatenate(v, axis=0)
        return out

    def re_norm_data(self, ob_pred: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Undo the input scaling and the min-max normalisation of `ob` and
        `rec_ob`, in place, so that both are in physical units (reference
        :416-429)."""
        cfg = self.cfg
        if cfg.norm_method != "minmax":
            raise NotImplementedError(cfg.norm_method)
        for k in ("ob", "rec_ob"):
            if k not in ob_pred:  # feat_dump="lean" has no rec_ob
                continue
            data = ob_pred[k]
            renorm = (data + cfg.scale / 2) / cfg.scale if cfg.scale != 0 else data
            for i, (lo, hi) in enumerate(MIN_MAX_VALUES.values()):
                data[:, i, :] = renorm[:, i, :] * (hi - lo) + lo
            ob_pred[k] = data
        return ob_pred

    def eval(self, cohort: str, generate_feat: bool = False, viz_feat: bool = False,
             metric: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Restore the best checkpoint of `metric` (default: the config's
        `restore_metric`) and dump per-encounter features of `cohort`
        (reference pretrain_trainer.py:90-117) to
        `out_feat/{metric}/{cohort}.npy` when `generate_feat`; with
        `evaluate_interpolation` the inputs are the held-out (denoised) ones
        and the file is `{cohort}_interp_eval.npy`. `viz_feat` writes the
        latents to the TensorBoard projector, tagged with the cohort."""
        cfg = self.cfg
        metric = metric or self.restore_metric
        self.load_weight(metric)
        ds = self.datasets[cohort]
        scope = COHORT2SCOPE[cohort]
        # "lean": only the keys p2/p4 read from the dump; an interpolation
        # evaluation dump exists for its reconstructions, so it stays full
        lean = cfg.feat_dump == "lean" and not cfg.evaluate_interpolation
        metrics, dumps = self.eval_one_epoch(
            scope, ds, cfg.evaluate_interpolation,
            ("hidden", "cluster_pred", "cluster_label") if lean else None)
        logger.info("%s %s", scope, _fmt(metrics))
        ob_pred = self.re_norm_data(self.merge_ob_pred(ds, dumps))
        if generate_feat and self.main:
            folder = os.path.join(self.exp_path, "out_feat", metric)
            os.makedirs(folder, exist_ok=True)
            suffix = "_interp_eval" if cfg.evaluate_interpolation else ""
            path = os.path.join(folder, f"{cohort}{suffix}.npy")
            np.save(path, ob_pred)  # a dict, as the reference writes it
            logger.info("features saved to %s", path)
        if viz_feat:
            self.summary.add_embedding(ob_pred["hidden"], self.epoch, cohort)
        return ob_pred

    # ------------------------------------------------------ aly + ckpt
    @property
    def restore_metric(self) -> str:
        """The metric whose best checkpoint `eval` and `load_weight` read."""
        return self.cfg.restore_metric

    def _ckpt_candidacy(self, metric_dict: Dict[str, float]) -> None:
        """Save the epoch's weights under each monitored metric that
        improved (reference pretrain_trainer.py:126-199)."""
        improved = self.flag_dict.improved(metric_dict, self.epoch)
        if not improved or not self.main:
            return
        with tracing.span("checkpoint"):
            with tracing.span("checkpoint.copy"):  # one host read a tensor (`compat`)
                params, state = self._layout[0](self.net.state_dict())
                leaves = optimizer_to_jax(self.opt, self.net, self.num_updates, self._layout)
            with tracing.span("checkpoint.write"):
                for m in improved:
                    ckpt.save_checkpoint(
                        os.path.join(self.weight_paths[m], ckpt.CKPT_NAME), self.epoch,
                        params, state, leaves,
                        extra={"lr": self.lr_schedule.lr, "metric": m,
                               "lr_schedule": self.lr_schedule.state_dict(),
                               "flag_dict": self.flag_dict.state_dict(),
                               "model": self.cfg.model})
                    logger.info("saving for %s", m)

    def aly_pred(self, scope: str, metric_dict: Dict[str, float]) -> Dict[str, bool]:
        """After a validation pass: the schedule steps on its loss, the rate
        joins the row, the improved metrics' checkpoints are written, then
        the summary row and the early-stop test (JAX `aly_pred`)."""
        if scope == "valid":
            self._step_schedule(metric_dict.get("loss"))
            metric_dict["lr"] = self.lr_schedule.lr
            self._ckpt_candidacy(metric_dict)
        self.summary.add_summary(self.epoch, scope=scope, **metric_dict)
        logger.info("%s", _fmt(metric_dict))
        return {"early_stop": self.flag_dict.early_stop(self.epoch, self.cfg.early_stopping)}

    def load_weight(self, metric: Optional[str] = None) -> None:
        """Restore `metric`'s best checkpoint: the epoch, the weights, the
        optimizer state (fresh if the file has none or another layout), the
        schedule's state and rate, and the flags min-merged over every
        metric's checkpoint (JAX `load_weight`)."""
        metric = metric or self.restore_metric
        # rank 0 writes the checkpoints: past this barrier every rank reads
        # the file rank 0 last wrote, not one it is still writing
        parallel.barrier("load_weight")
        path = os.path.join(self.weight_paths[metric], ckpt.CKPT_NAME)
        if not os.path.exists(path):
            logger.error("==> load fail: no checkpoint at %s", path)
            return
        template = optimizer_to_jax(self.opt, self.net, self.num_updates, self._layout)
        epoch, params, state, leaves, meta = ckpt.load_checkpoint(path, template)
        self.epoch = epoch
        self.net.load_state_dict(self._layout[1](params, state), strict=True)
        if leaves is not None:
            self.num_updates = optimizer_from_jax(self.opt, self.net, leaves, self._layout)
        if "lr_schedule" in meta:
            self.lr_schedule.load_state_dict(meta["lr_schedule"])
        elif "lr" in meta:  # checkpoints from before the schedule's state
            self.lr_schedule.lr = meta["lr"]
            self.lr_schedule.num_steps = epoch
        set_learning_rate(self.opt, self.lr_schedule.lr)
        # the optimizer's state tensors are new objects: the train steps are
        # captured again (the eval steps read the parameters and buffers,
        # which `load_state_dict` copied in place)
        self._graphs = {k: g for k, g in self._graphs.items() if k[0] != "train"}
        for d in self.weight_paths.values():
            p = os.path.join(d, ckpt.CKPT_NAME)
            if os.path.exists(p):
                fd = ckpt.load_meta(p).get("flag_dict")
                if fd:
                    self.flag_dict.merge_state(fd)
        logger.info("=> restored checkpoint %s (epoch %d)", path, epoch)

    def eval_batch(self, cohort: str = "validation",
                   idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Eval forward of one batch (the first `batch_size` encounters
        unless `idx` is given); returns the (B, 2H) latents."""
        data = self.cohort_data(cohort)
        if idx is None:
            n = min(self.cfg.batch_size, len(self.datasets[cohort]))
            idx = torch.arange(n, device=self.device)
        _, outputs = eval_step(self.net, self.cfg, gather_batch(data, idx),
                               self.generator, self.cfg.denoise)
        return outputs["hidden"]

    def close(self) -> None:
        """Close the summary's files."""
        self.summary.close()


def _log_batches(epoch: int, scope: str, table: np.ndarray, keys: List[str], freq: int
                 ) -> List[Tuple[int, Dict[str, float]]]:
    """Log batch i's losses from a fetched (batches, losses) table where
    i % `freq` == 1 (i from 1, the reference's `log_*_freq` lines); returns
    them as (i, {name: loss})."""
    n_batches, out = table.shape[0], []
    for i in range(1, n_batches + 1):
        if i % freq == 1:
            losses = {k: float(table[i - 1, j]) for j, k in enumerate(keys)}
            logger.info("%d-[%d/%d (%.0f%%)]: %s-%s", epoch, i, n_batches,
                        100.0 * i / n_batches, scope, _fmt(losses))
            out.append((i, losses))
    return out


def _batch_means(table_keys: Tuple[np.ndarray, List[str]]) -> Dict[str, float]:
    """The mean over batches of each loss of a fetched (batches, losses)
    table, beside the loss names."""
    table, keys = table_keys
    return {k: float(np.mean(table[:, j], dtype=np.float64)) for j, k in enumerate(keys)}


def _fmt(d: Dict[str, float], decimals: int = 4) -> Dict[str, float]:
    return {k: (round(v, decimals) if isinstance(v, float) and k != "lr" else v)
            for k, v in d.items()}
