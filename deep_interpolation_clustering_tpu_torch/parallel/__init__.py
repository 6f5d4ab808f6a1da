"""Data-parallel and multi-process runs on `torch.distributed`
(counterpart of the JAX `parallel/`): the world of ranks and its
collectives (`mesh`), process groups and their launch (`multihost`).
Row-sharded cohort storage (the JAX `parallel/cohort.py`) is not ported:
every rank keeps the whole cohort on its device."""

from .mesh import (
    all_sum,
    all_sum_grad,
    all_sum_grads_,
    broadcast_,
    gather_blocks,
    gather_rows,
    local_rows,
    pad_batch_to,
    permuted_share,
    rank,
    replicated,
    segment_rows,
    shard_rows,
    world_size,
)
from .multihost import (
    barrier,
    device_fetch,
    free_port,
    initialize,
    is_main_process,
    process_count,
    shutdown,
    spawn,
)

__all__ = [
    "all_sum",
    "all_sum_grad",
    "all_sum_grads_",
    "barrier",
    "broadcast_",
    "device_fetch",
    "free_port",
    "gather_blocks",
    "gather_rows",
    "initialize",
    "is_main_process",
    "local_rows",
    "pad_batch_to",
    "permuted_share",
    "process_count",
    "rank",
    "replicated",
    "segment_rows",
    "shard_rows",
    "shutdown",
    "spawn",
    "world_size",
]
