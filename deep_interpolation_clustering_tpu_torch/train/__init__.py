from .checkpoint import CKPT_NAME, FlagDict, load_checkpoint, save_checkpoint
from .optim import LRSchedule, clip_grad_global_norm_, make_optimizer
from .steps import build_inputs, eval_step, gather_batch, train_step, update
from .summary import Summary
from .trainer import Trainer
from .cluster_trainer import ClusterTrainer

__all__ = [
    "CKPT_NAME",
    "ClusterTrainer",
    "FlagDict",
    "LRSchedule",
    "Summary",
    "Trainer",
    "build_inputs",
    "clip_grad_global_norm_",
    "eval_step",
    "gather_batch",
    "load_checkpoint",
    "make_optimizer",
    "save_checkpoint",
    "train_step",
    "update",
]
