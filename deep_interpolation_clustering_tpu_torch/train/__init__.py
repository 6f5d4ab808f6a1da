from .optim import clip_grad_global_norm_, make_optimizer
from .steps import build_inputs, eval_step, gather_batch, train_step, update
from .trainer import Trainer

__all__ = [
    "Trainer",
    "build_inputs",
    "clip_grad_global_norm_",
    "eval_step",
    "gather_batch",
    "make_optimizer",
    "train_step",
    "update",
]
