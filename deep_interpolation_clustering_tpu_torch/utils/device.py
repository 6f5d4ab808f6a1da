"""Device choice for the port's entry points.

Entry points run on the card unless the caller names the CPU. With no card
and no explicit CPU they raise: nothing falls back to the CPU quietly.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def disable_tf32() -> None:
    """Full float32 matmuls and convolutions on the card: the port's
    counterpart of the JAX config's `matmul_precision` /
    `eval_matmul_precision` ("highest")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the card. A CUDA device needs a card and turns TF32 off."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU"
            )
        disable_tf32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
