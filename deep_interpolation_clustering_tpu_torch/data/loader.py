"""Cohort arrays and the per-batch random transforms (counterpart of the
JAX `data/loader.py`).

`ArrayDataset` holds a cohort as dense NumPy planes, pre-scaled once. The
fake-sample generator and the augmentation run on the batch's device. Each
takes its random draws as arguments when given (so a test can feed both
packages the same numbers) and otherwise draws them from an explicit
`torch.Generator`.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..ops.cuda_select import fake_select_mask

log = logging.getLogger("dicl.torch")


class ArrayDataset:
    """A cohort as dense arrays. The observation plane is scaled
    `x -> scale*x - scale/2` (reference dataloader.py:74-79); aux labels
    (future-vital targets with NaN -> mask, binary outcomes) ride along."""

    def __init__(self, cfg: Config, cohort_dict: Dict[str, np.ndarray], cohort: str):
        self.cfg = cfg
        self.cohort = cohort
        self.encounter_ids = list(cohort_dict["encounter_id"])
        feat = np.asarray(cohort_dict["feat"], np.float32)
        if cfg.scale != 0:
            feat = cfg.scale * feat - cfg.scale / 2
        self.ob = feat
        self.padding_mask = np.asarray(cohort_dict["padding_mask"], np.float32)
        self.timestamp = np.asarray(cohort_dict["time_step"], np.float32)
        self.ae_mask = np.asarray(cohort_dict["drop_mask"], np.float32)

        self.aux: Dict[str, np.ndarray] = {}
        if "future_vital" in cfg.aux_tasks:
            fv = np.asarray(cohort_dict["future_vital"], np.float32)
            self.aux["future_vital_mask"] = (~np.isnan(fv)).astype(np.float32)
            self.aux["future_vital"] = np.nan_to_num(fv, nan=0.0)
        for task in cfg.aux_tasks:
            if task != "future_vital":
                self.aux[task] = np.asarray(cohort_dict[task], np.float32)
        log.info("%s data shape: %s", cohort, self.ob.shape)

    def __len__(self) -> int:
        return self.ob.shape[0]

    def num_batches(self, batch_size: int) -> int:
        """Batches of an epoch, the short last one included."""
        return -(-len(self) // batch_size)

    def arrays(self) -> Dict[str, np.ndarray]:
        """All planes and aux labels, the payload kept on the device."""
        d = {
            "ob": self.ob,
            "padding_mask": self.padding_mask,
            "timestamp": self.timestamp,
            "ae_mask": self.ae_mask,
        }
        d.update(self.aux)
        return d


def draw_bits(shape, generator: torch.Generator, device, width: int = 32) -> torch.Tensor:
    """Uniform bit patterns as int32 (the JAX `random.bits` uint32). With
    `width=16` only the upper 16 bits are random and the lower 16 are 0:
    the JAX uint16 draw shifted left by 16."""
    if width == 16:
        half = torch.randint(-(2**15), 2**15, shape, generator=generator, device=device,
                             dtype=torch.int64)
        return (half << 16).to(torch.int32)
    return torch.randint(-(2**31), 2**31, shape, generator=generator,
                         device=device, dtype=torch.int64).to(torch.int32)


def draw_dtype(width: int) -> torch.dtype:
    """The float type of the uniform and normal draws: float16 under
    `rng_draw_bits=16` (converted to float32 where used), else float32."""
    return torch.float16 if width == 16 else torch.float32


def make_fake_ob(
    ob: torch.Tensor,
    padding_mask: torch.Tensor,
    scale: float,
    bits: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    draw_bits_width: int = 32,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Adversarial negatives: replace an exact uniformly drawn
    `max(1, n_valid // 2)` of each channel's valid (front-packed)
    observations with uniform noise over the scaled input range (reference
    dataloader.py:182-193). Channels without observations select nothing.

    `bits` ((B, C, T) int32 bit patterns) and `noise` ((B, C, T) in [0, 1))
    are drawn from `generator` unless given; `draw_bits_width=16` draws
    16-bit keys and float16 noise (the JAX `draw_bits=16`). The noise is
    float32, as in JAX, so a bfloat16 `ob` comes back float32. The select
    is the kernel of `ops/cuda_select.py` on the card (`use_kernel=False`:
    its plain version).
    """
    n_valid = torch.sum(padding_mask, dim=2).to(torch.int32)  # (B, C)
    num_perm = torch.where(n_valid > 0, torch.clamp(n_valid // 2, min=1),
                           torch.zeros_like(n_valid))
    if bits is None:
        bits = draw_bits(ob.shape, generator, ob.device, draw_bits_width)
    if noise is None:
        noise = torch.rand(ob.shape, generator=generator, device=ob.device,
                           dtype=draw_dtype(draw_bits_width))
    noise = noise.to(torch.float32)
    selected = fake_select_mask(bits, n_valid, num_perm, use_kernel=use_kernel)
    if scale != 0:
        noise = noise * scale - scale / 2
    return torch.where(selected, noise, ob)


def augment_batch(
    ob: torch.Tensor,
    timestamp: torch.Tensor,
    padding_mask: torch.Tensor,
    ob_std: float,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    draw_bits_width: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian train-time jitter on observations (std `ob_std`) and
    timestamps (std 0.01), re-masked (reference dataloader.py:196-217).
    `noise` is the (2, B, C, T) standard normal draw, drawn if not given
    (in float16 with `draw_bits_width=16`) and converted to float32, as in
    JAX (a bfloat16 `ob` comes back float32)."""
    if noise is None:
        noise = torch.randn((2,) + tuple(ob.shape), generator=generator,
                            device=ob.device, dtype=draw_dtype(draw_bits_width))
    noise = noise.to(torch.float32)
    ob_n = (ob + noise[0] * ob_std) * padding_mask
    ts_n = (timestamp + noise[1] * 0.01) * padding_mask
    return ob_n, ts_n
