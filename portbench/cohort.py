"""The cohort a cell trains on, made on the device from the seed: p0's arrays
for the training and validation splits, as `cli/p0` writes them.

Each encounter belongs to one of four phenotypes with distinct vital
profiles; each (encounter, channel) has a number of observations drawn
uniformly on `min_obs`..T, at sorted uniform times over the window, their
values a per-encounter level with a slow drift and noise, clipped to the
physiological ranges and min-max normalised. `drop_mask` holds out
`holdout` of each channel's observations (where that is more than one),
`future_vital` is the normalised hour-7 extreme with ~10% NaN, and three
binary outcomes ride along. The arrays come back on the host, where the
program's `ArrayDataset` reads them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

CHANNELS = ("sbp", "dbp", "heartRate", "temperature", "spo2", "respiratory")
RANGES = ((20.0, 300.0), (5.0, 225.0), (0.0, 300.0), (24.0, 45.0), (0.0, 100.0), (0.0, 60.0))
PHENOTYPES = ((135.0, 80.0, 72.0, 36.8, 97.0, 15.0),
              (110.0, 65.0, 95.0, 37.8, 93.0, 22.0),
              (90.0, 55.0, 115.0, 36.2, 88.0, 28.0),
              (150.0, 95.0, 60.0, 36.5, 98.0, 12.0))
CHANNEL_STD = (12.0, 8.0, 9.0, 0.4, 2.0, 3.0)
CHUNK = 8192  # encounters made at a time, to bound the device memory it takes


def _chunk(n: int, t_len: int, hours: float, min_obs: int, holdout: float,
           gen: torch.Generator, dev) -> Dict[str, torch.Tensor]:
    c = len(CHANNELS)
    f32 = dict(device=dev, dtype=torch.float32)
    shift = torch.tensor(PHENOTYPES, **f32)
    std = torch.tensor(CHANNEL_STD, **f32)
    lo = torch.tensor([r[0] for r in RANGES], **f32)
    hi = torch.tensor([r[1] for r in RANGES], **f32)
    pheno = torch.randint(0, len(PHENOTYPES), (n,), generator=gen, device=dev)
    counts = torch.randint(min_obs, t_len + 1, (n, c), generator=gen, device=dev)
    slot = torch.arange(t_len, device=dev)
    mask = (slot < counts[..., None]).to(torch.float32)
    ts = torch.rand((n, c, t_len), generator=gen, **f32) * hours
    ts = torch.sort(torch.where(mask > 0, ts, torch.full_like(ts, float("inf"))), dim=2).values
    ts = torch.where(mask > 0, ts, torch.zeros_like(ts))
    base = shift[pheno] + torch.randn((n, c), generator=gen, **f32) * 0.5 * std
    amp = torch.randn((n, c), generator=gen, **f32) * 0.5 * std
    phase = torch.rand((n, c), generator=gen, **f32) * 2 * np.pi
    vals = (base[..., None] + amp[..., None] * torch.sin(ts / hours * 2 * np.pi + phase[..., None])
            + torch.randn((n, c, t_len), generator=gen, **f32) * 0.6 * std[:, None])
    vals = (torch.minimum(torch.maximum(vals, lo[:, None]), hi[:, None]) - lo[:, None]) \
        / (hi - lo)[:, None]
    feat = vals * mask
    # hold-out: the k = int(holdout * count) lowest-scored observations of a
    # channel, where k > 1
    k = (holdout * counts).to(torch.int64)
    k = torch.where(k > 1, k, torch.zeros_like(k))
    scores = torch.where(mask > 0, torch.rand((n, c, t_len), generator=gen, **f32),
                         torch.full((n, c, t_len), 2.0, **f32))
    kth = torch.gather(torch.sort(scores, dim=2).values, 2,
                       torch.clamp(k - 1, min=0)[..., None])
    dropped = (scores <= kth) & (k[..., None] > 0)
    drop_mask = mask * (~dropped).to(torch.float32)
    nxt = base + torch.randn((n, c), generator=gen, **f32) * 0.3 * std
    nxt = (torch.minimum(torch.maximum(nxt, lo), hi) - lo) / (hi - lo)
    fv = torch.where(torch.rand((n, c), generator=gen, **f32) < 0.9, nxt,
                     torch.full_like(nxt, float("nan")))
    sev = pheno.to(torch.float32) / (len(PHENOTYPES) - 1)
    out = {"feat": feat, "padding_mask": mask, "time_step": ts, "drop_mask": drop_mask,
           "future_vital": fv, "true_phenotype": pheno}
    for task in ("AKI_overall", "mort_status_30d", "ICU"):
        out[task] = (torch.rand((n,), generator=gen, **f32) < 0.05 + 0.4 * sev).to(torch.int64)
    return out


def make(n_encounters: int, shares, t_len: int, seed: int, device, hours: float = 6.0,
         min_obs: int = 4, holdout: float = 0.2) -> Dict[str, Dict[str, np.ndarray]]:
    """{"training": arrays, "validation": arrays} of `int(share * n)`
    encounters each, made on `device` from `seed` and returned on the host,
    read-only (the program reads them; nothing may write into them)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    first = 0
    for cohort, share in zip(("training", "validation"), shares):
        n = int(share * n_encounters)
        parts = [_chunk(min(CHUNK, n - s), t_len, hours, min_obs, holdout, gen, device)
                 for s in range(0, n, CHUNK)]
        arrays = {k: torch.cat([p[k] for p in parts]).cpu().numpy() for k in parts[0]}
        arrays["encounter_id"] = np.arange(first, first + n)
        first += n
        for v in arrays.values():
            v.setflags(write=False)
        out[cohort] = arrays
        del parts
    return out
