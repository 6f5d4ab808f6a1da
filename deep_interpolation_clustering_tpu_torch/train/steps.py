"""Train and eval steps (counterpart of the JAX `train/steps.py`).

Building a step's inputs and applying the update are separate functions,
so a test can hand the JAX `build_inputs` outputs to the port's `update`.
Every draw comes from an explicit `torch.Generator` on the batch's device,
or from `draws` when the caller supplies them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..config import Config
from ..data.loader import augment_batch, make_fake_ob
from ..models.losses import compute_losses
from ..models.net import Net
from ..ops.interpolation import Planes
from .optim import clip_grad_global_norm_


def gather_batch(data: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Batch assembly from a device-resident cohort: one index_select per
    plane (the JAX `gather_batch`)."""
    return {k: torch.index_select(v, 0, idx) for k, v in data.items()}


def build_inputs(
    cfg: Config,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    train: bool,
    denoise: bool,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    use_kernels: bool = True,
) -> Dict[str, Any]:
    """Assemble the model inputs from a batch (reference
    pretrain_trainer.py:130-185): re-masked `ob`, optional denoising
    (`ob * ae_mask` as input, the loss target stays `ob`), the fake batch
    and the permuted real/fake labels.

    `draws` may hold any of `aug_noise`, `fake_bits`, `fake_noise`,
    `fake_aug_noise` ((B, C, T) or (2, B, C, T) tensors) and `perm` ((2B,)
    int64); what it lacks is drawn from `generator` in that order.
    """
    if cfg.triple_margin != 0.0:
        raise NotImplementedError("the triplet stream comes with the p3 slice")
    draws = draws or {}
    ob_raw = batch["ob"]
    padding_mask = batch["padding_mask"]
    ts_raw = batch["timestamp"]
    ae_mask = batch["ae_mask"]

    ob, timestamp = ob_raw, ts_raw
    if train and cfg.aug_input:
        ob, timestamp = augment_batch(ob_raw, ts_raw, padding_mask, cfg.aug_std,
                                      draws.get("aug_noise"), generator)
    ob = ob * padding_mask

    def planes(o, t):
        return Planes(o * ae_mask if denoise else o, padding_mask, t, ae_mask)

    sample_mask = batch.get("sample_mask")
    out: Dict[str, Any] = {
        "x": planes(ob, timestamp),
        "ob": ob,
        "padding_mask": padding_mask,
        "fake_x": None,
        "fake_perm_idx": None,
        "fake_det_label": None,
        "fake_row_mask": None,
        "sample_mask": sample_mask,
    }
    if cfg.fake_detection:
        # fakes come from the RAW ob; the streams are augmented independently
        fake_ob = make_fake_ob(
            ob_raw, padding_mask, cfg.scale, draws.get("fake_bits"),
            draws.get("fake_noise"), generator, cfg.rng_draw_bits, use_kernels,
        )
        fake_ts = ts_raw
        if train and cfg.aug_input:
            fake_ob, fake_ts = augment_batch(fake_ob, ts_raw, padding_mask, cfg.aug_std,
                                             draws.get("fake_aug_noise"), generator)
        out["fake_x"] = planes(fake_ob * padding_mask, fake_ts)
        b = ob.shape[0]
        perm = draws.get("perm")
        if perm is None:
            perm = torch.randperm(2 * b, generator=generator, device=ob.device)
        label = torch.cat([torch.ones(b, dtype=torch.long, device=ob.device),
                           torch.zeros(b, dtype=torch.long, device=ob.device)])
        out["fake_perm_idx"] = perm
        out["fake_det_label"] = label[perm]
        if sample_mask is not None:
            out["fake_row_mask"] = torch.cat([sample_mask, sample_mask])[perm]

    out["aux_label"] = {t: batch[t] for t in cfg.aux_tasks if t in batch}
    out["future_vital_mask"] = batch.get("future_vital_mask")
    return out


def forward_and_losses(net: Net, cfg: Config, inputs: Dict[str, Any], train: bool,
                       generator: Optional[torch.Generator], use_kernels: bool = True):
    net_out = net(
        inputs["x"], inputs["fake_x"], inputs["fake_perm_idx"], train=train,
        generator=generator, sample_mask=inputs["sample_mask"], use_kernels=use_kernels,
    )
    losses = compute_losses(
        cfg, inputs["ob"], inputs["padding_mask"], net_out, inputs["aux_label"],
        inputs["future_vital_mask"], inputs["fake_det_label"],
        inputs["sample_mask"], inputs["fake_row_mask"],
    )
    return net_out, losses


def update(net: Net, opt: torch.optim.Optimizer, cfg: Config, inputs: Dict[str, Any],
           generator: Optional[torch.Generator], use_kernels: bool = True
           ) -> Dict[str, torch.Tensor]:
    """forward -> losses -> backward -> global-norm clip -> optimizer step.
    `generator` draws the dropout masks. Returns the detached losses.
    `use_kernels=False` runs the plain versions of every kernel, on any
    device (how `chip_smoke.py` holds the kernels' step against a plain one)."""
    opt.zero_grad(set_to_none=True)
    _, losses = forward_and_losses(net, cfg, inputs, True, generator, use_kernels)
    losses["loss"].backward()
    if cfg.grad_clip and cfg.grad_clip > 0:
        clip_grad_global_norm_(net.parameters(), cfg.grad_clip)
    opt.step()
    return {k: v.detach() for k, v in losses.items()}


def train_step(net: Net, opt: torch.optim.Optimizer, cfg: Config,
               batch: Dict[str, torch.Tensor], generator: torch.Generator,
               denoise: bool = False) -> Dict[str, torch.Tensor]:
    """One training step on a batch."""
    inputs = build_inputs(cfg, batch, generator, True, denoise)
    return update(net, opt, cfg, inputs, generator)


@torch.no_grad()
def eval_step(net: Net, cfg: Config, batch: Dict[str, torch.Tensor],
              generator: torch.Generator, denoise: bool = False):
    """Eval forward (`train=False`): returns (losses, outputs) with the
    latent `hidden`, `rec_ob` and the per-sample aux predictions."""
    inputs = build_inputs(cfg, batch, generator, False, denoise)
    net_out, losses = forward_and_losses(net, cfg, inputs, False, None)
    outputs = {"hidden": net_out.hidden, "rec_ob": net_out.rec}
    outputs.update({k: v for k, v in net_out.aux.items() if k != "fake_det"})
    return losses, outputs
