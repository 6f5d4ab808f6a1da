"""Train and eval steps (counterpart of the JAX `train/steps.py`).

Building a step's inputs and applying the update are separate functions,
so a test can hand the JAX `build_inputs` outputs to the port's `update`.
Every draw comes from an explicit `torch.Generator` on the batch's device,
or from `draws` when the caller supplies them.

Data-parallel (`parallel.world_size() > 1`), the batch is this rank's rows
of the global batch. Every draw is taken at the global batch's shape, in
the single-device order, from the generator every rank seeds alike, and
the rank keeps its rows, so its draws are those rows of the single-device
draws; the fake/real permutation stays global. The losses a rank computes
are its shares (`models.losses`); `update` sums the gradients over ranks
before the global-norm clip, so every rank takes the same optimizer step,
and `update` and `eval_step` return the global losses.

`compute_dtype="bfloat16"` (the JAX `_compute_cast`): `train_step` casts the
batch's float planes and `update` runs the forward on bfloat16 copies of
the float parameters, made through autograd, so the gradients land float32
on the float32 parameters; the losses come back float32, the BatchNorm
running statistics stay float32 buffers, and the clip and the optimizer
run in float32. Mixed operands then meet as in JAX: the fake stream's
`ob` is float32 (float32 noise in a bfloat16 plane), so at the default
Config the encoder, decoder and heads compute in float32 against bfloat16
weights. Eval forwards and dumps stay float32, as in JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import parallel
from ..config import Config
from ..data.loader import augment_batch, draw_bits, draw_dtype, make_fake_ob
from ..models.losses import compute_losses
from ..models.net import Net
from ..ops.interpolation import Planes
from .optim import clip_grad_global_norm_


def gather_batch(data: Dict[str, torch.Tensor], idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Batch assembly from a device-resident cohort: one index_select per
    plane (the JAX `gather_batch`)."""
    return {k: torch.index_select(v, 0, idx) for k, v in data.items()}


def global_draws(cfg: Config, ob: torch.Tensor, generator: Optional[torch.Generator],
                 train: bool, draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's rows of the draws `build_inputs` takes, each drawn at the
    global batch's shape in the single-device order unless `draws` holds it
    (at that shape); `perm` stays global."""
    width = cfg.rng_draw_bits
    shape = (ob.shape[0] * parallel.world_size(),) + tuple(ob.shape[1:])
    out: Dict[str, torch.Tensor] = {}

    def take(name, draw):
        out[name] = draws[name] if name in draws else draw()

    def normal():
        return torch.randn((2,) + shape, generator=generator, device=ob.device,
                           dtype=draw_dtype(width))

    if train and cfg.aug_input:
        take("aug_noise", normal)
    if cfg.fake_detection:
        take("fake_bits", lambda: draw_bits(shape, generator, ob.device, width))
        take("fake_noise", lambda: torch.rand(shape, generator=generator, device=ob.device,
                                              dtype=draw_dtype(width)))
        if train and cfg.aug_input:
            take("fake_aug_noise", normal)
        take("perm", lambda: torch.randperm(2 * shape[0], generator=generator,
                                            device=ob.device))
        if cfg.triple_margin != 0.0:
            take("pos_noise", normal)
    # the (2, B, C, T) normal draws hold the batch on axis 1
    return {k: v if k == "perm" else parallel.local_rows(v, 1 if v.dim() == 4 else 0)
            for k, v in out.items()}


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
    and the permuted real/fake labels, and with `triple_margin` the triplet
    positive: the re-masked real stream jittered with std `triple_pos_std`,
    never denoised (JAX `steps.py:110-116`).

    `draws` may hold any of `aug_noise`, `fake_bits`, `fake_noise`,
    `fake_aug_noise`, `pos_noise` ((B, C, T) or (2, B, C, T) tensors) and
    `perm` ((2B,) int64); what it lacks is drawn from `generator` in the
    order `aug_noise`, `fake_bits`, `fake_noise`, `fake_aug_noise`, `perm`,
    `pos_noise`.
    """
    draws = draws or {}
    if parallel.world_size() > 1:
        draws = global_draws(cfg, batch["ob"], generator, train, draws)
    ob_raw = batch["ob"]
    padding_mask = batch["padding_mask"]
    ts_raw = batch["timestamp"]
    ae_mask = batch["ae_mask"]

    ob, timestamp = ob_raw, ts_raw
    if train and cfg.aug_input:
        ob, timestamp = augment_batch(ob_raw, ts_raw, padding_mask, cfg.aug_std,
                                      draws.get("aug_noise"), generator, cfg.rng_draw_bits)
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
        "positive_x": None,
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
                                             draws.get("fake_aug_noise"), generator,
                                             cfg.rng_draw_bits)
        out["fake_x"] = planes(fake_ob * padding_mask, fake_ts)
        perm = draws.get("perm")
        if perm is None:
            perm = torch.randperm(2 * ob.shape[0], generator=generator, device=ob.device)
        b = perm.shape[0] // 2  # the global batch
        label = torch.cat([torch.ones(b, dtype=torch.long, device=ob.device),
                           torch.zeros(b, dtype=torch.long, device=ob.device)])
        out["fake_perm_idx"] = perm
        out["fake_det_label"] = parallel.local_rows(label[perm])
        if sample_mask is not None:
            out["fake_row_mask"] = parallel.permuted_share(sample_mask, sample_mask, perm)
        if cfg.triple_margin != 0.0:
            pos_ob, pos_ts = augment_batch(ob, timestamp, padding_mask, cfg.triple_pos_std,
                                           draws.get("pos_noise"), generator,
                                           cfg.rng_draw_bits)
            out["positive_x"] = Planes(pos_ob, padding_mask, pos_ts, ae_mask)

    out["aux_label"] = {t: batch[t] for t in cfg.aux_tasks if t in batch}
    out["future_vital_mask"] = batch.get("future_vital_mask")
    return out


def compute_dtype(cfg: Config) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def cast_batch(cfg: Config, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The batch's float planes in `cfg.compute_dtype` (the batch itself
    under float32)."""
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        return batch
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in batch.items()}


def compute_params(net: Net, cfg: Config) -> Optional[Dict[str, torch.Tensor]]:
    """The float parameters cast to `cfg.compute_dtype` through autograd, by
    name, for `torch.func.functional_call`; None under float32."""
    dtype = compute_dtype(cfg)
    if dtype == torch.float32:
        return None
    return {n: p.to(dtype) if p.is_floating_point() else p
            for n, p in net.named_parameters()}


def forward_and_losses(net: Net, cfg: Config, inputs: Dict[str, Any], train: bool,
                       generator: Optional[torch.Generator], use_kernels: bool = True,
                       params: Optional[Dict[str, torch.Tensor]] = None):
    """The forward and the losses; with `params`, the forward runs on those
    tensors in place of the net's parameters (the buffers stay the net's)."""
    args = (inputs["x"], inputs["fake_x"], inputs["fake_perm_idx"], inputs["positive_x"])
    kwargs = dict(train=train, generator=generator, sample_mask=inputs["sample_mask"],
                  use_kernels=use_kernels)
    if params is None:
        net_out = net(*args, **kwargs)
    else:
        net_out = torch.func.functional_call(net, params, args, kwargs, strict=False)
    losses = compute_losses(
        cfg, inputs["ob"], inputs["padding_mask"], net_out, inputs["aux_label"],
        inputs["future_vital_mask"], inputs["fake_det_label"],
        inputs["sample_mask"], inputs["fake_row_mask"],
    )
    return net_out, losses


def update(net: Net, opt: torch.optim.Optimizer, cfg: Config, inputs: Dict[str, Any],
           generator: Optional[torch.Generator], use_kernels: bool = True
           ) -> Dict[str, torch.Tensor]:
    """forward (in `cfg.compute_dtype`) -> losses -> backward -> global-norm
    clip -> optimizer step. `inputs` are `build_inputs` of the batch in the
    compute dtype (`train_step` casts it). `generator` draws the dropout
    masks. Returns the detached float32 losses.
    `use_kernels=False` runs the plain versions of every kernel, on any
    device (how `chip_smoke.py` holds the kernels' step against a plain one)."""
    opt.zero_grad(set_to_none=True)
    _, losses = forward_and_losses(net, cfg, inputs, True, generator, use_kernels,
                                   compute_params(net, cfg))
    losses = {k: v.to(torch.float32) for k, v in losses.items()}
    losses["loss"].backward()
    parallel.all_sum_grads_(net.parameters())
    if cfg.grad_clip and cfg.grad_clip > 0:
        clip_grad_global_norm_(net.parameters(), cfg.grad_clip)
    opt.step()
    return global_losses({k: v.detach() for k, v in losses.items()})


def global_losses(losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each rank's loss shares summed over ranks (one collective); the dict
    itself in a world of one."""
    if parallel.world_size() == 1:
        return losses
    keys = list(losses)
    total = parallel.all_sum(torch.stack([losses[k] for k in keys]))
    return {k: total[i] for i, k in enumerate(keys)}


def train_step(net: Net, opt: torch.optim.Optimizer, cfg: Config,
               batch: Dict[str, torch.Tensor], generator: torch.Generator,
               denoise: bool = False) -> Dict[str, torch.Tensor]:
    """One training step on a batch (its float planes cast to
    `cfg.compute_dtype` first)."""
    inputs = build_inputs(cfg, cast_batch(cfg, batch), generator, True, denoise)
    return update(net, opt, cfg, inputs, generator)


@torch.no_grad()
def eval_step(net: Net, cfg: Config, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator], denoise: bool = False,
              sample_mask: Optional[torch.Tensor] = None,
              dump_keys: Optional[Tuple[str, ...]] = None):
    """Eval forward (`train=False`, the JAX `make_eval_step(gather=True,
    dump_keys=...)`): returns (losses, outputs) with the latent `hidden`,
    `rec_ob` and the per-sample aux predictions, only `dump_keys` of them
    when given. `sample_mask` (B,) leaves the padded rows of a short last
    batch out of the losses."""
    if sample_mask is not None:
        batch = dict(batch, sample_mask=sample_mask)
    inputs = build_inputs(cfg, batch, generator, False, denoise)
    net_out, losses = forward_and_losses(net, cfg, inputs, False, None)
    losses = global_losses(losses)
    outputs = {"hidden": net_out.hidden, "rec_ob": net_out.rec}
    # the fake-detection and triplet outputs are not per encounter
    outputs.update({k: v for k, v in net_out.aux.items()
                    if k not in ("fake_det", "positive", "negative")})
    if dump_keys is not None:
        outputs = {k: v for k, v in outputs.items() if k in dump_keys}
    return losses, outputs
