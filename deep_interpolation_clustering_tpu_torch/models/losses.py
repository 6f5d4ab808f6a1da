"""Losses and the loss-mode dispatch (counterpart of the JAX
`models/losses.py`, reference pretrain_interp.py:169-215 and
clustering_interp.py:197-247).

Data-parallel (`parallel.world_size() > 1`), every mean over the batch is
this rank's sum over its rows divided by the count over every rank's rows,
so each loss is the rank's share of the global-batch loss: the shares sum
to it, and each rank back-propagates its own (`train.steps.update` then
sums the gradients over ranks). A rank whose rows are all padding gives a
share of 0. In a world of one the single-device code runs unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import parallel
from ..config import Config


def rec_loss(
    org_ob: torch.Tensor,
    rec_ob: torch.Tensor,
    padding_mask: torch.Tensor,
    sample_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Masked sum-MSE over observed points / #observed (reference :169-175).
    `where`, not multiply, so garbage at unobserved points never reaches the
    sum; `sample_mask` also excludes shape-padding rows."""
    if sample_mask is not None:
        padding_mask = padding_mask * sample_mask[:, None, None]
    obs = padding_mask == 1.0
    diff = torch.where(obs, rec_ob - org_ob, torch.zeros_like(rec_ob))
    mse = torch.sum(torch.square(diff)) / parallel.all_sum(torch.sum(obs))
    return {"loss": mse, "ae_mse": mse}


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        if parallel.world_size() == 1:
            return torch.mean(x)
        return torch.sum(x) / (x.numel() * parallel.world_size())
    return (torch.sum(torch.where(mask > 0, x, torch.zeros_like(x)))
            / parallel.all_sum(torch.sum(mask)))


def bce_with_logits(logits, targets, pos_weight: float,
                    sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F.binary_cross_entropy_with_logits with pos_weight, mean reduced:
    l = -[pw * y * log sigmoid(x) + (1-y) * log(1 - sigmoid(x))]."""
    loss = -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))
    return _masked_mean(loss, sample_mask)


def sup_aux_loss(
    cfg: Config,
    aux_label: Dict[str, torch.Tensor],
    aux_pred: Dict[str, torch.Tensor],
    future_vital_mask: Optional[torch.Tensor],
    sample_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Masked MSE for future-vital regression + weighted BCE for binary
    outcome tasks (reference :177-196)."""
    out: Dict[str, torch.Tensor] = {}
    if "future_vital" in cfg.aux_tasks:
        fv_mask = future_vital_mask
        if sample_mask is not None:
            fv_mask = fv_mask * sample_mask[:, None]
        obs = fv_mask == 1.0
        diff = aux_pred["future_vital"] - aux_label["future_vital"]
        diff = torch.where(obs, diff, torch.zeros_like(diff))
        out["future_vital"] = (torch.sum(torch.square(diff))
                               / parallel.all_sum(torch.sum(obs)))
    for task in cfg.aux_tasks:
        if task == "future_vital":
            continue
        out[task] = bce_with_logits(
            aux_pred[task], aux_label[task], cfg.aux_pos_weights[task], sample_mask
        )
    return out


def fake_det_loss(label: torch.Tensor, log_probs: torch.Tensor,
                  row_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """NLL over log-softmax outputs, mean reduced (reference :198-200)."""
    picked = torch.gather(log_probs, 1, label[:, None].long())[:, 0]
    return {"fake_detection": -_masked_mean(picked, row_mask)}


def kl_loss(label: torch.Tensor, pred: torch.Tensor,
            sample_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Batch-mean KL(p || q), torch's `F.kl_div(pred.log(), label,
    reduction='batchmean')` (reference clustering_interp.py:205-207), in
    the xlogy form so that a label of 0 gives 0; the mean runs over the
    rows `sample_mask` marks real."""
    pointwise = torch.xlogy(label, label) - label * torch.log(pred)
    per_row = torch.sum(pointwise, dim=1)
    if sample_mask is None:
        return {"kl": torch.sum(per_row) / (label.shape[0] * parallel.world_size())}
    per_row = torch.where(sample_mask > 0, per_row, torch.zeros_like(per_row))
    return {"kl": torch.sum(per_row) / parallel.all_sum(torch.sum(sample_mask))}


def triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                 margin: float, sample_mask: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """torch's `F.triplet_margin_loss`: mean(relu(d(a, p) - d(a, n) +
    margin)), d the L2 distance with eps 1e-6 added to the difference
    (reference clustering_interp.py:234-236)."""
    eps = 1e-6

    def dist(a, b):
        return torch.sqrt(torch.sum(torch.square(a - b + eps), dim=-1))

    losses = torch.relu(dist(anchor, positive) - dist(anchor, negative) + margin)
    return {"triplet": _masked_mean(losses, sample_mask)}


def multi_task_loss(task_weights: Dict[str, float],
                    rec_loss_dict: Dict[str, torch.Tensor],
                    aux_loss_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """loss = ae_mse + sum_i w_i * loss_i (reference :206-215)."""
    loss = rec_loss_dict["ae_mse"]
    for name, value in aux_loss_dict.items():
        loss = loss + task_weights[name] * value
    out = dict(rec_loss_dict)
    out["loss"] = loss
    out.update(aux_loss_dict)
    return out


def compute_losses(
    cfg: Config,
    ob: torch.Tensor,
    padding_mask: torch.Tensor,
    net_out,
    aux_label: Dict[str, torch.Tensor],
    future_vital_mask: Optional[torch.Tensor],
    fake_det_label: Optional[torch.Tensor],
    sample_mask: Optional[torch.Tensor] = None,
    fake_row_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Dispatch on `cfg.loss_components`."""
    comps = cfg.loss_components
    rec = rec_loss(ob, net_out.rec, padding_mask, sample_mask)
    if not comps:
        return rec
    task_weights: Dict[str, float] = {}
    task_losses: Dict[str, torch.Tensor] = {}
    if "sup" in comps:
        task_weights.update(cfg.aux_tasks)
        task_losses.update(
            sup_aux_loss(cfg, aux_label, net_out.aux, future_vital_mask, sample_mask)
        )
    if "fake" in comps:
        task_weights.update(cfg.unsup_aux_tasks)
        task_losses.update(
            fake_det_loss(fake_det_label, net_out.aux["fake_det"], fake_row_mask)
        )
    if "triplet" in comps:
        task_weights.update(cfg.unsup_aux_tasks)
        task_losses.update(
            triplet_loss(net_out.hidden, net_out.aux["positive"], net_out.aux["negative"],
                         cfg.triple_margin, sample_mask)
        )
    if "kl" in comps:
        task_weights.update(cfg.unsup_aux_tasks)
        task_losses.update(
            kl_loss(net_out.aux["cluster_label"], net_out.aux["cluster_pred"], sample_mask)
        )
    return multi_task_loss(task_weights, rec, task_losses)
