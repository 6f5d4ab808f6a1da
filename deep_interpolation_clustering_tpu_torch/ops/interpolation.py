"""Temporal kernel interpolation over irregular timestamps (counterpart of
the JAX `ops/interpolation.py`): the plain PyTorch SCI and CCI layers.

Numerics follow the reference (interpolation_layer.py:31-127):
  * per-channel kernel made positive by softplus `log(1+e^theta)` (:51)
  * masked weights in log space, `+log(mask)` so mask=0 -> -inf (:59)
  * smooth channel = softmax_T-weighted mean of observations (:62-64)
  * intensity channel = logsumexp density (:59)
  * transient channel with the kappa=10 sharpened kernel (:80-83)
  * cross-channel mixing `y_hat = softmax_C(w) * (y - mean) @ K + mean` (:97-113)

`sci_forward` here is the plain version of the SCI kernels in
`ops/cuda_interp.py`; the model reaches those through `cuda_interp.sci`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple, Union

import torch

from .numerics import logsumexp, softplus

# kappa: sharpening factor of the transient (high-pass) channel
# (reference interpolation_layer.py:71,80)
TRANSIENT_KAPPA = 10.0


class Planes(NamedTuple):
    """The four `(B, C, T)` input planes, unstacked."""

    ob: torch.Tensor  # observed values
    mask: torch.Tensor  # padding mask
    ts: torch.Tensor  # timestamps
    ae: torch.Tensor  # autoencoder hold-out mask


def split_planes(x: torch.Tensor, d_dim: int) -> Tuple[torch.Tensor, ...]:
    """Split a stacked `(B, 4C, T)` input into its four `(B, C, T)` planes:
    [0:C] values, [C:2C] padding mask, [2C:3C] timestamps, [3C:4C] hold-out
    mask (reference interpolation_layer.py:26-30)."""
    return (
        x[:, :d_dim, :],
        x[:, d_dim : 2 * d_dim, :],
        x[:, 2 * d_dim : 3 * d_dim, :],
        x[:, 3 * d_dim :, :],
    )


def to_planes(x: Union[torch.Tensor, Planes], d_dim: int) -> Planes:
    """Normalize a stacked `(B, 4C, T)` tensor or a `Planes` to `Planes`."""
    if isinstance(x, Planes):
        return x
    return Planes(*split_planes(x, d_dim))


def reference_times(
    ref_points: int, hours_look_ahead: float, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Uniform reference grid over [0, hours] (reference interpolation_layer.py:41)."""
    return torch.linspace(
        0.0, float(hours_look_ahead), ref_points, dtype=dtype, device=device
    )


def _sci_weights(kernel, mask, t_obs, ref_points, hours_look_ahead):
    """The ob-independent part of SCI: (w, softmax weights, transient w,
    transient softmax weights), each over the `(B, C, T, R)` grid."""
    ref_t = reference_times(ref_points, hours_look_ahead, t_obs.dtype, t_obs.device)
    diff = t_obs[..., None] - ref_t
    norm = diff * diff  # (B, C, T, R)
    alpha = softplus(kernel)
    log_mask = torch.log(mask)  # 0 -> -inf, exactly as the reference (:59)
    logits = -alpha[None, :, None, None] * norm + log_mask[..., None]
    w = logsumexp(logits, dim=2)  # (B, C, R)
    wt = torch.exp(logits - w[:, :, None, :])
    logits_t = TRANSIENT_KAPPA * (-alpha[None, :, None, None] * norm) + log_mask[..., None]
    w_t = logsumexp(logits_t, dim=2)
    wt_t = torch.exp(logits_t - w_t[:, :, None, :])
    return w, wt, wt_t


def _pack(y, w, y_trans) -> torch.Tensor:
    rep = torch.cat([y, w, y_trans], dim=1)  # (B, 3C, R)
    return rep.permute(0, 2, 1)  # (B, R, 3C)


def sci_forward(
    kernel: torch.Tensor,
    x: Union[torch.Tensor, Planes],
    ref_points: int,
    hours_look_ahead: float,
) -> torch.Tensor:
    """SingleChannelInterp: irregular `(B, 4C, T)` (or `Planes`) -> gridded
    `(B, R, 3C)` laid out [smooth y | intensity w | transient y_trans]
    (reference interpolation_layer.py:84-86)."""
    p = to_planes(x, kernel.shape[0])
    w, wt, wt_t = _sci_weights(kernel, p.mask, p.ts, ref_points, hours_look_ahead)
    y = torch.sum(wt * p.ob[..., None], dim=2)
    y_trans = torch.sum(wt_t * p.ob[..., None], dim=2)
    return _pack(y, w, y_trans)


def sci_forward_multi(
    kernel: torch.Tensor,
    xs: Sequence[Union[torch.Tensor, Planes]],
    ref_points: int,
    hours_look_ahead: float,
) -> List[torch.Tensor]:
    """SCI over several streams that share (mask, ts): the ob-independent
    weights are computed once and each stream adds only its weighted sums.
    The caller vouches for the sharing; mask and ts come from the first
    stream."""
    planes = [to_planes(x, kernel.shape[0]) for x in xs]
    w, wt, wt_t = _sci_weights(
        kernel, planes[0].mask, planes[0].ts, ref_points, hours_look_ahead
    )
    return [
        _pack(torch.sum(wt * p.ob[..., None], dim=2), w,
              torch.sum(wt_t * p.ob[..., None], dim=2))
        for p in planes
    ]


def cci_forward(kernel: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """CrossChannelInterp: `(B, R, 3C)` -> `(B, R, 3C)` (reference
    interpolation_layer.py:99-127)."""
    d_dim = kernel.shape[0]
    y = rep[..., :d_dim]  # (B, R, C)
    w = rep[..., d_dim : 2 * d_dim]
    y_trans_in = rep[..., 2 * d_dim : 3 * d_dim]

    intensity = torch.exp(w)
    den = logsumexp(w, dim=2, keepdim=True)  # softmax across channels (:108-110)
    w_sm = torch.exp(w - den)

    mean = torch.mean(y, dim=1, keepdim=True)  # per-channel time mean (:111-112)
    smooth = torch.matmul(w_sm * (y - mean), kernel) + mean  # (:113)
    y_trans = y_trans_in - smooth  # residual high-pass (:122-123)
    return torch.cat([smooth, intensity, y_trans], dim=-1)
