"""RBF decoder: gridded decoder states -> values at irregular timestamps
(counterpart of the JAX `ops/rbf.py`).

A TimeDistributed CompressFC trunk (run by `models.net.Net`, alone or fused
with the heads) projects the `(B, R, 2H)` decoder outputs to per-channel
values at the R reference points; softplus-positive
per-channel RBF weights over |t_obs - ref_t| push them back onto each
channel's observed timestamps, normalized by the summed masked weights
(`+ 1e-10`) and re-masked (reference rbf.py:57-125). All 11 bases are here;
the model uses 'gaussian', whose push runs through the hand-written kernel
(`ops/cuda_interp.rbf_push`) unless the caller asks for the plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from .interpolation import Planes, reference_times, to_planes
from .nn import Head, uniform_
from .numerics import softplus

RBF_NORM_EPS = 1e-10  # reference rbf.py:107


# ------------------------------------------------------- basis functions
def gaussian(beta, alpha):
    return torch.exp(-beta * torch.square(alpha))


def linear(beta, alpha):
    return alpha


def quadratic(beta, alpha):
    return torch.square(alpha)


def inverse_quadratic(beta, alpha):
    return 1.0 / (1.0 + torch.square(alpha))


def multiquadric(beta, alpha):
    return torch.sqrt(1.0 + torch.square(alpha))


def inverse_multiquadric(beta, alpha):
    return 1.0 / torch.sqrt(1.0 + torch.square(alpha))


def spline(beta, alpha):
    return torch.square(alpha) * torch.log(alpha + 1.0)


def poisson_one(beta, alpha):
    return (alpha - 1.0) * torch.exp(-alpha)


def poisson_two(beta, alpha):
    return ((alpha - 2.0) / 2.0) * alpha * torch.exp(-alpha)


def matern32(beta, alpha):
    return (1.0 + 3**0.5 * alpha) * torch.exp(-(3**0.5) * alpha)


def matern52(beta, alpha):
    return (1.0 + 5**0.5 * alpha + (5.0 / 3.0) * torch.square(alpha)) * torch.exp(
        -(5**0.5) * alpha
    )


def basis_func_dict() -> Dict[str, Callable]:
    return {
        "gaussian": gaussian,
        "linear": linear,
        "quadratic": quadratic,
        "inverse quadratic": inverse_quadratic,
        "multiquadric": multiquadric,
        "inverse multiquadric": inverse_multiquadric,
        "spline": spline,
        "poisson one": poisson_one,
        "poisson two": poisson_two,
        "matern32": matern32,
        "matern52": matern52,
    }


# ----------------------------------------------------------- RBF decoder
class TimeDistributed(nn.Module):
    """Holds the wrapped trunk as `.module`, the reference's name; the
    caller flattens (B, R) into rows."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module


class RBFDecoder(nn.Module):
    """Parameters of the RBF decoder (the JAX `rbf_init`): the per-channel
    `kernel` ~ U[0,1) (reference rbf.py:50) and the CompressFC trunk."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int = 128):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(out_dim))
        self.compress_fc = TimeDistributed(Head(in_dim, hidden, out_dim, relu=True))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        uniform_(self.kernel, 0.0, 1.0, generator)
        self.compress_fc.module.reset_parameters(generator)


def rbf_push(
    kernel: torch.Tensor,
    proj: torch.Tensor,
    raw_input: Union[torch.Tensor, Planes],
    ref_points: int,
    hours_look_ahead: float,
    basis: str = "gaussian",
    use_kernel: bool = True,
) -> torch.Tensor:
    """Push per-channel values `proj: (B, C, R)` at the reference points
    back onto each channel's observed timestamps -> `(B, C, T)`.
    The gaussian basis goes through `cuda_interp.rbf_push` (the kernel on
    the card, its plain version on the CPU) unless `use_kernel=False`."""
    out_dim = kernel.shape[0]
    planes = to_planes(raw_input, out_dim)
    if use_kernel and basis == "gaussian":
        from .cuda_interp import rbf_push as rbf_push_kernel

        return rbf_push_kernel(
            kernel, proj, planes.mask, planes.ts, ref_points, hours_look_ahead
        )

    m, t_obs = planes.mask, planes.ts
    ref_t = reference_times(ref_points, hours_look_ahead, t_obs.dtype, t_obs.device)
    distances = torch.abs(t_obs[..., None] - ref_t)  # (B, C, T, R) (:76)
    beta = softplus(kernel)  # (:78)
    phi = basis_func_dict()[basis](beta[None, :, None, None], distances)
    phi = phi * m[..., None]  # mask out padded observations (:96)
    norm = torch.sum(phi, dim=-1)  # (B, C, T)
    y = torch.sum(phi * proj[:, :, None, :], dim=-1)
    return y / (norm + RBF_NORM_EPS) * m  # (:107)
