"""Hand-written CUDA kernels for the interpolation hot ops (counterpart of
the JAX `ops/pallas_interp.py`).

  K2 `sci_fwd`   (csrc/sci.cu)  SCI forward          <- `_sci_kernel`
  K3 `sci_bwd`   (csrc/sci.cu)  SCI backward         <- `_sci_bwd_kernel`
  K4 `rbf_push_k`(csrc/rbf.cu)  gaussian RBF push    <- `_rbf_kernel`

Each works on (B, C) flattened into rows, row = b*C + c, over T slots, and
has a plain PyTorch version of the same function on the same layout (used
for CPU tensors and as the kernel's yardstick on the card).

`SCIFunction` holds the forward kernel and the backward kernel in one
`torch.autograd.Function`. (In the JAX package the two are mutually
exclusive config flags because the Pallas forward carries its own XLA-replay
VJP; PyTorch needs no such split.) `RBFFunction` runs K4 forward and takes
its backward by PyTorch autodiff of the plain formula, as the JAX package
takes XLA autodiff of `_rbf_jnp_reference`.

The kernels and their plain versions take float32 only. `sci` and
`rbf_push` upcast every float input (the bfloat16 `compute_dtype`) outside
the autograd functions, so the backward kernel sees float32 cotangents and
the gradient of a bfloat16 input comes back bfloat16, and cast the output to
the inputs' common type, which is the type the JAX functions return; the
reference grid is float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _cuda_build as cb
from .interpolation import TRANSIENT_KAPPA, reference_times
from .numerics import result_type, softplus
from .rbf import RBF_NORM_EPS

_MAX_REF_POINTS = 8  # the kernels unroll R up to this
# The profiler range around RBFFunction's backward, which recomputes the push
# in plain PyTorch (utils/profiling.py reads its device time)
RBF_BACKWARD_RANGE = "rbf_push_backward"

# The layout of K2, K3 and K4; the constants are csrc/sci.cu's (and
# csrc/rbf.cu's, which states them again).
SCI_BWD_THREADS = 128  # kBwdThreads: threads per block
SCI_BWD_WARP_SLOTS = 2  # kBwdWarpSlots: a warp takes a row of up to 32 x this slots
SCI_BWD_BLOCK_SLOTS = 3  # kBwdBlockSlots: a block holds a row of up to 128 x this slots


# ------------------------------------------------------------ plain versions
def _split_cotangent(g: torch.Tensor, n_chan: int):
    """(B, R, 3C) -> gy, gw, gyt, each (rows, R) with row = b*C + c."""
    b, r, _ = g.shape
    g = g.reshape(b, r, 3, n_chan).permute(0, 3, 2, 1).reshape(b * n_chan, 3, r)
    return g[:, 0], g[:, 1], g[:, 2]


def _softmax_t(logits):
    """Softmax over T as the kernels take it, `e / sum(e)` with
    `e = exp(logits - max)`, and the logsumexp `max + log(sum(e))`.
    Dividing by the sum (not `exp(logits - logsumexp)`) keeps sum_T p = 1
    to rounding, which the backward's `x - y` differences need when one
    slot dominates a row."""
    m = torch.amax(logits, dim=1, keepdim=True)
    e = torch.exp(logits - m)
    s = torch.sum(e, dim=1, keepdim=True)
    return e / s, (m + torch.log(s))[:, 0]


def _sci_softmaxes(x, t, mask, alpha, ref_t):
    """The (rows, T, R) softmax weights p, q, the distances d and the
    (rows, R) intensity w of both SCI chains."""
    rows = x.shape[0]
    alpha_rows = alpha.repeat(rows // alpha.shape[0])[:, None, None]
    d = t[..., None] - ref_t  # (rows, T, R)
    l = -alpha_rows * (d * d)
    neg = torch.where(mask > 0, 0.0, float("-inf"))[..., None]
    p, w = _softmax_t(l + neg)
    q, _ = _softmax_t(TRANSIENT_KAPPA * l + neg)
    return p, q, d, w


def _pack_rows(y, w, yt, n_chan):
    """(rows, R) x3 -> (B, R, 3C) [y | w | yt], channel-major."""
    rows, r = y.shape
    out = torch.stack([y, w, yt], dim=1)  # (rows, 3, R)
    return out.reshape(rows // n_chan, n_chan, 3, r).permute(0, 3, 2, 1).reshape(
        rows // n_chan, r, 3 * n_chan)


def _sci_fwd_plain(x, t, mask, alpha, ref_t):
    """Plain version of K2: (rows, T) planes, alpha (C,), ref_t (R,) ->
    (B, R, 3C)."""
    p, q, _, w = _sci_softmaxes(x, t, mask, alpha, ref_t)
    y = torch.sum(p * x[..., None], dim=1)
    yt = torch.sum(q * x[..., None], dim=1)
    return _pack_rows(y, w, yt, alpha.shape[0])


def _sci_bwd_plain(x, t, mask, alpha, ref_t, g, need_planes: bool):
    """Plain version of K3, the SCI VJP written out (the math of the JAX
    `_sci_bwd_kernel`). Returns (dx, dt, dm, dalpha): dalpha (rows,), the
    planes (rows, T) or None unless `need_planes`."""
    n_chan = alpha.shape[0]
    p, q, d, _ = _sci_softmaxes(x, t, mask, alpha, ref_t)
    gy, gw, gyt = (a[:, None, :] for a in _split_cotangent(g, n_chan))
    xe = x[..., None]
    y = torch.sum(p * xe, dim=1, keepdim=True)
    yt = torch.sum(q * xe, dim=1, keepdim=True)
    glog = p * (gw + gy * (xe - y))
    glogt = q * (gyt * (xe - yt))
    gl = glog + TRANSIENT_KAPPA * glogt
    dalpha = -torch.sum(gl * (d * d), dim=(1, 2))
    if not need_planes:
        return None, None, None, dalpha
    alpha_rows = alpha.repeat(x.shape[0] // n_chan)[:, None, None]
    dx = torch.sum(gy * p + gyt * q, dim=2)
    dt = torch.sum(-2.0 * alpha_rows * d * gl, dim=2)
    dm = torch.sum(glog + glogt, dim=2)
    return dx, dt, dm, dalpha


def _rbf_plain(t, m, proj, beta, ref_t):
    """Plain version of K4: t, m (rows, T); proj (rows, R); beta (C,) ->
    (rows, T)."""
    rows = t.shape[0]
    beta_rows = beta.repeat(rows // beta.shape[0])[:, None, None]
    d = t[..., None] - ref_t  # (rows, T, R)
    phi = torch.exp(-beta_rows * (d * d)) * m[..., None]
    num = torch.sum(phi * proj[:, None, :], dim=-1)
    den = torch.sum(phi, dim=-1)
    return num / (den + RBF_NORM_EPS) * m


# ------------------------------------------------------------------ launches
def _check_rows(name, x, n_chan, ref_t, *planes):
    rows, t_len = x.shape
    if rows < 1 or t_len < 1:
        raise ValueError(f"{name}: empty planes ({rows}, {t_len})")
    if rows % n_chan:
        raise ValueError(f"{name}: {rows} rows are not a multiple of C={n_chan}")
    r = ref_t.shape[0]
    if not 1 <= r <= _MAX_REF_POINTS:
        raise ValueError(f"{name}: R={r} outside 1..{_MAX_REF_POINTS}")
    cb.check(f"{name} ref_t", ref_t, torch.float32, (r,))
    for i, p in enumerate((x,) + planes):
        cb.check(f"{name} plane {i}", p, torch.float32, (rows, t_len))
    return rows, t_len, r


def _sci_fwd_launch(x, t, mask, alpha, ref_t):
    n_chan = alpha.shape[0]
    rows, t_len, r = _check_rows("sci_fwd", x, n_chan, ref_t, t, mask)
    cb.check("sci_fwd alpha", alpha, torch.float32, (n_chan,))
    out = torch.empty((rows // n_chan, r, 3 * n_chan), dtype=x.dtype, device=x.device)
    warps, slots = sci_row_layout(t_len)
    fn = cb.c_function("sci", "dicl_sci_fwd", 6, 6)
    cb.raise_on_error("sci_fwd", fn(
        cb.ptr(x), cb.ptr(t), cb.ptr(mask), cb.ptr(alpha), cb.ptr(ref_t),
        cb.ptr(out), rows, n_chan, t_len, r, warps, slots, cb.stream_of(x),
    ))
    return out


def sci_row_layout(t_len: int) -> Tuple[int, int]:
    """The layout of K2, K3 and K4 for rows of `t_len` slots, as csrc/sci.cu
    and csrc/rbf.cu choose and check it -> (warps a row, slots a thread keeps in
    registers). A warp takes a short row (four rows a block); a block of
    SCI_BWD_THREADS threads takes a longer one; each thread holds its slots'
    x, t and mask (K3: and exponentials) in registers. 0 slots: the row is
    too long for that, and the block loops over it (K3 recomputes the
    exponentials)."""
    if t_len <= 32 * SCI_BWD_WARP_SLOTS:
        return 1, -(-t_len // 32)
    if t_len <= SCI_BWD_THREADS * SCI_BWD_BLOCK_SLOTS:
        return SCI_BWD_THREADS // 32, -(-t_len // SCI_BWD_THREADS)
    return SCI_BWD_THREADS // 32, 0


def _sci_bwd_launch(x, t, mask, alpha, ref_t, g, need_planes: bool):
    n_chan = alpha.shape[0]
    rows, t_len, r = _check_rows("sci_bwd", x, n_chan, ref_t, t, mask)
    cb.check("sci_bwd alpha", alpha, torch.float32, (n_chan,))
    cb.check("sci_bwd g", g, torch.float32, (rows // n_chan, r, 3 * n_chan))
    dalpha = torch.empty((rows,), dtype=x.dtype, device=x.device)
    dx = dt = dm = None
    if need_planes:
        dx, dt, dm = (torch.empty_like(x) for _ in range(3))
    warps, slots = sci_row_layout(t_len)
    fn = cb.c_function("sci", "dicl_sci_bwd", 10, 6)
    cb.raise_on_error("sci_bwd", fn(
        cb.ptr(x), cb.ptr(t), cb.ptr(mask), cb.ptr(alpha), cb.ptr(ref_t),
        cb.ptr(g), cb.ptr(dx), cb.ptr(dt), cb.ptr(dm), cb.ptr(dalpha),
        rows, n_chan, t_len, r, warps, slots, cb.stream_of(x),
    ))
    return dx, dt, dm, dalpha


def _rbf_launch(t, m, proj, beta, ref_t):
    n_chan = beta.shape[0]
    rows, t_len, r = _check_rows("rbf_push", t, n_chan, ref_t, m)
    cb.check("rbf_push proj", proj, torch.float32, (rows, r))
    cb.check("rbf_push beta", beta, torch.float32, (n_chan,))
    out = torch.empty_like(t)
    warps, slots = sci_row_layout(t_len)  # K4 takes K2's and K3's layout
    fn = cb.c_function("rbf", "dicl_rbf_push", 6, 6)
    cb.raise_on_error("rbf_push", fn(
        cb.ptr(t), cb.ptr(m), cb.ptr(proj), cb.ptr(beta), cb.ptr(ref_t),
        cb.ptr(out), rows, n_chan, t_len, r, warps, slots, cb.stream_of(t),
    ))
    return out


_PALLAS_INTERP = "deep_interpolation_clustering_tpu/ops/pallas_interp.py"
_SCI_SOURCE = "deep_interpolation_clustering_tpu_torch/csrc/sci.cu"

sci_fwd = cb.register(cb.KernelWrapper(
    "sci_forward", _SCI_SOURCE, f"{_PALLAS_INTERP}:58", _sci_fwd_plain, _sci_fwd_launch))
sci_bwd = cb.register(cb.KernelWrapper(
    "sci_backward", _SCI_SOURCE, f"{_PALLAS_INTERP}:265", _sci_bwd_plain, _sci_bwd_launch))
rbf_push_k = cb.register(cb.KernelWrapper(
    "rbf_push", "deep_interpolation_clustering_tpu_torch/csrc/rbf.cu",
    f"{_PALLAS_INTERP}:162", _rbf_plain, _rbf_launch))


# --------------------------------------------------------- autograd functions
class SCIFunction(torch.autograd.Function):
    """SCI with K2 as the forward and K3 as the backward.
    Inputs: kernel (C,), planes ob, mask, ts (B, C, T), ref_t (R,)."""

    @staticmethod
    def forward(ctx, kernel, ob, mask, ts, ref_t):
        b, c, t_len = ob.shape
        rows = lambda a: a.contiguous().reshape(b * c, t_len)
        x2, m2, t2 = rows(ob), rows(mask), rows(ts)
        ctx.save_for_backward(kernel, x2, m2, t2, ref_t)
        ctx.plane_shape = (b, c, t_len)
        return sci_fwd(x2, t2, m2, softplus(kernel), ref_t)

    @staticmethod
    def backward(ctx, g):
        kernel, x2, m2, t2, ref_t = ctx.saved_tensors
        need = ctx.needs_input_grad
        need_planes = any(need[1:4])
        dx, dt, dm, dalpha = sci_bwd(x2, t2, m2, softplus(kernel), ref_t,
                                     g.contiguous(), need_planes)
        b, c, t_len = ctx.plane_shape
        dkernel = None
        if need[0]:
            dkernel = torch.sum(dalpha.reshape(b, c), dim=0) * torch.sigmoid(kernel)
        shaped = lambda a, n: a.reshape(b, c, t_len) if n else None
        # mask cotangent: 0 where mask = 0 (autodiff of log(mask) gives NaN)
        return (dkernel, shaped(dx, need[1]), shaped(dm, need[2]),
                shaped(dt, need[3]), None)


class RBFFunction(torch.autograd.Function):
    """Gaussian RBF push with K4 as the forward. Inputs: kernel (C,),
    proj (B, C, R), mask, ts (B, C, T), ref_t (R,). Gradients go to
    kernel and proj."""

    @staticmethod
    def forward(ctx, kernel, proj, mask, ts, ref_t):
        b, c, t_len = mask.shape
        m2 = mask.contiguous().reshape(b * c, t_len)
        t2 = ts.contiguous().reshape(b * c, t_len)
        p2 = proj.contiguous().reshape(b * c, -1)
        ctx.save_for_backward(kernel, p2, m2, t2, ref_t)
        ctx.proj_shape = proj.shape
        return rbf_push_k(t2, m2, p2, softplus(kernel), ref_t).reshape(b, c, t_len)

    @staticmethod
    def backward(ctx, g):
        kernel, p2, m2, t2, ref_t = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad(), torch.profiler.record_function(RBF_BACKWARD_RANGE):
            k = kernel.detach().requires_grad_(need[0])
            p = p2.detach().requires_grad_(need[1])
            out = _rbf_plain(t2, m2, p, softplus(k), ref_t)
            wrt = [a for a, n in ((k, need[0]), (p, need[1])) if n]
            grads = list(torch.autograd.grad(out, wrt, g.reshape(out.shape)))
        dk = grads.pop(0) if need[0] else None
        dp = grads.pop(0).reshape(ctx.proj_shape) if need[1] else None
        return dk, dp, None, None, None


# ------------------------------------------------------------ public entries
def _float32(*xs: torch.Tensor):
    """The inputs upcast to float32, and their common type (the output's)."""
    return [x.to(torch.float32) for x in xs], result_type(*xs)


def sci(kernel: torch.Tensor, ob: torch.Tensor, mask: torch.Tensor,
        ts: torch.Tensor, ref_points: int, hours_look_ahead: float) -> torch.Tensor:
    """SCI of one stream through K2/K3 -> (B, R, 3C), in the inputs' common
    type (computed in float32)."""
    ins, dtype = _float32(kernel, ob, mask, ts)
    ref_t = reference_times(ref_points, hours_look_ahead, torch.float32, ob.device)
    return SCIFunction.apply(*ins, ref_t).to(dtype)


def rbf_push(kernel: torch.Tensor, proj: torch.Tensor, mask: torch.Tensor,
             ts: torch.Tensor, ref_points: int, hours_look_ahead: float) -> torch.Tensor:
    """Gaussian RBF push through K4 -> (B, C, T), in the inputs' common type
    (computed in float32)."""
    ins, dtype = _float32(kernel, proj, mask, ts)
    ref_t = reference_times(ref_points, hours_look_ahead, torch.float32, ts.device)
    return RBFFunction.apply(*ins, ref_t).to(dtype)
