"""mTAN's encoder attention: the shared reference-time queries over each
channel's own observed times, as a hand-written kernel pair and its plain
PyTorch version.

  M1 `mtan_attn_fwd` (csrc/mtan.cu)  the masked softmax and both weighted sums
  M1 `mtan_attn_bwd` (csrc/mtan.cu)  dK, dQ and the values' cotangent

No Pallas kernel stands behind them: the JAX package has no mTAN. A head is
one (encounter, channel) row of the system's planes. For queries `q` (R, D),
the head's keys `k` (T, D), observations `ob` (T,) and mask `mask` (T,):

    s[r, t]    = scale * q[r] . k[t], and -1e9 where mask[t] == 0
    alpha[r]   = softmax over t of s[r]
    out_ob[r]  = sum_t alpha[r, t] * ob[t]
    out_m[r]   = sum_t alpha[r, t] * mask[t]

which is mTAN's `multiTimeAttention` for value columns c and C + c (the
channel's values and its mask, both under its mask) without the scores
repeated over the value columns: no tensor holds both an (R, T) pair and a
value axis. A head with no observed slot averages its T slots uniformly, as
the -1e9 fill does. The forward also returns each row's max and log-sum of
the masked scores, which the backward takes. The backward recomputes the
scores; dQ is summed over the heads in a fixed order (each block's partial,
then the partials in block order), with no float atomics.

`EncoderAttention` holds the pair in one `torch.autograd.Function`;
`encoder_attention` is the entry the model calls. The plain versions take
the same arguments and run wherever the tensors lie on the CPU. The kernels
take R <= MAX_QUERIES, D <= MAX_DIM with D a multiple of 4, float32. Each
call of the pair adds one to the tracer's counter `mtan.attn_launches`,
also while a CUDA graph captures it (`utils.tracing`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import tracing
from . import _cuda_build as cb

# csrc/mtan.cu's constants
MAX_QUERIES = 128  # kR
MAX_DIM = 128  # kD
MASKED = -1e9  # kMasked: mTAN's fill of a masked score
# the persistent grid's most blocks: two on each of the H100's 132 SMs (the
# C entry takes no more than fit on the card at once)
MAX_BLOCKS = 2 * 132
COUNTER = "mtan.attn_launches"


# ------------------------------------------------------------ plain versions
def _masked_scores(q, k, mask, scale: float) -> torch.Tensor:
    """(heads, R, T): scale * q . k, MASKED where the mask is 0."""
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    return s.masked_fill(mask[:, None, :] == 0, MASKED)


def _attn_fwd_plain(q, k, ob, mask, scale: float):
    s = _masked_scores(q, k, mask, scale)
    alpha = torch.softmax(s, dim=-1)
    # the T sum contracts alpha against the two value columns at once
    out = torch.matmul(alpha, torch.stack([ob, mask], dim=-1))
    return (out[..., 0].contiguous(), out[..., 1].contiguous(), torch.amax(s, dim=-1),
            torch.logsumexp(s, dim=-1))


def _attn_bwd_plain(q, k, ob, mask, out_ob, out_m, lse, g_ob, g_m, scale: float):
    """(dk, dob, dq) as the kernel takes them: alpha from the log-sum,
    masked slots' scores getting no gradient, a head without observations
    spreading its cotangent uniformly over its T slots."""
    obs = (mask != 0).to(q.dtype)[:, None, :]  # (heads, 1, T)
    seen = torch.amax(obs, dim=-1, keepdim=True)  # (heads, 1, 1)
    t_len = mask.shape[-1]
    s = _masked_scores(q, k, mask, scale)
    alpha = torch.where(seen > 0, torch.exp(s - lse[..., None]) * obs,
                        torch.full_like(s, 1.0 / t_len))
    dd = g_ob * out_ob + g_m * out_m  # (heads, R)
    ds = alpha * (g_ob[..., None] * ob[:, None, :] + g_m[..., None] * mask[:, None, :]
                  - dd[..., None]) * obs * scale
    dk = torch.matmul(ds.transpose(1, 2), q)
    dq = torch.sum(torch.matmul(ds, k), dim=0)
    dob = torch.sum(alpha * g_ob[..., None], dim=1)
    return dk, dob, dq


# ------------------------------------------------------------------ launches
def _check(name, q, k, ob, mask):
    heads, t_len, d = k.shape
    r = q.shape[0]
    if not (1 <= r <= MAX_QUERIES and 4 <= d <= MAX_DIM and d % 4 == 0):
        raise ValueError(f"{name}: takes R <= {MAX_QUERIES} queries and D <= {MAX_DIM}, a "
                         f"multiple of 4; got q {tuple(q.shape)}, k {tuple(k.shape)}")
    cb.check(f"{name} q", q, torch.float32, (r, d))
    cb.check(f"{name} k", k, torch.float32, (heads, t_len, d))
    cb.check(f"{name} ob", ob, torch.float32, (heads, t_len))
    cb.check(f"{name} mask", mask, torch.float32, (heads, t_len))
    if k.data_ptr() % 16:
        raise ValueError(f"{name}: k must be 16-byte aligned (the kernels read it as float4)")
    return heads, t_len, r, d


def _attn_fwd_launch(q, k, ob, mask, scale: float):
    heads, t_len, r, d = _check("mtan_attn_fwd", q, k, ob, mask)
    outs = [torch.empty((heads, r), dtype=torch.float32, device=q.device) for _ in range(4)]
    fn = cb.c_function("mtan", "dicl_mtan_attn_forward", 8, 5, 1)
    cb.raise_on_error("mtan_attn_fwd", fn(
        cb.ptr(q), cb.ptr(k), cb.ptr(ob), cb.ptr(mask), *(cb.ptr(o) for o in outs),
        heads, t_len, r, d, MAX_BLOCKS, float(scale), cb.stream_of(q)))
    return tuple(outs)


def _attn_bwd_launch(q, k, ob, mask, out_ob, out_m, lse, g_ob, g_m, scale: float):
    heads, t_len, r, d = _check("mtan_attn_bwd", q, k, ob, mask)
    for what, t in (("out_ob", out_ob), ("out_m", out_m), ("lse", lse), ("g_ob", g_ob),
                    ("g_m", g_m)):
        cb.check(f"mtan_attn_bwd {what}", t, torch.float32, (heads, r))
    dk = torch.empty_like(k)
    dob = torch.empty_like(ob)
    dq = torch.empty_like(q)
    partials = torch.empty((MAX_BLOCKS, r, d), dtype=torch.float32, device=q.device)
    fn = cb.c_function("mtan", "dicl_mtan_attn_backward", 13, 5, 1)
    cb.raise_on_error("mtan_attn_bwd", fn(
        cb.ptr(q), cb.ptr(k), cb.ptr(ob), cb.ptr(mask), cb.ptr(out_ob), cb.ptr(out_m),
        cb.ptr(lse), cb.ptr(g_ob), cb.ptr(g_m), cb.ptr(dk), cb.ptr(dob), cb.ptr(partials),
        cb.ptr(dq), heads, t_len, r, d, MAX_BLOCKS, float(scale), cb.stream_of(q)))
    return dk, dob, dq


_SOURCE = "deep_interpolation_clustering_tpu_torch/csrc/mtan.cu"
# no Pallas kernel: the JAX package has no mTAN
_REPLACES = "none; mTAN's multiTimeAttention (github.com/reml-lab/mTAN models.py)"

attn_fwd = cb.register(cb.KernelWrapper("mtan_attn_fwd", _SOURCE, _REPLACES,
                                        _attn_fwd_plain, _attn_fwd_launch))
attn_bwd = cb.register(cb.KernelWrapper("mtan_attn_bwd", _SOURCE, _REPLACES,
                                        _attn_bwd_plain, _attn_bwd_launch))


# --------------------------------------------------------- autograd function
class EncoderAttention(torch.autograd.Function):
    """M1's pair: q (R, D), k (heads, T, D), ob and mask (heads, T), scale
    -> out_ob, out_m (heads, R). Gradients go to q, k and ob."""

    @staticmethod
    def forward(ctx, q, k, ob, mask, scale):
        tracing.count(COUNTER)
        out_ob, out_m, _, lse = attn_fwd(q, k, ob, mask, scale)
        ctx.save_for_backward(q, k, ob, mask, out_ob, out_m, lse)
        ctx.scale = scale
        return out_ob, out_m

    @staticmethod
    def backward(ctx, g_ob, g_m):
        tracing.count(COUNTER)
        q, k, ob, mask, out_ob, out_m, lse = ctx.saved_tensors
        dk, dob, dq = attn_bwd(q, k, ob, mask, out_ob, out_m, lse, g_ob.contiguous(),
                               g_m.contiguous(), ctx.scale)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None, dob if need[2] else None,
                None, None)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, ob: torch.Tensor,
                      mask: torch.Tensor, use_kernel: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder's attention over the system's planes: q (R, D), k (B, C,
    T, D), ob and mask (B, C, T) -> the weighted sums of ob and of mask,
    each (B, C, R), at scale 1/sqrt(D). `use_kernel=False`: the plain
    forward on any device, differentiated by autograd."""
    b, c, t_len, d = k.shape
    heads = b * c
    args = (q.contiguous(), k.reshape(heads, t_len, d).contiguous(),
            ob.reshape(heads, t_len).contiguous(), mask.reshape(heads, t_len).contiguous(),
            d ** -0.5)
    if use_kernel:
        out_ob, out_m = EncoderAttention.apply(*args)
    else:
        out_ob, out_m, _, _ = _attn_fwd_plain(*args)
    return out_ob.reshape(b, c, -1), out_m.reshape(b, c, -1)
