"""Hand-written CUDA kernels for the biLSTM recurrence (counterpart of the
JAX `ops/pallas_lstm.py`).

  B6 `lstm_forward`  (csrc/lstm.cu)  the whole recurrence   <- `_fwd_kernel`
  B7 `lstm_backward` (csrc/lstm.cu)  its reverse walk       <- `_bwd_kernel`

The interface is the JAX `bilstm_recurrence_pallas`'s: pre-projected gates
`xg_f`, `xg_b` (T, B, 4H), the backward direction not flipped; `w_hhT`
(2, H, 4H); `b_hh` (2, 4H); `h0`, `c0` (2, B, H) -> `ys_f`, `ys_b`, `cs_f`,
`cs_b` (T, B, H), time-aligned. Gate order [i|f|g|o]; gates
`(xg + h W_hh^T) + b_hh` in that association order. The kernels and their
plain versions take float32 only; `bilstm_recurrence` upcasts other float
inputs (the bfloat16 `compute_dtype`) at its boundary and casts the outputs
to the caller's type, as the JAX `bilstm_forward` does around its Pallas
pair (`ops/lstm.py:84-99`).

The plain forward is the step loop of the port's `ops/lstm.py`; the plain
backward is PyTorch autograd of it. `LSTMRecurrence` holds the kernel pair
in one `torch.autograd.Function`. B6 is one launch with the geometry of
`forward_geometry`: 4H threads, the first rows of W_hh^T resident in shared
memory, the k sum in four splits added in a fixed order by warp shuffles.
B7 is four launches (the gates' products, the reverse walk, the dW partials
and their ordered sum; csrc/lstm.cu), with the geometry of
`backward_geometry`. B7's products are one sum over k, so its recomputed
gates differ from B6's by float32 rounding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _cuda_build as cb

MAX_HIDDEN = 256  # kMaxHidden: the widest recurrence the kernels take (csrc/lstm.cu)

# The forward's launch geometry; the constants are csrc/lstm.cu's.
FWD_ROWS = 8  # kRows: batch rows per block
FWD_MAX_THREADS = 512  # kFwdMaxThreads, the block's __launch_bounds__
FWD_GROUP = 8  # kFwdGroup: hidden units per warp item
FWD_SPLITS = 4  # kFwdSplits: splits of the k sum, added in a fixed order
FWD_TAIL_ITERS = 6  # kFwdTailIters: k iterations past the resident rows kept in registers

# The backward's launch geometry; the constants are csrc/lstm.cu's.
BWD_ROWS = 8  # kBwdRows: batch rows per block of the recurrence
BWD_MAX_THREADS = 512  # kBwdMaxThreads, the block's __launch_bounds__
BWD_PAIR_CAP = BWD_ROWS // 2  # kBwdPairCap: (unit, row) pairs a thread holds at most
DH_SPLITS = 16  # kDhSplits: splits of the dh products' sum, added in order
GEMM_TILE_A, GEMM_TILE_N = 64, 128  # kGemmTileA x kGemmTileN outputs per GEMM block
GEMM_STAGE = 16  # kGemmStage: summed index per shared-memory stage
DW_MIN_BLOCKS = 2 * 132  # two blocks of the dW product on each of the H100's SMs
SMEM_PER_BLOCK = 232_448  # kSmemLimit: the most shared memory a Hopper block can have


# ------------------------------------------------------------ plain versions
def _run_direction(xg: torch.Tensor, w_hhT: torch.Tensor, b_hh: torch.Tensor,
                   h: torch.Tensor, c: torch.Tensor, reverse: bool):
    """Step one direction over `xg` (T, B, 4H); returns the time-aligned h and
    c sequences (T, B, H)."""
    t_len = xg.shape[0]
    ys, cs = [None] * t_len, [None] * t_len
    for t in (range(t_len - 1, -1, -1) if reverse else range(t_len)):
        gates = xg[t] + torch.matmul(h, w_hhT) + b_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f)
        g = torch.tanh(g)
        o = torch.sigmoid(o)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys[t], cs[t] = h, c
    return torch.stack(ys), torch.stack(cs)


def recurrence_plain(xgf, xgb, w_hhT, b_hh, h0, c0):
    """Plain version of B6 -> (ys_f, ys_b, cs_f, cs_b)."""
    ys_f, cs_f = _run_direction(xgf, w_hhT[0], b_hh[0], h0[0], c0[0], reverse=False)
    ys_b, cs_b = _run_direction(xgb, w_hhT[1], b_hh[1], h0[1], c0[1], reverse=True)
    return ys_f, ys_b, cs_f, cs_b


def _recurrence_bwd_plain(xgf, xgb, w_hhT, w_hh, b_hh, h0, c0,
                          ysf, ysb, csf, csb, dysf, dysb, dcsf, dcsb):
    """Plain version of B7: autograd of `recurrence_plain` (it recomputes the
    forward; `w_hh` and the saved outputs are the kernel's inputs only) ->
    (dxgf, dxgb, dw_hhT, db_hh, dh0, dc0)."""
    del w_hh, ysf, ysb, csf, csb
    with torch.enable_grad():
        ins = [a.detach().requires_grad_() for a in (xgf, xgb, w_hhT, b_hh, h0, c0)]
        outs = recurrence_plain(*ins)
        return tuple(torch.autograd.grad(outs, ins, (dysf, dysb, dcsf, dcsb)))


# ------------------------------------------------------------------ launches
def _check_forward(name, xgf, xgb, w_hhT, b_hh, h0, c0):
    t_len, b, four_h = xgf.shape
    hidden = four_h // 4
    if not (t_len >= 1 and b >= 1 and four_h == 4 * hidden and 1 <= hidden <= MAX_HIDDEN):
        raise ValueError(f"{name}: takes T >= 1, B >= 1 and 1 <= H <= {MAX_HIDDEN}, "
                         f"got xg of shape {tuple(xgf.shape)}")
    cb.check(f"{name} xgf", xgf, torch.float32)
    cb.check(f"{name} xgb", xgb, torch.float32, xgf.shape)
    cb.check(f"{name} w_hhT", w_hhT, torch.float32, (2, hidden, four_h))
    cb.check(f"{name} b_hh", b_hh, torch.float32, (2, four_h))
    cb.check(f"{name} h0", h0, torch.float32, (2, b, hidden))
    cb.check(f"{name} c0", c0, torch.float32, (2, b, hidden))
    return t_len, b, hidden


class ForwardGeometry(NamedTuple):
    rows: int  # batch rows per block
    threads: int  # threads per block: one warp per warp item, at most two items a warp
    blocks: int  # tiles x 2 directions
    smem_bytes: int  # dynamic shared memory per block
    resident_rows: int  # rows of W_hh^T kept in shared memory (zero rows past H included)
    register_rows: int  # rows past those whose W the threads keep in registers
    l2_rows: int  # rows read from L2 at every step


def forward_geometry(b: int, hidden: int, rows: int = FWD_ROWS) -> ForwardGeometry:
    """Launch geometry of B6, as csrc/lstm.cu computes and checks it. A warp
    item is FWD_GROUP hidden units x FWD_SPLITS splits of k; a block has one
    warp per item up to FWD_MAX_THREADS threads (two items a warp above
    H = 128). Its shared memory holds the tile's h twice ((k, row), k padded
    to the splits) and then as many rows of W_hh^T as fit, a multiple of the
    splits, at a stride of 8 mod 32 words. With one item a warp, the threads
    keep the next FWD_TAIL_ITERS * FWD_SPLITS rows in registers."""
    items = -(-hidden // FWD_GROUP)
    threads = min(FWD_MAX_THREADS, 32 * items)
    k_rows = -(-hidden // FWD_SPLITS) * FWD_SPLITS
    h_floats = 2 * k_rows * rows
    w_stride = -(-4 * hidden // 32) * 32 + 8
    fit = (SMEM_PER_BLOCK // 4 - h_floats) // w_stride // FWD_SPLITS * FWD_SPLITS
    resident = min(fit, k_rows)
    in_registers = FWD_TAIL_ITERS * FWD_SPLITS if threads // 32 >= items else 0
    register_rows = max(0, min(hidden - resident, in_registers))
    return ForwardGeometry(rows, threads, 2 * -(-b // rows),
                           4 * (h_floats + resident * w_stride), resident, register_rows,
                           max(0, hidden - resident - register_rows))


def _forward_launch(xgf, xgb, w_hhT, b_hh, h0, c0):
    t_len, b, hidden = _check_forward("lstm_forward", xgf, xgb, w_hhT, b_hh, h0, c0)
    outs = [torch.empty((t_len, b, hidden), dtype=xgf.dtype, device=xgf.device)
            for _ in range(4)]
    geo = forward_geometry(b, hidden)
    fn = cb.c_function("lstm", "dicl_lstm_fwd", 10, 6)
    cb.raise_on_error("lstm_forward", fn(
        cb.ptr(xgf), cb.ptr(xgb), cb.ptr(w_hhT), cb.ptr(b_hh), cb.ptr(h0), cb.ptr(c0),
        *(cb.ptr(o) for o in outs), t_len, b, hidden, geo.rows, geo.threads,
        geo.smem_bytes, cb.stream_of(xgf),
    ))
    return tuple(outs)


class BackwardGeometry(NamedTuple):
    rows: int  # batch rows per block of the recurrence
    threads: int  # threads per block of the recurrence
    blocks: int  # blocks of the recurrence: tiles x 2 directions
    smem_bytes: int  # dynamic shared memory per block of the recurrence
    resident_rows: int  # rows of W_hh the recurrence keeps in shared memory
    gate_blocks: int  # blocks of the gates' product before the recurrence
    chunk: int  # (t, row) pairs per partial of dW_hh^T / db_hh
    nsplit: int  # partials: chunk i covers [i * chunk, (i + 1) * chunk)
    dw_blocks: int  # blocks of the dW partial product


def backward_geometry(t_len: int, b: int, hidden: int, rows: int = BWD_ROWS
                      ) -> BackwardGeometry:
    """Launch geometry of B7, as csrc/lstm.cu computes and checks it.
    The recurrence: one thread per dh work item (4H of them) up to
    BWD_MAX_THREADS, a multiple of 32; its shared memory holds the dh
    partials, dpre and dc of the tile and then as many rows of W_hh as fit.
    The dW product: chunks of the T*B (t, row) pairs, a multiple of the stage
    size, so that the grid has at least DW_MIN_BLOCKS blocks where the pairs
    allow."""
    four_h = 4 * hidden
    threads = min(BWD_MAX_THREADS, 32 * -(-four_h // 32))
    unit_stride = -(-hidden // 4) * 4
    fixed = DH_SPLITS * rows * (unit_stride + 8) + 5 * hidden * rows
    resident = max(0, min(four_h, (SMEM_PER_BLOCK // 4 - fixed) // unit_stride))
    m_total = t_len * b
    n_tiles = -(-four_h // GEMM_TILE_N)
    dw_tiles = 2 * -(-hidden // GEMM_TILE_A) * n_tiles
    want = -(-DW_MIN_BLOCKS // dw_tiles)
    chunk = GEMM_STAGE * -(-m_total // (GEMM_STAGE * want))
    nsplit = -(-m_total // chunk)
    return BackwardGeometry(rows, threads, 2 * -(-b // rows),
                            4 * (fixed + resident * unit_stride), resident,
                            2 * -(-m_total // GEMM_TILE_A) * n_tiles, chunk, nsplit,
                            dw_tiles * nsplit)


def _backward_launch(xgf, xgb, w_hhT, w_hh, b_hh, h0, c0,
                     ysf, ysb, csf, csb, dysf, dysb, dcsf, dcsb):
    t_len, b, hidden = _check_forward("lstm_backward", xgf, xgb, w_hhT, b_hh, h0, c0)
    four_h = 4 * hidden
    cb.check("lstm_backward w_hh", w_hh, torch.float32, (2, four_h, hidden))
    for name, a in zip(("ysf", "ysb", "csf", "csb", "dysf", "dysb", "dcsf", "dcsb"),
                       (ysf, ysb, csf, csb, dysf, dysb, dcsf, dcsb)):
        cb.check(f"lstm_backward {name}", a, torch.float32, (t_len, b, hidden))
    new = lambda *shape: torch.empty(shape, dtype=xgf.dtype, device=xgf.device)
    dxgf, dxgb = new(t_len, b, four_h), new(t_len, b, four_h)
    dw_hhT, db_hh = new(2, hidden, four_h), new(2, four_h)
    dh0, dc0 = new(2, b, hidden), new(2, b, hidden)
    geo = backward_geometry(t_len, b, hidden)
    dw_part = new(geo.nsplit, 2, hidden, four_h)  # scratch
    db_part = new(geo.nsplit, 2, four_h)
    fn = cb.c_function("lstm", "dicl_lstm_bwd", 23, 7)
    cb.raise_on_error("lstm_backward", fn(
        *(cb.ptr(a) for a in (xgf, xgb, w_hhT, w_hh, b_hh, h0, c0, ysf, ysb, csf, csb,
                              dysf, dysb, dcsf, dcsb, dxgf, dxgb, dw_hhT, db_hh, dh0,
                              dc0, dw_part, db_part)),
        t_len, b, hidden, geo.rows, geo.threads, geo.nsplit, geo.chunk, cb.stream_of(xgf),
    ))
    return dxgf, dxgb, dw_hhT, db_hh, dh0, dc0


_PALLAS_LSTM = "deep_interpolation_clustering_tpu/ops/pallas_lstm.py"
_SOURCE = "deep_interpolation_clustering_tpu_torch/csrc/lstm.cu"

lstm_forward = cb.register(cb.KernelWrapper(
    "lstm_forward", _SOURCE, f"{_PALLAS_LSTM}:88", recurrence_plain, _forward_launch))
lstm_backward = cb.register(cb.KernelWrapper(
    "lstm_backward", _SOURCE, f"{_PALLAS_LSTM}:111", _recurrence_bwd_plain,
    _backward_launch))


# --------------------------------------------------------- autograd function
class LSTMRecurrence(torch.autograd.Function):
    """The merged two-direction recurrence with B6 as the forward and B7 as
    the backward. Inputs as `recurrence_plain`; every input gets a gradient.
    Cotangents may arrive on any of the four outputs at any t; autograd
    passes zeros for an output that nothing used (`materialize_grads`)."""

    @staticmethod
    def forward(ctx, xgf, xgb, w_hhT, b_hh, h0, c0):
        outs = lstm_forward(xgf, xgb, w_hhT, b_hh, h0, c0)
        ctx.save_for_backward(xgf, xgb, w_hhT, b_hh, h0, c0, *outs)
        return outs

    @staticmethod
    def backward(ctx, *cots):
        xgf, xgb, w_hhT, b_hh, h0, c0, *outs = ctx.saved_tensors
        w_hh = w_hhT.transpose(1, 2).contiguous()
        return lstm_backward(xgf, xgb, w_hhT, w_hh, b_hh, h0, c0, *outs,
                             *(g.contiguous() for g in cots))


def bilstm_recurrence(xgf: torch.Tensor, xgb: torch.Tensor, w_hhT: torch.Tensor,
                      b_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                      out_dtype: Optional[torch.dtype] = None, use_kernel: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence through B6/B7 (plain versions for CPU tensors;
    `use_kernel=False`: the plain forward on any device, autograd its
    backward). Every input is upcast to float32 outside the autograd
    function, so the kernels see float32 values and cotangents and the
    gradient of a bfloat16 input comes back bfloat16; the outputs are cast
    to `out_dtype` (default `xgf`'s type). The inputs are made contiguous:
    the decoder's `h0`/`c0` are slices of the encoder's state."""
    out_dtype = out_dtype or xgf.dtype
    ins = [a.to(torch.float32).contiguous() for a in (xgf, xgb, w_hhT, b_hh, h0, c0)]
    outs = LSTMRecurrence.apply(*ins) if use_kernel else recurrence_plain(*ins)
    return tuple(o.to(out_dtype) for o in outs)
