"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. These need a CUDA card and `nvcc` (the kernels have no CPU
mode), so they skip elsewhere. They import neither JAX nor this
directory's conftest, so they run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Shapes cover the ragged edges the kernels mask themselves: rows that do not
fill a block (or a block's eight rows of a select), T below and across a
warp and across every layout boundary, R from 1 to 8,
rows with k = 0, LSTM batches that do not fill a tile and hidden widths
whose 4H gate columns do not fill a warp or take two columns a thread. Tolerances: the
selects are bit-identical; forward values 1e-5 (abs and relative, float32);
gradients 1e-4 of their largest element; the LSTM forward and backward
repeat bit for bit. The LSTM backward recomputes the gates' products as one
sum over k where the forward adds four splits, so its gates differ from the
forward's by float32 rounding: the gradient tolerance covers that at every
shape here.

The p3 path too: B6/B7 at the triplet encoder's 3 x 256 rows, the k-means on
the card against the same code on the CPU, and one DEC step (with and
without the triplet stream) with the kernels against one without. And the
options off by default: both selects on 16-bit keys (`rng_draw_bits=16`,
whose random parts tie far more often), and one step with `fused_heads`
and one with 16-bit draws, with the kernels against without.
"""

import copy

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.cluster import kmeans as km
from deep_interpolation_clustering_tpu_torch.data import (
    ArrayDataset,
    make_synthetic_cohorts,
    process_splits,
)
from deep_interpolation_clustering_tpu_torch.data.loader import draw_bits
from deep_interpolation_clustering_tpu_torch.models import Net
from deep_interpolation_clustering_tpu_torch.ops import cuda_interp as ci
from deep_interpolation_clustering_tpu_torch.ops import cuda_lstm as cl
from deep_interpolation_clustering_tpu_torch.ops import cuda_select as cs
from deep_interpolation_clustering_tpu_torch.ops.lstm import LSTMWeights, bilstm_forward
from deep_interpolation_clustering_tpu_torch.ops.interpolation import (
    Planes,
    reference_times,
    sci_forward,
)
from deep_interpolation_clustering_tpu_torch.train import (
    build_inputs,
    gather_batch,
    make_optimizer,
    update,
)
from deep_interpolation_clustering_tpu_torch.utils import resolve_device

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return resolve_device("cuda")  # TF32 off


def _planes(seed, rows, t, dev):
    """Front-packed ragged masks with >= 1 observation per row."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(1, t + 1, size=rows)
    mask = (np.arange(t)[None, :] < counts[:, None]).astype(np.float32)
    x = rng.randn(rows, t).astype(np.float32) * mask
    ts = np.sort(rng.rand(rows, t).astype(np.float32) * 6.0, axis=1) * mask
    return [torch.from_numpy(a).to(dev) for a in (x, ts, mask)]


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _select_inputs(t, rows, case, seed, dev):
    """Random bits with ragged n_valid, an empty row and a full row, and
    k = max(1, n_valid // 2), then the case: `ragged` adds rows of ties in
    the random part, `k_zero` takes nothing, `k_all` every valid slot,
    `no_valid` has no valid slot, `all_ties` makes every random part equal,
    so the whole choice is the position-ordered tie fill and no pass ends
    the search early."""
    rng = np.random.RandomState(seed)
    n_valid = rng.randint(0, t + 1, size=rows).astype(np.int32)
    n_valid[:2] = (0, t)[:rows]
    k = np.where(n_valid > 0, np.maximum(1, n_valid // 2), 0).astype(np.int32)
    bits = rng.randint(0, 2**32, size=(rows, t), dtype=np.uint64).astype(np.uint32)
    if case == "ragged":
        bits[2:5] &= np.uint32(0xC0000000)
    elif case == "k_zero":
        k[:] = 0
    elif case == "k_all":
        k = n_valid.copy()
    elif case == "no_valid":
        n_valid[:] = 0
        k[:] = 0
    else:
        bits &= np.uint32(0x3)  # below the key's 30 bits: all random parts are 0
    return [torch.from_numpy(a).to(dev) for a in (bits.view(np.int32), n_valid, k)]


# T crosses the select's layouts (`cuda_select.select_layout`): the slots a
# lane holds, a warp a row (T <= 192), 2 warps a row (<= 384), 4 warps a
# row (<= 1024) and the block of 8 warps that walks a longer row; 37 rows
# do not fill a block of the warp-a-row layout
@pytest.mark.parametrize("case", ["ragged", "k_zero", "k_all", "no_valid", "all_ties"])
@pytest.mark.parametrize("t", [1, 24, 31, 33, 193, 256, 352, 353, 354, 384, 385, 512, 768, 769,
                               1023, 1024, 1025, 1536, 2048, 4096])
def test_fake_select_bit_identical(dev, t, case):
    args = _select_inputs(t, 37, case, t, dev)
    got = cs.fake_select(*args)
    assert torch.equal(got, cs._select_sort(*args))
    assert torch.equal(got.sum(1).to(torch.int32), args[2])


@pytest.mark.parametrize("t", [1025, 2048, 4096])
def test_fake_select_mask_long_rows_launch_the_kernel(dev, t):
    """`fake_select_mask` on rows longer than 1024 slots launches the
    select (one count) and answers as the sort oracle."""
    bits, n_valid, k = _select_inputs(t, 24, "ragged", t + 7, dev)
    before = cs.fake_select.launches
    got = cs.fake_select_mask(bits.reshape(4, 6, t), n_valid.reshape(4, 6), k.reshape(4, 6))
    assert cs.fake_select.launches == before + 1
    assert torch.equal(got.reshape(24, t), cs._select_sort(bits, n_valid, k))


# T crosses the packed select's slots a lane (1 to 6 at T <= 32, ..., 192);
# rows below, at and far above the 8 rows of a block
@pytest.mark.parametrize("case", ["ragged", "k_zero", "k_all", "no_valid", "all_ties"])
@pytest.mark.parametrize("rows", [1, 7, 24576])
@pytest.mark.parametrize("t", [1, 2, 16, 31, 32, 33, 37, 48, 64, 65, 100, 128, 191, 192])
def test_fake_select_packed_bit_identical(dev, t, rows, case):
    """Against the sort oracle and the other wrapper of the same kernel."""
    args = _select_inputs(t, rows, case, 1000 * t + rows, dev)
    got = cs.fake_select_packed(*args)
    assert torch.equal(got, cs._select_sort(*args))
    assert torch.equal(got.sum(1).to(torch.int32), args[2])
    assert torch.equal(got, cs.fake_select(*args))  # fake_select takes every T


def _lstm_inputs(t, b, h, with_state, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape, scale=1.0: torch.randn(shape, generator=gen, device=dev) * scale
    bound = 1.0 / np.sqrt(h)
    xgf, xgb = rand(t, b, 4 * h), rand(t, b, 4 * h)
    w_hhT = (torch.rand((2, h, 4 * h), generator=gen, device=dev) * 2 - 1) * bound
    b_hh = (torch.rand((2, 4 * h), generator=gen, device=dev) * 2 - 1) * bound
    if with_state:
        h0, c0 = rand(2, b, h, scale=0.5), rand(2, b, h, scale=0.5)
    else:
        h0 = c0 = torch.zeros((2, b, h), device=dev)
    return [xgf, xgb, w_hhT, b_hh, h0, c0]


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("h", [16, 100, 128, 256])  # 4H = 400: a partial warp
@pytest.mark.parametrize("b", [1, 13, 256, 512])
@pytest.mark.parametrize("t", [1, 6, 9])
def test_lstm_forward_and_backward(dev, t, b, h, with_state):
    ins = _lstm_inputs(t, b, h, with_state, dev)
    got = cl.lstm_forward(*ins)
    want = cl.recurrence_plain(*ins)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    gen = torch.Generator(device=dev).manual_seed(1)
    cots = [torch.randn(w.shape, generator=gen, device=dev) for w in want]
    w_hh = ins[2].transpose(1, 2).contiguous()
    got_g = cl.lstm_backward(*ins[:3], w_hh, *ins[3:], *got, *cots)
    want_g = cl._recurrence_bwd_plain(*ins[:3], w_hh, *ins[3:], *want, *cots)
    for name, a, w in zip(("dxgf", "dxgb", "dw_hhT", "db_hh", "dh0", "dc0"), got_g, want_g):
        assert _rel_err(a, w) <= 1e-4, name


@pytest.mark.parametrize("b,with_state", [(512, False), (256, True)])
def test_lstm_forward_repeats_bit_for_bit(dev, b, with_state):
    ins = _lstm_inputs(6, b, 128, with_state, dev, seed=6)
    first = cl.lstm_forward(*ins)
    second = cl.lstm_forward(*ins)
    for a, a2 in zip(first, second):
        assert torch.equal(a, a2)


def test_lstm_backward_repeats_bit_for_bit(dev):
    ins = _lstm_inputs(6, 512, 128, True, dev, seed=2)
    outs = cl.lstm_forward(*ins)
    gen = torch.Generator(device=dev).manual_seed(3)
    cots = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
    w_hh = ins[2].transpose(1, 2).contiguous()
    first = cl.lstm_backward(*ins[:3], w_hh, *ins[3:], *outs, *cots)
    second = cl.lstm_backward(*ins[:3], w_hh, *ins[3:], *outs, *cots)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_bilstm_gradient_kernels_match_plain(dev):
    """`bilstm_forward` through B6/B7 against the plain loop under autograd,
    with h0/c0 given as slices (as the decoder's are)."""
    t, b, feat, h = 6, 37, 256, 128
    weights = LSTMWeights(feat, h)
    weights.reset_parameters(torch.Generator().manual_seed(4))
    weights = weights.to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((t, b, feat), generator=gen, device=dev)
    state = torch.randn((2, 2 * b, h), generator=gen, device=dev) * 0.3
    wo = torch.randn((t, b, 2 * h), generator=gen, device=dev)
    grads = []
    for use_kernel in (True, False):
        weights.zero_grad()
        xs = x.clone().requires_grad_()
        st = state.clone().requires_grad_()
        out, hid, cell = bilstm_forward(weights, xs, st[:, :b], st[:, b:], use_kernel=use_kernel)
        (torch.sum(out * wo) + hid.sum() + 0.5 * cell.sum()).backward()
        grads.append([out.detach(), xs.grad, st.grad] + [p.grad for p in weights.parameters()])
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-5, atol=1e-5)
    for a, w in zip(grads[0][1:], grads[1][1:]):
        assert _rel_err(a, w) <= 1e-4


# T crosses the backward's layouts: a warp a row with 1 or 2 slots a lane (T <=
# 32, <= 64), a block a row with 1 to 3 slots a thread (<= 128, 256, 384), the loop
@pytest.mark.parametrize("rows,t,r", [
    (15, 7, 1), (18, 354, 6), (1536, 354, 6), (6, 40, 8), (15, 1, 2), (9, 32, 6), (9, 33, 6),
    (600, 48, 6), (13 * 3, 64, 6), (12, 65, 3), (6, 128, 6), (6, 129, 6), (6, 256, 8),
    (6, 257, 6), (6, 384, 6), (6, 385, 6), (6, 1024, 6)])
def test_sci_forward_and_backward(dev, rows, t, r):
    c = 3 if rows % 6 else 6
    x, ts, mask = _planes(rows + t + r, rows, t, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha = torch.rand(c, generator=gen, device=dev) + 0.5
    ref_t = reference_times(r, 6.0, device=dev)
    torch.testing.assert_close(ci.sci_fwd(x, ts, mask, alpha, ref_t),
                               ci._sci_fwd_plain(x, ts, mask, alpha, ref_t),
                               rtol=1e-5, atol=1e-5)
    g = torch.randn((rows // c, r, 3 * c), generator=gen, device=dev)
    got = ci.sci_bwd(x, ts, mask, alpha, ref_t, g, True)
    want = ci._sci_bwd_plain(x, ts, mask, alpha, ref_t, g, True)
    obs = mask > 0
    for name, a, b in zip(("dx", "dt", "dm", "dalpha"), got, want):
        if name == "dm":
            a, b = a[obs], b[obs]
        assert _rel_err(a, b) <= 1e-4, name
    only = ci.sci_bwd(x, ts, mask, alpha, ref_t, g, False)
    assert only[:3] == (None, None, None)
    assert torch.equal(only[3], got[3])  # the same sums in the same order


def _forward_rows(out, c):
    """(B, R, 3C) [y | w | yt] -> (rows, 3, R) with row = b*C + c."""
    b, r, _ = out.shape
    return out.reshape(b, r, 3, c).permute(0, 3, 2, 1).reshape(b * c, 3, r)


# T crosses the layouts of both SCI kernels (a warp a row up to 64, a block a
# row up to 384, the loop above)
@pytest.mark.parametrize("r", [1, 6, 8])
@pytest.mark.parametrize("t", [1, 32, 33, 48, 64, 65, 128, 129, 354, 384, 385, 1024])
def test_sci_forward_rows(dev, t, r):
    """Ragged rows, a row with one observed slot and a fully padded row (NaN
    in both versions, and unseen by the other rows): within 1e-5 of the
    plain version, and two runs give the same bits."""
    rows, c, pad, single = 18, 6, 7, 11
    x, ts, mask = _planes(7 * t + r, rows, t, dev)
    for a in (x, ts, mask):
        a[pad] = 0.0
        a[single, 1:] = 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha = torch.rand(c, generator=gen, device=dev) + 0.5
    ref_t = reference_times(r, 6.0, device=dev)
    got = _forward_rows(ci.sci_fwd(x, ts, mask, alpha, ref_t), c)
    want = _forward_rows(ci._sci_fwd_plain(x, ts, mask, alpha, ref_t), c)
    keep = torch.arange(rows, device=dev) != pad
    torch.testing.assert_close(got[keep], want[keep], rtol=1e-5, atol=1e-5)
    assert torch.isfinite(got[keep]).all()
    # one observed slot: both softmaxes put all weight on it
    torch.testing.assert_close(got[single, 0], x[single, 0].expand(r), rtol=0, atol=0)
    torch.testing.assert_close(got[single, 2], x[single, 0].expand(r), rtol=0, atol=0)
    again = _forward_rows(ci.sci_fwd(x, ts, mask, alpha, ref_t), c)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.parametrize("rows,t", [(1536, 354), (24576, 48)])
def test_sci_forward_repeats_bit_for_bit(dev, rows, t):
    x, ts, mask = _planes(t, rows, t, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha = torch.rand(6, generator=gen, device=dev) + 0.5
    ref_t = reference_times(6, 6.0, device=dev)
    first = ci.sci_fwd(x, ts, mask, alpha, ref_t)
    torch.testing.assert_close(first, ci._sci_fwd_plain(x, ts, mask, alpha, ref_t),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(first, ci.sci_fwd(x, ts, mask, alpha, ref_t))


@pytest.mark.parametrize("t", [48, 354, 1024])
def test_sci_backward_fully_padded_row(dev, t):
    """A row with no observation: its dalpha and plane cotangents are 0 (the
    plain version's are NaN there), and the other rows do not see it."""
    rows, c, r, pad = 12, 6, 6, 7
    x, ts, mask = _planes(t, rows, t, dev)
    for a in (x, ts, mask):
        a[pad] = 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    alpha = torch.rand(c, generator=gen, device=dev) + 0.5
    ref_t = reference_times(r, 6.0, device=dev)
    g = torch.randn((rows // c, r, 3 * c), generator=gen, device=dev)
    got = ci.sci_bwd(x, ts, mask, alpha, ref_t, g, True)
    want = ci._sci_bwd_plain(x, ts, mask, alpha, ref_t, g, True)
    keep = torch.arange(rows, device=dev) != pad
    obs = mask[keep] > 0
    for name, a, b in zip(("dx", "dt", "dm", "dalpha"), got, want):
        assert torch.all(a[pad] == 0), name
        a, b = a[keep], b[keep]
        if name == "dm":
            a, b = a[obs], b[obs]
        assert _rel_err(a, b) <= 1e-4, name
    assert torch.equal(ci.sci_bwd(x, ts, mask, alpha, ref_t, g, False)[3], got[3])


def test_sci_function_gradient_matches_plain_autograd(dev):
    b, c, t = 32, 6, 354
    x, ts, mask = (a.reshape(b, c, t) for a in _planes(1, b * c, t, dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.randn((b, 6, 3 * c), generator=gen, device=dev)
    kernel = torch.rand(c, generator=gen, device=dev)
    k1, k2 = kernel.clone().requires_grad_(), kernel.clone().requires_grad_()
    out = ci.sci(k1, x, mask, ts, 6, 6.0)
    torch.sum(out * w).backward()
    ref = sci_forward(k2, Planes(x, mask, ts, mask), 6, 6.0)
    torch.sum(ref * w).backward()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    assert _rel_err(k1.grad, k2.grad) <= 1e-4


# T crosses the push's layouts (a warp a row up to 64 slots, a block a row
# up to 384, the loop above), at R = 1 and 8 with a fully padded row; and the
# main path's 1,536 x 354 at R = 6
@pytest.mark.parametrize("rows,t,r", [(15, 7, 1), (1536, 354, 6), (6, 40, 8)] + [
    (18, t, r) for t in (1, 32, 33, 64, 65, 354, 384, 385, 700) for r in (1, 8)])
def test_rbf_push_forward_and_backward(dev, rows, t, r):
    c = 3 if rows % 6 else 6
    _, ts, mask = _planes(rows * t, rows, t, dev)
    if rows == 18:
        ts[7] = 0.0
        mask[7] = 0.0  # no observation: the push writes 0 there
    gen = torch.Generator(device=dev).manual_seed(2)
    beta = torch.rand(c, generator=gen, device=dev) + 0.5
    proj = torch.randn((rows, r), generator=gen, device=dev)
    ref_t = reference_times(r, 6.0, device=dev)
    got = ci.rbf_push_k(ts, mask, proj, beta, ref_t)
    torch.testing.assert_close(got, ci._rbf_plain(ts, mask, proj, beta, ref_t),
                               rtol=1e-5, atol=1e-5)
    assert torch.all(got[mask == 0] == 0)
    b = rows // c
    kernel = torch.rand(c, generator=gen, device=dev)
    p3 = proj.reshape(b, c, r)
    w = torch.randn((b, c, t), generator=gen, device=dev)
    grads = []
    for kernel_path in (True, False):
        k, p = kernel.clone().requires_grad_(), p3.clone().requires_grad_()
        if kernel_path:
            out = ci.rbf_push(k, p, mask.reshape(b, c, t), ts.reshape(b, c, t), r, 6.0)
        else:
            out = ci._rbf_plain(ts, mask, p.reshape(rows, r), ci.softplus(k), ref_t)
        torch.sum(out.reshape(b, c, t) * w).backward()
        grads.append((k.grad, p.grad))
    for a, b_ in zip(*grads):
        assert _rel_err(a, b_) <= 1e-4


def test_net_forward_kernels_match_plain(dev):
    cfg = Config(batch_size=16, num_timestamps=354, dropout=0.0)
    net = Net(cfg, generator=torch.Generator().manual_seed(3)).to(dev)
    b, c, t = 16, cfg.num_variables, cfg.num_timestamps
    x, ts, mask = (a.reshape(b, c, t) for a in _planes(4, b * c, t, dev))
    planes = Planes(x, mask, ts, mask)
    fake = Planes(torch.flip(x, (0,)), mask, ts, mask)
    perm = torch.randperm(2 * b, generator=torch.Generator(device=dev).manual_seed(5),
                          device=dev)
    with torch.no_grad():
        got = net(planes, fake, perm, train=False, use_kernels=True)
        want = net(planes, fake, perm, train=False, use_kernels=False)
    torch.testing.assert_close(got.hidden, want.hidden, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.rec, want.rec, rtol=1e-5, atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x, ts, mask = _planes(6, 12, 40, dev)
    alpha, ref_t = torch.ones(6, device=dev), reference_times(6, 6.0, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ci.sci_fwd(x.t().contiguous().t(), ts, mask, alpha, ref_t)
    with pytest.raises(ValueError, match="float32"):
        ci.sci_fwd(x.double(), ts, mask, alpha, ref_t)
    with pytest.raises(ValueError, match="R=9"):
        ci.sci_fwd(x, ts, mask, alpha, reference_times(9, 6.0, device=dev))
    n = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="T >= 1"):
        cs.fake_select(torch.zeros((2, 0), dtype=torch.int32, device=dev), n, n)
    with pytest.raises(ValueError, match="T <= 192"):
        cs.fake_select_packed(torch.zeros((2, 193), dtype=torch.int32, device=dev), n, n)
    with pytest.raises(ValueError, match="H <= 256"):
        cl.lstm_forward(*_lstm_inputs(2, 3, 264, False, dev))


def test_lstm_at_the_triplet_encoder_shape(dev):
    """p3 with the triplet stream runs the encoder on real, fake and
    positive rows at once: B = 3 x 256 without state."""
    ins = _lstm_inputs(6, 768, 128, False, dev, seed=9)
    got = cl.lstm_forward(*ins)
    want = cl.recurrence_plain(*ins)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    for a, a2 in zip(got, cl.lstm_forward(*ins)):
        assert torch.equal(a, a2)
    gen = torch.Generator(device=dev).manual_seed(10)
    cots = [torch.randn(w.shape, generator=gen, device=dev) for w in want]
    w_hh = ins[2].transpose(1, 2).contiguous()
    got_g = cl.lstm_backward(*ins[:3], w_hh, *ins[3:], *got, *cots)
    want_g = cl._recurrence_bwd_plain(*ins[:3], w_hh, *ins[3:], *want, *cots)
    for name, a, w in zip(("dxgf", "dxgb", "dw_hhT", "db_hh", "dh0", "dc0"), got_g, want_g):
        assert _rel_err(a, w) <= 1e-4, name


def _blobs(n, k, d, seed):
    rng = np.random.RandomState(seed)
    means = rng.randn(k, d).astype(np.float32) * 4
    lab = rng.randint(0, k, n)
    return (means[lab] + rng.randn(n, d).astype(np.float32) * 0.5).astype(np.float32)


def test_kmeans_on_the_card_matches_the_cpu(dev):
    """The same code on the card and on the CPU: Lloyd from the same
    centres gives identical labels and n_iter, centres within 1e-5; a
    fit's draws differ between the two generators, so its partition is
    compared up to a relabelling, each centre within 1e-5 of its match."""
    x = _blobs(3000, 4, 256, seed=1)
    xc, xg = torch.from_numpy(x), torch.from_numpy(x).to(dev)
    init = xc[[0, 1, 2, 3]]
    tol = 1e-4 * torch.mean(torch.var(xc, dim=0, correction=0))
    cpu = km._lloyd(xc, init, 300, tol)
    card = km._lloyd(xg, init.to(dev), 300, tol.to(dev))
    assert torch.equal(card[1].cpu(), cpu[1]) and int(card[3]) == int(cpu[3])
    torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(km.kmeans_predict(cpu[0].to(dev), xg).cpu(),
                       km.kmeans_predict(cpu[0], xc))
    fit_c = km.kmeans_fit(torch.Generator().manual_seed(0), xc, 4, n_init=20)
    fit_g = km.kmeans_fit(torch.Generator(device=dev).manual_seed(0), xg, 4, n_init=20)
    assert fit_g.centers.is_cuda and fit_g.labels.is_cuda
    lc, lg = fit_c.labels.numpy(), fit_g.labels.cpu().numpy()
    match = {int(a): int(b) for a, b in zip(lg, lc)}
    assert len(match) == 4 and len(set(match.values())) == 4
    np.testing.assert_array_equal(np.vectorize(match.get)(lg), lc)
    for a, b in match.items():
        torch.testing.assert_close(fit_g.centers[a].cpu(), fit_c.centers[b], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("triplet", [False, True], ids=["kl", "kl_triplet"])
def test_dec_train_step_kernels_match_plain(dev, triplet):
    """One DEC update (the p3 loss; with the triplet stream, the encoder at
    3 x B rows) with the kernels and one with their plain versions, from
    the same weights and draws: losses within 1e-5 and parameters under
    the Adam eps-regime rule (at most 0.01% of elements beyond 1e-5, none
    beyond 2 x lr)."""
    b, t, c = 32, 354, 6
    cfg = Config(batch_size=b, num_timestamps=t, dropout=0.0,
                 loss="ae_mse_sup_fake_detect_kl" + ("_triplet" if triplet else ""),
                 triple_margin=1.0 if triplet else 0.0)
    cohorts = process_splits(make_synthetic_cohorts(n_total=60, max_obs=t, seed=2),
                             rng=np.random.RandomState(0))
    data = {k: torch.as_tensor(v, device=dev)
            for k, v in ArrayDataset(cfg, cohorts["training"], "training").arrays().items()}
    batch = gather_batch(data, torch.arange(b, device=dev))
    gen = torch.Generator(device=dev).manual_seed(3)
    draws = {"fake_bits": draw_bits((b, c, t), gen, dev),
             "fake_noise": torch.rand((b, c, t), generator=gen, device=dev),
             "perm": torch.randperm(2 * b, generator=gen, device=dev),
             "pos_noise": torch.randn((2, b, c, t), generator=gen, device=dev)}
    net_k = Net(cfg, generator=torch.Generator().manual_seed(4), clustering=True).to(dev)
    net_p = copy.deepcopy(net_k)
    losses = {}
    for use_kernels, net in ((True, net_k), (False, net_p)):
        inputs = build_inputs(cfg, batch, None, True, False, draws, use_kernels)
        losses[use_kernels] = update(net, make_optimizer(cfg, net.parameters()), cfg, inputs,
                                     None, use_kernels)
    assert "kl" in losses[True] and ("triplet" in losses[True]) == triplet
    for k, v in losses[False].items():
        assert abs(float(losses[True][k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), k
    plain = dict(net_p.named_parameters())
    n_viol = n_tot = 0
    for n, p in net_k.named_parameters():
        d = (p.detach() - plain[n].detach()).abs()
        assert float(d.max()) <= 2 * cfg.init_lr, n
        n_viol += int((d > 1e-5 + 1e-5 * plain[n].detach().abs()).sum())
        n_tot += d.numel()
    assert n_viol <= max(1, n_tot // 10_000)


@pytest.mark.parametrize("t", [48, 354, 2048])
def test_selects_bit_identical_on_16bit_keys(dev, t):
    """Keys with 16 random bits (the low 16 of each pattern 0): ties in the
    random part are broken by slot position in every kernel as in the
    sort; T=48 through both wrappers of the kernel and the mask routing."""
    rng = np.random.RandomState(t)
    rows = 6 * 256
    n_valid = rng.randint(0, t + 1, size=rows).astype(np.int32)
    k = np.where(n_valid > 0, np.maximum(1, n_valid // 2), 0).astype(np.int32)
    u16 = rng.randint(0, 2**16, size=(rows, t)).astype(np.uint32)
    u16[:64] &= 0x3  # rows of heavy ties
    bits = (u16 << 16).view(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (bits, n_valid, k)]
    want = cs._select_sort(*args)
    wrappers = [cs.fake_select] + ([cs.fake_select_packed] if t <= cs.PACKED_MAX_T else [])
    for fn in wrappers:
        assert torch.equal(fn(*args), want), fn.name
    got = cs.fake_select_mask(*(a.reshape((256, 6) + a.shape[1:]) for a in args))
    assert torch.equal(got.reshape(rows, t), want)
    assert torch.equal(want.sum(1).to(torch.int32), args[2])


@pytest.mark.parametrize("option", [dict(fused_heads=True), dict(rng_draw_bits=16)],
                         ids=["fused_heads", "draw16"])
def test_option_train_step_kernels_match_plain(dev, option):
    """One p1 update with `fused_heads` or with 16-bit draws (drawn from a
    generator on the card), with the kernels against without, from the
    same weights and draws: losses within 1e-5, parameters under the Adam
    eps-regime rule."""
    b, t, c = 32, 354, 6
    cfg = Config(batch_size=b, num_timestamps=t, dropout=0.0, **option)
    cohorts = process_splits(make_synthetic_cohorts(n_total=60, max_obs=t, seed=2),
                             rng=np.random.RandomState(0))
    data = {k: torch.as_tensor(v, device=dev)
            for k, v in ArrayDataset(cfg, cohorts["training"], "training").arrays().items()}
    batch = gather_batch(data, torch.arange(b, device=dev))
    gen = torch.Generator(device=dev).manual_seed(3)
    width = cfg.rng_draw_bits
    draws = {"fake_bits": draw_bits((b, c, t), gen, dev, width),
             "fake_noise": torch.rand((b, c, t), generator=gen, device=dev,
                                      dtype=torch.float16 if width == 16 else torch.float32),
             "perm": torch.randperm(2 * b, generator=gen, device=dev)}
    net_k = Net(cfg, generator=torch.Generator().manual_seed(4)).to(dev)
    net_p = copy.deepcopy(net_k)
    losses = {}
    for use_kernels, net in ((True, net_k), (False, net_p)):
        inputs = build_inputs(cfg, batch, None, True, False, draws, use_kernels)
        losses[use_kernels] = update(net, make_optimizer(cfg, net.parameters()), cfg, inputs,
                                     None, use_kernels)
    for k, v in losses[False].items():
        assert abs(float(losses[True][k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))), k
    plain = dict(net_p.named_parameters())
    n_viol = n_tot = 0
    for n, p in net_k.named_parameters():
        d = (p.detach() - plain[n].detach()).abs()
        assert float(d.max()) <= 2 * cfg.init_lr, n
        n_viol += int((d > 1e-5 + 1e-5 * plain[n].detach().abs()).sum())
        n_tot += d.numel()
    assert n_viol <= max(1, n_tot // 10_000)
