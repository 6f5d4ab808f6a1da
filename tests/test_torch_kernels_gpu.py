"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. These need a CUDA card and `nvcc` (the kernels have no CPU
mode), so they skip elsewhere. They import neither JAX nor this
directory's conftest, so they run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Shapes cover the ragged edges the kernels mask themselves: rows that do not
fill a block, T below and across a warp, R from 1 to 8, rows with k = 0.
Tolerances: the select is bit-identical; forward values 1e-5 (abs and
relative, float32); gradients 1e-4 of their largest element.
"""

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.models import Net
from deep_interpolation_clustering_tpu_torch.ops import cuda_interp as ci
from deep_interpolation_clustering_tpu_torch.ops import cuda_select as cs
from deep_interpolation_clustering_tpu_torch.ops.interpolation import (
    Planes,
    reference_times,
    sci_forward,
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


@pytest.mark.parametrize("t", [1, 24, 31, 33, 354, 1024])
def test_fake_select_bit_identical(dev, t):
    rng = np.random.RandomState(t)
    rows = 37
    n_valid = rng.randint(0, t + 1, size=rows).astype(np.int32)
    n_valid[:2] = (0, t)  # an empty row and a full row
    k = np.where(n_valid > 0, np.maximum(1, n_valid // 2), 0).astype(np.int32)
    bits = rng.randint(0, 2**32, size=(rows, t), dtype=np.uint64).astype(np.uint32)
    args = [torch.from_numpy(a).to(dev) for a in (bits.view(np.int32), n_valid, k)]
    got = cs.fake_select(*args)
    assert torch.equal(got, cs._select_sort(*args))
    assert torch.equal(got.sum(1).to(torch.int32), args[2])


@pytest.mark.parametrize("rows,t,r", [(15, 7, 1), (18, 354, 6), (1536, 354, 6), (6, 40, 8)])
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


@pytest.mark.parametrize("rows,t,r", [(15, 7, 1), (1536, 354, 6), (6, 40, 8)])
def test_rbf_push_forward_and_backward(dev, rows, t, r):
    c = 3 if rows % 6 else 6
    _, ts, mask = _planes(rows * t, rows, t, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    beta = torch.rand(c, generator=gen, device=dev) + 0.5
    proj = torch.randn((rows, r), generator=gen, device=dev)
    ref_t = reference_times(r, 6.0, device=dev)
    torch.testing.assert_close(ci.rbf_push_k(ts, mask, proj, beta, ref_t),
                               ci._rbf_plain(ts, mask, proj, beta, ref_t),
                               rtol=1e-5, atol=1e-5)
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
    with pytest.raises(ValueError, match="T <= 1024"):
        n = torch.ones(2, dtype=torch.int32, device=dev)
        cs.fake_select(torch.zeros((2, 1025), dtype=torch.int32, device=dev), n, n)
