"""Port of the interpolation ops (SCI, CCI, RBF push) vs the JAX package.

Same inputs from a NumPy seed go through the JAX function and the port's
counterpart on the CPU. The port's kernel entries (`cuda_interp.sci`,
`cuda_interp.rbf_push`) take their kernels' plain versions on CPU tensors;
the JAX Pallas kernels run in interpreter mode. Tolerance: 1e-5 max abs,
float32; gradients (magnitudes up to ~1e2) to 1e-5 of their largest
element, the scale at which both packages' float32 sums stand off a float64
evaluation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.ops import interpolation as jinterp
from deep_interpolation_clustering_tpu.ops import rbf as jrbf
from deep_interpolation_clustering_tpu.ops.pallas_interp import (
    rbf_project_pallas,
    sci_forward_hybrid,
    sci_forward_pallas,
)
from deep_interpolation_clustering_tpu_torch.ops import cuda_interp
from deep_interpolation_clustering_tpu_torch.ops import interpolation as tinterp
from deep_interpolation_clustering_tpu_torch.ops import rbf as trbf

torch.set_num_threads(1)

B, C, R, HOURS = 4, 6, 6, 6.0
ATOL = 1e-5


def _planes(rng, t=30, b=B):
    """Ragged front-packed masks with >= 1 observation per row (as p0 gives)."""
    mask = np.zeros((b, C, t), np.float32)
    for i in range(b):
        for j in range(C):
            mask[i, j, : rng.randint(1, t + 1)] = 1.0
    ob = rng.randn(b, C, t).astype(np.float32) * mask
    ts = np.sort(rng.rand(b, C, t).astype(np.float32) * HOURS, axis=-1) * mask
    return ob, mask, ts


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _assert_grad_close(got, want):
    want = np.asarray(want)
    assert _max_abs(got, want) <= ATOL * max(1.0, float(np.abs(want).max()))


def _assert_sci_close(got, want, t):
    """1e-5 max abs on the smooth and intensity blocks. The transient block
    (kappa=10 sharpened logits) at T=354 holds rows whose nearest
    observation sits far from a reference point: their logits reach ~-1e2,
    where float32 rounding moves the weights by ~1e-5 relative, and each
    package is itself that far from a float64 evaluation
    (`test_sci_forward_float64_reference`). That block gets 3e-5 at T=354,
    1e-5 below."""
    got, want = np.asarray(got), np.asarray(want)
    assert _max_abs(got[..., : 2 * C], want[..., : 2 * C]) <= ATOL
    assert _max_abs(got[..., 2 * C :], want[..., 2 * C :]) <= (3e-5 if t > 100 else ATOL)


def _sci_float64(ob, mask, ts, kernel):
    """SCI evaluated in float64 with NumPy: (B, R, 3C)."""
    alpha = np.log1p(np.exp(kernel.astype(np.float64)))[None, :, None, None]
    d = ts[..., None].astype(np.float64) - np.linspace(0.0, HOURS, R)
    logits = -alpha * d * d + np.where(mask[..., None] > 0, 0.0, -np.inf)

    def softmax_t(l):
        m = l.max(axis=2, keepdims=True)
        e = np.exp(l - m)
        s = e.sum(axis=2, keepdims=True)
        return e / s, (m + np.log(s))[:, :, 0]

    p, w = softmax_t(logits)
    q, _ = softmax_t(10.0 * logits)
    y = (p * ob[..., None]).sum(axis=2)
    yt = (q * ob[..., None]).sum(axis=2)
    return np.concatenate([y, w, yt], axis=1).transpose(0, 2, 1)


@pytest.mark.parametrize("seed", range(3))
def test_sci_forward_float64_reference(seed):
    """Both packages against a float64 evaluation at T=354: the smooth and
    intensity blocks to 1e-5, the transient block to 3e-5 (why the
    port-vs-JAX comparison above allows 3e-5 on that block)."""
    ob, mask, ts = _planes(np.random.RandomState(100 + seed), 354)
    kernel = np.random.RandomState(seed).rand(C).astype(np.float32)
    x = np.concatenate([ob, mask, ts, mask], axis=1)
    want = _sci_float64(ob, mask, ts, kernel)
    port = cuda_interp.sci(_t(kernel), _t(ob), _t(mask), _t(ts), R, HOURS).numpy()
    jax_ = np.asarray(jinterp.sci_forward(jnp.asarray(kernel), jnp.asarray(x), R, HOURS))
    for got in (port, jax_):
        assert _max_abs(got[..., : 2 * C], want[..., : 2 * C]) <= ATOL
        assert _max_abs(got[..., 2 * C :], want[..., 2 * C :]) <= 3e-5


@pytest.mark.parametrize("t", [30, 354])
def test_sci_forward_plain_matches_jax(rng, t):
    ob, mask, ts = _planes(rng, t)
    kernel = rng.rand(C).astype(np.float32)
    x = np.concatenate([ob, mask, ts, mask], axis=1)
    want = np.asarray(jinterp.sci_forward(jnp.asarray(kernel), jnp.asarray(x), R, HOURS))
    got = tinterp.sci_forward(_t(kernel), _t(x), R, HOURS).numpy()
    _assert_sci_close(got, want, t)


@pytest.mark.parametrize("t", [30, 354])
def test_sci_kernel_entry_matches_jax_and_pallas(rng, t):
    """`cuda_interp.sci` (K2's plain version on the CPU) vs JAX `sci_forward`
    and vs the Pallas `sci_forward_pallas` in interpreter mode."""
    ob, mask, ts = _planes(rng, t)
    kernel = rng.rand(C).astype(np.float32)
    x = np.concatenate([ob, mask, ts, mask], axis=1)
    got = cuda_interp.sci(_t(kernel), _t(ob), _t(mask), _t(ts), R, HOURS).detach().numpy()
    want = np.asarray(jinterp.sci_forward(jnp.asarray(kernel), jnp.asarray(x), R, HOURS))
    want_pl = np.asarray(sci_forward_pallas(jnp.asarray(kernel), jnp.asarray(x), R, HOURS))
    assert got.shape == (B, R, 3 * C)
    _assert_sci_close(got, want, t)
    _assert_sci_close(got, want_pl, t)


def test_sci_forward_multi_matches_per_stream(rng):
    ob, mask, ts = _planes(rng)
    ob2 = rng.randn(*ob.shape).astype(np.float32) * mask
    kernel = _t(rng.rand(C).astype(np.float32))
    m, t = _t(mask), _t(ts)
    streams = [tinterp.Planes(_t(o), m, t, m) for o in (ob, ob2)]
    multi = tinterp.sci_forward_multi(kernel, streams, R, HOURS)
    for got, p in zip(multi, streams):
        torch.testing.assert_close(got, tinterp.sci_forward(kernel, p, R, HOURS),
                                   rtol=0, atol=0)


def test_cci_forward_matches_jax(rng):
    rep = rng.randn(B, R, 3 * C).astype(np.float32)
    kernel = (np.eye(C) + 0.1 * rng.randn(C, C)).astype(np.float32)
    want = np.asarray(jinterp.cci_forward(jnp.asarray(kernel), jnp.asarray(rep)))
    got = tinterp.cci_forward(_t(kernel), _t(rep)).numpy()
    assert _max_abs(got, want) <= ATOL


@pytest.mark.parametrize("path", ["kernel_entry", "plain_autograd"])
def test_sci_gradients_match_jax_hybrid_vjp(rng, path):
    """dkernel, dx, dt and dm (where mask = 1) of sum(SCI * w): the port's
    SCIFunction backward (K3's explicit formula on the CPU) and plain
    autograd vs the VJP of JAX `sci_forward_hybrid` (Pallas backward in
    interpreter mode)."""
    ob, mask, ts = _planes(rng, 40)
    kernel = rng.rand(C).astype(np.float32)
    w = rng.randn(B, R, 3 * C).astype(np.float32)

    def jloss(k, planes):
        return jnp.sum(sci_forward_hybrid(k, planes, R, HOURS) * jnp.asarray(w))

    jplanes = jinterp.Planes(*(jnp.asarray(a) for a in (ob, mask, ts, mask)))
    gk, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(kernel), jplanes)

    k, o, m, t = _t(kernel, True), _t(ob, True), _t(mask, True), _t(ts, True)
    if path == "kernel_entry":
        out = cuda_interp.sci(k, o, m, t, R, HOURS)
    else:
        out = tinterp.sci_forward(k, tinterp.Planes(o, m, t, m), R, HOURS)
    torch.sum(out * _t(w)).backward()
    obs = mask > 0
    _assert_grad_close(k.grad.numpy(), gk)
    _assert_grad_close(o.grad.numpy(), gp.ob)
    _assert_grad_close(t.grad.numpy(), gp.ts)
    _assert_grad_close(m.grad.numpy()[obs], np.asarray(gp.mask)[obs])


def test_sci_kernel_entry_kernel_grad_only(rng):
    """In training only the SCI kernel needs a gradient: the backward then
    returns none for the planes and the same dkernel."""
    ob, mask, ts = _planes(rng)
    kernel = rng.rand(C).astype(np.float32)
    w = _t(rng.randn(B, R, 3 * C).astype(np.float32))
    k1 = _t(kernel, True)
    torch.sum(cuda_interp.sci(k1, _t(ob), _t(mask), _t(ts), R, HOURS) * w).backward()
    k2, o2 = _t(kernel, True), _t(ob, True)
    torch.sum(cuda_interp.sci(k2, o2, _t(mask), _t(ts), R, HOURS) * w).backward()
    torch.testing.assert_close(k1.grad, k2.grad, rtol=0, atol=0)


@pytest.mark.parametrize("basis", sorted(trbf.basis_func_dict()))
def test_rbf_push_plain_matches_jax(rng, basis):
    ob, mask, ts = _planes(rng)
    kernel = rng.rand(C).astype(np.float32)
    proj = rng.randn(B, C, R).astype(np.float32)
    x = np.concatenate([ob, mask, ts, mask], axis=1)
    want = np.asarray(jrbf.rbf_push(jnp.asarray(kernel), jnp.asarray(proj),
                                    jnp.asarray(x), R, HOURS, basis))
    got = trbf.rbf_push(_t(kernel), _t(proj), _t(x), R, HOURS, basis,
                        use_kernel=False).numpy()
    # the poisson bases change sign, so the normalizer sum_R phi can pass
    # through 0 and the quotient there has no float32 digits left in either
    # package: compare where |sum_R phi| >= 0.05 (all observed slots for the
    # positive bases), at 1e-5 of the output's magnitude
    beta = np.log1p(np.exp(kernel.astype(np.float64)))[None, :, None, None]
    dist = np.abs(ts[..., None].astype(np.float64) - np.linspace(0.0, HOURS, R))
    phi = trbf.basis_func_dict()[basis](torch.from_numpy(beta), torch.from_numpy(dist))
    keep = (mask > 0) & (np.abs(phi.numpy().sum(-1)) >= 0.05)
    assert keep.sum() > 0.5 * (mask > 0).sum()
    np.testing.assert_allclose(got[keep], want[keep], rtol=ATOL, atol=ATOL)


def test_rbf_kernel_entry_matches_jax_and_pallas(rng):
    """The gaussian push through `cuda_interp.rbf_push` (K4's plain version
    on the CPU) vs JAX `rbf_push` and the Pallas kernel in interpreter mode."""
    ob, mask, ts = _planes(rng, 354)
    kernel = rng.rand(C).astype(np.float32)
    proj = rng.randn(B, C, R).astype(np.float32)
    x = np.concatenate([ob, mask, ts, mask], axis=1)
    args = (jnp.asarray(kernel), jnp.asarray(proj), jnp.asarray(x), R, HOURS)
    want = np.asarray(jrbf.rbf_push(*args))
    want_pl = np.asarray(rbf_project_pallas(*args))
    got = trbf.rbf_push(_t(kernel), _t(proj), _t(x), R, HOURS).detach().numpy()
    assert _max_abs(got, want) <= ATOL
    assert _max_abs(got, want_pl) <= ATOL


def test_rbf_gradients_match_jax(rng):
    """RBFFunction's backward (autodiff of the plain formula) vs JAX
    autodiff of `rbf_push`, for the kernel and proj."""
    ob, mask, ts = _planes(rng)
    kernel = rng.rand(C).astype(np.float32)
    proj = rng.randn(B, C, R).astype(np.float32)
    w = rng.randn(B, C, 30).astype(np.float32)
    x = np.concatenate([ob, mask, ts, mask], axis=1)

    def jloss(k, p):
        return jnp.sum(jrbf.rbf_push(k, p, jnp.asarray(x), R, HOURS) * jnp.asarray(w))

    gk, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(kernel), jnp.asarray(proj))
    k, p = _t(kernel, True), _t(proj, True)
    torch.sum(trbf.rbf_push(k, p, _t(x), R, HOURS) * _t(w)).backward()
    _assert_grad_close(k.grad.numpy(), gk)
    _assert_grad_close(p.grad.numpy(), gp)
