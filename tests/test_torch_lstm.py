"""Port of the biLSTM recurrence (B6/B7, `ops/cuda_lstm.py`) vs the JAX
package's `bilstm_recurrence_pallas` and `bilstm_forward(use_pallas=True)`,
on the CPU at small sizes, where the Pallas pair runs in interpret mode and
the port's wrappers take their plain versions.

The same inputs, made with numpy from a seed, go to both packages.
Tolerance: 1e-5 (abs, and relative to each value) in float32, for the
forward and for every cotangent of the VJP. The full model at
`use_pallas_lstm=True` is held at the model tests' 1e-5 and, after one
update, at the step tests' parameter rule (1e-5 outside Adam's eps regime).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.models import forward as jforward
from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.ops.lstm import bilstm_forward as jbilstm_forward
from deep_interpolation_clustering_tpu.ops.lstm import lstm_init
from deep_interpolation_clustering_tpu.ops.pallas_lstm import bilstm_recurrence_pallas
from deep_interpolation_clustering_tpu.train.optim import make_optimizer as jmake_optimizer
from deep_interpolation_clustering_tpu.train.steps import _make_update
from deep_interpolation_clustering_tpu.train.steps import build_inputs as jbuild_inputs
from deep_interpolation_clustering_tpu_torch.ops import cuda_lstm
from deep_interpolation_clustering_tpu_torch.ops.lstm import LSTMWeights, bilstm_forward
from deep_interpolation_clustering_tpu_torch.train import make_optimizer, update
from test_torch_model import AUX, configs, jax_batch, port_net, to_torch
from test_torch_step import _assert_params_close

torch.set_num_threads(1)

TOL = 1e-5
SHAPES = [(6, 13, 16), (9, 5, 32), (1, 3, 16)]  # (T, B, H); B not a multiple of 8


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def _recurrence_inputs(rng, t, b, h):
    bound = 1.0 / np.sqrt(h)
    f32 = np.float32
    return [
        rng.randn(t, b, 4 * h).astype(f32),  # xg_f
        rng.randn(t, b, 4 * h).astype(f32),  # xg_b
        rng.uniform(-bound, bound, (2, h, 4 * h)).astype(f32),  # w_hhT
        rng.uniform(-bound, bound, (2, 4 * h)).astype(f32),  # b_hh
        (rng.randn(2, b, h) * 0.5).astype(f32),  # h0
        (rng.randn(2, b, h) * 0.5).astype(f32),  # c0
    ]


@pytest.mark.parametrize("t,b,h", SHAPES)
def test_recurrence_and_vjp_match_jax_pallas(t, b, h):
    """Forward and VJP, with random cotangents on all four outputs at every
    t (interior c included), through the port's `LSTMRecurrence` and through
    the plain backward on its own."""
    rng = np.random.RandomState(100 * t + h)
    ins = _recurrence_inputs(rng, t, b, h)
    cots = [rng.randn(t, b, h).astype(np.float32) for _ in range(4)]
    want, vjp = jax.vjp(bilstm_recurrence_pallas, *map(jnp.asarray, ins))
    want_grads = vjp(tuple(map(jnp.asarray, cots)))

    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    got = cuda_lstm.bilstm_recurrence(*tins)
    for name, a, w in zip(("ys_f", "ys_b", "cs_f", "cs_b"), got, want):
        _close(a.detach(), w, name)
    got_grads = torch.autograd.grad(got, tins, [torch.from_numpy(c) for c in cots])
    names = ("dxg_f", "dxg_b", "dw_hhT", "db_hh", "dh0", "dc0")
    for name, a, w in zip(names, got_grads, want_grads):
        _close(a, w, name)

    plain = cuda_lstm._recurrence_bwd_plain(
        *map(torch.from_numpy, ins[:3]), None, *map(torch.from_numpy, ins[3:]),
        *(a.detach() for a in got), *map(torch.from_numpy, cots))
    for name, a, w in zip(names, plain, want_grads):
        _close(a, w, "plain " + name)


def _port_weights(p, feat, hidden):
    w = LSTMWeights(feat, hidden)
    sd = {}
    for d, suffix in (("fwd", ""), ("bwd", "_reverse")):
        for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                          ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
            sd[f"{name}_l0{suffix}"] = torch.from_numpy(np.array(p[d][key]))
    w.load_state_dict(sd)
    return w


@pytest.mark.parametrize("with_state", [True, False])
def test_bilstm_forward_matches_jax_pallas(with_state):
    """`bilstm_forward` (kernel route, plain on the CPU) against JAX
    `bilstm_forward(use_pallas=True)`: outputs, final states, and the
    gradients of a weighted sum of all three w.r.t. x, h0, c0 and weights."""
    t, b, feat, hidden = 6, 11, 18, 16
    rng = np.random.RandomState(7)
    params = lstm_init(jax.random.PRNGKey(1), feat, hidden)
    x = rng.randn(t, b, feat).astype(np.float32)
    h0 = (rng.randn(2, b, hidden) * 0.3).astype(np.float32) if with_state else None
    c0 = (rng.randn(2, b, hidden) * 0.3).astype(np.float32) if with_state else None
    wo, wh, wc = (rng.randn(*s).astype(np.float32)
                  for s in ((t, b, 2 * hidden), (2, b, hidden), (2, b, hidden)))

    def jloss(params, x, h0, c0):
        o, h, c = jbilstm_forward(params, x, h0, c0, use_pallas=True)
        return jnp.sum(o * wo) + jnp.sum(h * wh) + jnp.sum(c * wc), (o, h, c)

    jargs = [params, jnp.asarray(x)] + [None if a is None else jnp.asarray(a) for a in (h0, c0)]
    argnums = (0, 1, 2, 3) if with_state else (0, 1)
    (_, want), jgrads = jax.value_and_grad(jloss, argnums=argnums, has_aux=True)(*jargs)

    weights = _port_weights(params, feat, hidden)
    tx = torch.from_numpy(x).requires_grad_()
    th0, tc0 = (None if a is None else torch.from_numpy(a).requires_grad_() for a in (h0, c0))
    got = bilstm_forward(weights, tx, th0, tc0, use_kernel=True)
    for name, a, w in zip(("output", "hidden", "cell"), got, want):
        _close(a.detach(), w, name)
    loss = sum(torch.sum(a * torch.from_numpy(w)) for a, w in zip(got, (wo, wh, wc)))
    loss.backward()
    _close(tx.grad, jgrads[1], "dx")
    if with_state:
        _close(th0.grad, jgrads[2], "dh0")
        _close(tc0.grad, jgrads[3], "dc0")
    want_w = _port_weights(jgrads[0], feat, hidden).state_dict()
    for name, p in weights.named_parameters():
        _close(p.grad, want_w[name], name)


def test_kernel_route_equals_plain_route_on_cpu():
    """On the CPU the kernel route is the plain recurrence behind an
    autograd Function: the same forward values, and the Function's
    backward (autograd of the recomputed forward) gives the same
    gradients."""
    rng = np.random.RandomState(3)
    weights = LSTMWeights(12, 16)
    weights.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.randn(6, 9, 12).astype(np.float32))
    grads = []
    for use_kernel in (True, False):
        weights.zero_grad()
        out, h, c = bilstm_forward(weights, x, use_kernel=use_kernel)
        (out.sum() + 0.5 * h.sum() + 0.25 * c.sum()).backward()
        grads.append((out.detach(), h.detach(), c.detach(),
                      [p.grad.clone() for p in weights.parameters()]))
    for a, b in zip(grads[0][:3], grads[1][:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(grads[0][3], grads[1][3]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("train", [False, True])
def test_net_forward_matches_jax_with_pallas_lstm(train):
    """Net.forward (kernels route) vs the JAX forward with the Pallas LSTM
    pair in interpret mode: latent, reconstruction and every head."""
    jcfg, cfg = configs(aux_tasks=AUX, dropout=0.0, use_pallas_lstm=True)
    params, state = init_net(jax.random.PRNGKey(11), jcfg)
    inputs = jbuild_inputs(jcfg, jax_batch(jcfg), jax.random.PRNGKey(12), train, False)
    out = jforward(params, state, jcfg, inputs["x"], inputs["fake_x"],
                   inputs["fake_perm_idx"], train=train, key=jax.random.PRNGKey(3))
    net = port_net(cfg, params, state)
    ti = to_torch(inputs)
    with torch.no_grad():
        got = net(ti["x"], ti["fake_x"], ti["fake_perm_idx"], train=train, use_kernels=True)
    _close(got.hidden, out.hidden, "hidden")
    _close(got.rec, out.rec, "rec")
    for k in got.aux:
        _close(got.aux[k], out.aux[k], k)


def test_update_matches_jax_with_pallas_lstm():
    """One update (forward, losses, backward through B7's plain version,
    clip, amsgrad Adam) vs the JAX update with `use_pallas_lstm=True`."""
    jcfg, cfg = configs(dropout=0.0, use_pallas_lstm=True)
    params, state = init_net(jax.random.PRNGKey(13), jcfg)
    joptimizer = jmake_optimizer(jcfg)
    opt_state = joptimizer.init(params)
    net = port_net(cfg, params, state)
    opt = make_optimizer(cfg, net.parameters())
    batch = jax_batch(jcfg)
    key = jax.random.PRNGKey(14)
    inputs = jbuild_inputs(jcfg, batch, jax.random.split(key)[0], True, False)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    params, state, opt_state, jlosses = jax.jit(_make_update(jcfg, joptimizer, False))(
        params, state, opt_state, batch, key)
    losses = update(net, opt, cfg, to_torch(inputs), None, use_kernels=True)
    for k in jlosses:
        assert abs(float(losses[k]) - float(jlosses[k])) <= TOL * max(
            1.0, abs(float(jlosses[k]))), k
    eps_regime = {n: n.endswith(".model.0.bias")
                  | ((p.grad + cfg.weight_decay_rate * before[n]).abs() < 1e-6)
                  for n, p in net.named_parameters()}
    _assert_params_close(net, params, state, eps_regime, 2 * cfg.init_lr, "update")
