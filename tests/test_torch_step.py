"""Port of the training step (forward, losses, backward, global-norm clip,
amsgrad Adam with L2 weight decay) vs the JAX package's `_make_update` with
`make_optimizer`, on the CPU at a small width, plus the trainer.

Both sides start from the same weights and take the same inputs: each step
the port's `update` gets the `build_inputs` outputs JAX computes inside its
own step. Dropout is 0.

Tolerance on parameters: 1e-5 (+1e-5 relative) on every element outside
Adam's eps regime; inside it, what Adam can move an element, 2*lr per step.
Adam moves an element by about lr*g/(|g|+eps), whose sensitivity to the
gradient, lr*eps/(|g|+eps)^2, turns float32 gradient noise (~1e-7) into
differences above 1e-5 once |g| is near eps. Two kinds of element are in
that regime: those whose effective gradient |g + wd*p| fell below 1e-6 at
some step, and the fc1 biases in front of a train-mode BatchNorm
(`*.model.0.bias`), whose true gradient is 0 (the BatchNorm removes them,
so they reach no output) and whose update is weight decay against noise.
The test runs at the model's full width (H=128) on a small batch.
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.train.optim import (
    ScaleByTorchAmsgradState,
    make_optimizer as jmake_optimizer,
)
from deep_interpolation_clustering_tpu.train.steps import _make_update, make_train_step
from deep_interpolation_clustering_tpu.train.steps import build_inputs as jbuild_inputs
from deep_interpolation_clustering_tpu_torch.compat import state_dict_from_jax
from deep_interpolation_clustering_tpu_torch.ops.nn import BN_MOMENTUM
from deep_interpolation_clustering_tpu_torch.data import (
    ArrayDataset,
    make_synthetic_cohorts as port_synthetic,
    process_splits as port_process_splits,
)
from deep_interpolation_clustering_tpu_torch.train import Trainer, make_optimizer, update
from deep_interpolation_clustering_tpu_torch.train.optim import clip_grad_global_norm_
from deep_interpolation_clustering_tpu_torch.train.graphs import GraphedStep
from test_torch_model import configs, jax_batch, port_net, to_torch

torch.set_num_threads(1)

N_STEPS = 3
FULL_WIDTH = dict(lstm_hidden=128, head_hidden=128)


def _assert_params_close(net, params, state, eps_regime, max_move, tag):
    want = state_dict_from_jax(params, state)
    for name, p in net.named_parameters():
        diff = (p.detach() - want[name]).abs()
        beyond = diff > 1e-5 + 1e-5 * want[name].abs()
        outside = beyond & ~eps_regime[name]
        assert not outside.any(), (
            f"{tag} {name}: {int(outside.sum())} elements beyond 1e-5, "
            f"max {float(diff[outside].max()):.2e}")
        assert float(diff.max()) <= max_move, f"{tag} {name}: max {float(diff.max()):.2e}"


def _amsgrad_state(opt_state):
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, ScaleByTorchAmsgradState))
    return next(x for x in leaves if isinstance(x, ScaleByTorchAmsgradState))


@pytest.mark.parametrize("grad_clip", [15.0, 0.5])
def test_update_steps_match_jax(grad_clip):
    """3 steps: params (and BN running stats) after each, the losses, and
    the Adam moments after the last. `grad_clip=0.5` makes the clip fire on
    every step (the gradient norm is ~5-7 here); 15, the default, does not."""
    jcfg, cfg = configs(dropout=0.0, grad_clip=grad_clip, **FULL_WIDTH)
    params, state = init_net(jax.random.PRNGKey(10), jcfg)
    joptimizer = jmake_optimizer(jcfg)
    opt_state = joptimizer.init(params)
    jupdate = jax.jit(_make_update(jcfg, joptimizer, False))

    net = port_net(cfg, params, state)
    opt = make_optimizer(cfg, net.parameters())
    batch = jax_batch(jcfg)
    clipped = []
    bias_drift = {n: torch.zeros_like(v) for n, v in net.state_dict().items()
                  if n.endswith(".1.running_mean")}
    eps_regime = {n: torch.full_like(p, n.endswith(".model.0.bias"), dtype=torch.bool)
                  for n, p in net.named_parameters()}
    for step in range(N_STEPS):
        key = jax.random.PRNGKey(100 + step)
        inputs = jbuild_inputs(jcfg, batch, jax.random.split(key)[0], True, False)
        before = {n: p.detach().clone() for n, p in net.named_parameters()}
        # BatchNorm running means see the fc1 bias (eps regime, see above):
        # carry each step's bias difference into the expected mean offset
        jbefore = state_dict_from_jax(params, state)
        for n in bias_drift:
            bias = n.replace(".1.running_mean", ".0.bias")
            bias_drift[n] = (1 - BN_MOMENTUM) * bias_drift[n] + BN_MOMENTUM * (
                before[bias] - jbefore[bias])
        params, state, opt_state, jlosses = jupdate(params, state, opt_state, batch, key)
        losses = update(net, opt, cfg, to_torch(inputs), None)
        for n, p in net.named_parameters():
            g_eff = p.grad + cfg.weight_decay_rate * before[n]
            eps_regime[n] |= g_eff.abs() < 1e-6
        for k in jlosses:
            assert abs(float(losses[k]) - float(jlosses[k])) <= 1e-5 * max(
                1.0, abs(float(jlosses[k]))), (step, k)
        _assert_params_close(net, params, state, eps_regime,
                             2 * cfg.init_lr * (step + 1), f"step {step + 1}")
        clipped.append(float(torch.sqrt(sum(torch.sum(p.grad ** 2)
                                            for p in net.parameters()))))
        sd = net.state_dict()
        for name, v in state_dict_from_jax(params, state).items():
            if "running" in name:
                got = sd[name] - bias_drift.get(name, 0.0)
                np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=name)
    if grad_clip < 1:
        # the clipped gradient's global norm is the clip value
        np.testing.assert_allclose(clipped, grad_clip, rtol=1e-5)

    # Adam moments after the last step, each within 1e-4 of its tensor's
    # largest element: the eps-regime elements above sit up to 2*lr apart
    # after a step, and the gradients of the next steps see that. The fc1
    # biases in front of a BatchNorm are left out: their gradient is
    # float32 noise around 0 in both packages.
    unravel = ravel_pytree(params)[1]
    ams = _amsgrad_state(opt_state)
    mu = state_dict_from_jax(unravel(ams.mu), state)
    nu_max = state_dict_from_jax(unravel(ams.nu_max), state)
    for name, p in net.named_parameters():
        if name.endswith(".model.0.bias"):
            continue
        st = opt.state[p]
        for got, want in ((st["exp_avg"], mu[name]), (st["max_exp_avg_sq"], nu_max[name])):
            want = want.numpy()
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(want).max()), err_msg=name)


def test_clip_matches_optax_rule():
    """Scaled by max_norm / norm when norm >= max_norm, untouched below; no
    +1e-6 in the denominator."""
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    norm = clip_grad_global_norm_([p], 1.0)
    assert float(norm) == 5.0
    torch.testing.assert_close(p.grad, torch.tensor([0.6, 0.8, 0.0]), rtol=0, atol=1e-7)
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    clip_grad_global_norm_([p], 6.0)
    torch.testing.assert_close(p.grad, torch.tensor([3.0, 4.0, 0.0]), rtol=0, atol=0)


def test_trainer_cpu_steps_and_eval(tmp_path):
    """The trainer on the CPU: steps change every parameter, losses are
    finite, an epoch runs, eval gives (B, 2H) latents."""
    _, cfg = configs()
    cohorts = port_process_splits(
        port_synthetic(n_total=60, max_obs=cfg.num_timestamps, seed=3),
        rng=np.random.RandomState(0),
    )
    ds = {c: ArrayDataset(cfg, d, c) for c, d in cohorts.items()}
    tr = Trainer(cfg, ds, str(tmp_path), device="cpu")
    before = {n: p.detach().clone() for n, p in tr.net.named_parameters()}
    losses = tr.train_steps(3)
    assert all(torch.isfinite(v) for step in losses for v in step.values())
    for n, p in tr.net.named_parameters():
        assert not torch.equal(p, before[n]), n
    epoch = tr.train_one_epoch()
    assert np.isfinite(epoch["loss"])
    hidden = tr.eval_batch("validation")
    assert hidden.shape == (cfg.batch_size, cfg.dim_enc_hidden)
    assert torch.isfinite(hidden).all()


def test_masked_tail_step_matches_jax():
    """The padded tail step: 5 real encounters cyclically repeated to B=8
    with `sample_mask` 1 on the real rows, against JAX
    `make_train_step(masked=True)` on the same padded batch and draws."""
    jcfg, cfg = configs(dropout=0.0)
    params, state = init_net(jax.random.PRNGKey(20), jcfg)
    joptimizer = jmake_optimizer(jcfg)
    opt_state = joptimizer.init(params)
    net = port_net(cfg, params, state)
    opt = make_optimizer(cfg, net.parameters())
    data = jax_batch(jcfg)  # an 8-encounter cohort
    tail = np.array([6, 2, 5, 0, 3], np.int32)
    idx = np.resize(tail, cfg.batch_size)
    mask = np.zeros(cfg.batch_size, np.float32)
    mask[: len(tail)] = 1.0
    batch = {k: v[idx] for k, v in data.items()}
    batch["sample_mask"] = mask
    key = jax.random.PRNGKey(21)
    inputs = jbuild_inputs(jcfg, batch, jax.random.split(key)[0], True, False)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    jstep = make_train_step(jcfg, joptimizer, False, gather=True, masked=True)
    params, state, opt_state, jlosses = jstep(
        params, state, opt_state, {k: jax.numpy.asarray(v) for k, v in data.items()},
        jax.numpy.asarray(idx), jax.numpy.asarray(mask), key)
    losses = update(net, opt, cfg, to_torch(inputs), None)
    for k in jlosses:
        assert abs(float(losses[k]) - float(jlosses[k])) <= 1e-5 * max(
            1.0, abs(float(jlosses[k]))), k
    eps_regime = {n: n.endswith(".model.0.bias")
                  | ((p.grad + cfg.weight_decay_rate * before[n]).abs() < 1e-6)
                  for n, p in net.named_parameters()}
    _assert_params_close(net, params, state, eps_regime, 2 * cfg.init_lr, "tail step")
    sd = net.state_dict()
    for name, v in state_dict_from_jax(params, state).items():
        if "running_var" in name:  # the running means carry the fc1-bias drift
            np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_trainer_epoch_visits_every_encounter_once(monkeypatch, tmp_path):
    """42 training encounters at B=8: five full batches and a masked tail of
    2 real rows padded by repeating them. `train_one_epoch`, fused (the
    rows given to the graph steps) and stepped, and the `train_steps`
    stream each visit every training index exactly once."""
    _, cfg = configs()
    cohorts = port_process_splits(
        port_synthetic(n_total=60, max_obs=cfg.num_timestamps, seed=3),
        rng=np.random.RandomState(0),
    )
    ds = {c: ArrayDataset(cfg, d, c) for c, d in cohorts.items()}
    n = len(ds["training"])
    assert n % cfg.batch_size == 2
    tr = Trainer(cfg, ds, str(tmp_path), device="cpu")
    seen = []
    step = tr.step
    monkeypatch.setattr(tr, "step", lambda idx, mask=None: seen.append((idx, mask))
                        or step(idx, mask))
    replay = GraphedStep.__call__
    monkeypatch.setattr(GraphedStep, "__call__", lambda self, rows, mask=None: seen.append(
        (rows.clone(), mask)) or replay(self, rows, mask))

    def real_rows():
        rows = []
        for idx, mask in seen:
            assert idx.shape == (cfg.batch_size,)
            if mask is None:
                rows += idx.tolist()
            else:
                k = int(mask.sum())
                assert mask[:k].eq(1).all() and mask[k:].eq(0).all()
                np.testing.assert_array_equal(idx.numpy(), np.resize(idx[:k].numpy(),
                                                                     cfg.batch_size))
                rows += idx[:k].tolist()
        seen.clear()
        return sorted(rows)

    assert cfg.fused_epoch
    epoch = tr.train_one_epoch()
    assert np.isfinite(epoch["loss"]) and tr._graphs
    assert real_rows() == list(range(n))
    cfg.fused_epoch = False
    epoch = tr.train_one_epoch()
    assert np.isfinite(epoch["loss"])
    assert real_rows() == list(range(n))
    losses = tr.train_steps(-(-n // cfg.batch_size))  # one epoch of steps
    assert all(torch.isfinite(v) for step_losses in losses for v in step_losses.values())
    assert real_rows() == list(range(n))
