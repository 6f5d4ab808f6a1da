"""The port's DEC head, KL and triplet losses and the triplet stream vs the
JAX package, on the CPU at a small width (B=8, T=24, H=16, K=3, dropout 0).

  * `soft_assignment` and `target_distribution` (with and without
    `sample_mask`), `kl_loss` and `triplet_loss` (masked and unmasked) at
    1e-6 on the same NumPy inputs.
  * `Net(clustering=True)`: `cluster_pred`, `cluster_label` and the triplet
    `positive`/`negative` against the JAX `forward`, both fed JAX's
    `build_inputs` outputs, at 1e-5.
  * One update in `ae_mse_sup_fake_detect_kl` and one in `..._kl_triplet`
    from the same weights and inputs, and one masked tail step with KL:
    every parameter (the centres too) at 1e-5, under the Adam eps-regime
    rule of `tests/test_torch_step.py`.
  * The centres and their optimizer moments survive port -> JAX and JAX ->
    port checkpoints, and the port's `build_inputs` fed JAX's draws gives
    JAX's triplet positive.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from deep_interpolation_clustering_tpu.models import forward as jforward
from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.models.losses import kl_loss as jkl_loss
from deep_interpolation_clustering_tpu.models.losses import triplet_loss as jtriplet_loss
from deep_interpolation_clustering_tpu.ops import dec as jdec
from deep_interpolation_clustering_tpu.train import checkpoint as jckpt
from deep_interpolation_clustering_tpu.train.optim import make_optimizer as jmake_optimizer
from deep_interpolation_clustering_tpu.train.steps import _make_update, make_train_step
from deep_interpolation_clustering_tpu.train.steps import build_inputs as jbuild_inputs
from deep_interpolation_clustering_tpu_torch.compat import (
    jax_from_state_dict,
    optimizer_from_jax,
    optimizer_to_jax,
    state_dict_from_jax,
)
from deep_interpolation_clustering_tpu_torch.models import Net
from deep_interpolation_clustering_tpu_torch.models.losses import kl_loss, triplet_loss
from deep_interpolation_clustering_tpu_torch.ops import dec
from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt
from deep_interpolation_clustering_tpu_torch.train import make_optimizer, update
from deep_interpolation_clustering_tpu_torch.train.steps import build_inputs
from test_torch_model import configs, jax_batch, to_torch
from test_torch_step import _amsgrad_state, _assert_params_close

torch.set_num_threads(1)

K = 3
KL = "ae_mse_sup_fake_detect_kl"
KL_TRIPLET = "ae_mse_sup_fake_detect_kl_triplet"
MASK = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)


def dec_configs(triplet=False, **kw):
    extra = dict(loss=KL_TRIPLET, triple_margin=1.0) if triplet else dict(loss=KL)
    return configs(dropout=0.0, cluster_number=K, **extra, **kw)


def dec_net(cfg, params, state):
    net = Net(cfg, clustering=True)
    net.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return net


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ------------------------------------------------------------ ops, losses
@pytest.mark.parametrize("masked", [False, True])
def test_soft_assignment_and_target_distribution_match_jax(masked):
    rng = np.random.RandomState(0)
    z = rng.randn(8, 32).astype(np.float32)
    mu = rng.randn(K, 32).astype(np.float32)
    mask = MASK if masked else None
    for alpha in (1.0, 2.5):
        q = dec.soft_assignment(torch.from_numpy(mu), torch.from_numpy(z), alpha)
        jq = jdec.soft_assignment(jnp.asarray(mu), jnp.asarray(z), alpha)
        assert _max_abs(q, jq) <= 1e-6
        torch.testing.assert_close(q.sum(1), torch.ones(8), rtol=0, atol=1e-6)
        p = dec.target_distribution(q, None if mask is None else torch.from_numpy(mask))
        jp = jdec.target_distribution(jq, None if mask is None else jnp.asarray(mask))
        assert _max_abs(p, jp) <= 1e-6


def test_centers_init_is_xavier_uniform():
    g = torch.Generator().manual_seed(0)
    c = dec.centers_init(K, 32, g)
    bound = np.sqrt(6.0 / (K + 32))
    assert c.shape == (K, 32) and float(c.abs().max()) <= bound
    assert torch.equal(c, dec.centers_init(K, 32, torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("masked", [False, True])
def test_kl_and_triplet_losses_match_jax(masked):
    rng = np.random.RandomState(1)
    q = rng.rand(8, K).astype(np.float32) + 0.05
    q /= q.sum(1, keepdims=True)
    p = np.square(q) / q.sum(0)
    p /= p.sum(1, keepdims=True)
    p[0, 1] = 0.0  # a label of 0 contributes 0 (xlogy)
    a, pos, neg = (rng.randn(8, 16).astype(np.float32) for _ in range(3))
    mask = MASK if masked else None
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    got = kl_loss(torch.from_numpy(p), torch.from_numpy(q), tm)["kl"]
    want = jkl_loss(jnp.asarray(p), jnp.asarray(q), jm)["kl"]
    assert np.isfinite(float(got)) and abs(float(got) - float(want)) <= 1e-6
    for margin in (0.0, 1.0, 5.0):
        got = triplet_loss(*(torch.from_numpy(v) for v in (a, pos, neg)), margin, tm)
        want = jtriplet_loss(*(jnp.asarray(v) for v in (a, pos, neg)), margin, jm)
        assert abs(float(got["triplet"]) - float(want["triplet"])) <= 1e-6, margin


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("triplet", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_clustering_forward_matches_jax(train, triplet):
    jcfg, cfg = dec_configs(triplet)
    params, state = init_net(jax.random.PRNGKey(1), jcfg, clustering=True)
    batch = jax_batch(jcfg)
    batch["sample_mask"] = MASK
    inputs = jbuild_inputs(jcfg, batch, jax.random.PRNGKey(2), train, False)
    assert (inputs["positive_x"] is not None) == triplet
    out = jforward(params, state, jcfg, inputs["x"], inputs["fake_x"], inputs["fake_perm_idx"],
                   positive_x=inputs["positive_x"], train=train, key=jax.random.PRNGKey(3),
                   sample_mask=inputs["sample_mask"])
    net = dec_net(cfg, params, state)
    ti = to_torch(inputs)
    with torch.no_grad():
        got = net(ti["x"], ti["fake_x"], ti["fake_perm_idx"], ti["positive_x"], train=train,
                  sample_mask=ti["sample_mask"])
    want_keys = {"future_vital", "fake_det", "cluster_pred", "cluster_label"} | (
        {"positive", "negative"} if triplet else set())
    assert set(got.aux) == set(out.aux) == want_keys
    assert _max_abs(got.hidden, out.hidden) <= 1e-5
    for k in want_keys:
        assert got.aux[k].shape == out.aux[k].shape, k
        assert _max_abs(got.aux[k], out.aux[k]) <= 1e-5, k
    assert not got.aux["cluster_label"].requires_grad


def test_build_inputs_triplet_positive_matches_jax_given_its_draws():
    """The positive is the re-masked real stream jittered by `pos_noise`,
    never denoised: with JAX's draws it is JAX's."""
    jcfg, cfg = dec_configs(True)
    batch = jax_batch(jcfg)
    key = jax.random.PRNGKey(8)
    want = jbuild_inputs(jcfg, batch, key, True, True)
    _, _, _, _, k_pos, _ = jax.random.split(key, 6)
    shape = batch["ob"].shape
    draws = {
        "pos_noise": torch.from_numpy(np.array(jax.random.normal(k_pos, (2,) + shape))),
        "fake_bits": torch.zeros(shape, dtype=torch.int32),
        "fake_noise": torch.zeros(shape),
        "perm": torch.from_numpy(np.array(want["fake_perm_idx"]).astype(np.int64)),
    }
    got = build_inputs(cfg, to_torch(batch), None, True, True, draws)
    for a, b in zip(got["positive_x"], want["positive_x"]):
        assert _max_abs(a, b) <= 1e-6
    # drawn from a generator when not given: the same shapes, after the fake draws
    drawn = build_inputs(cfg, to_torch(batch), torch.Generator().manual_seed(0), True, False)
    assert drawn["positive_x"].ob.shape == shape
    assert build_inputs(dec_configs(False)[1], to_torch(batch), torch.Generator(), True,
                        False)["positive_x"] is None


# ------------------------------------------------------------- the steps
def _eps_regime(net, before, cfg):
    return {n: n.endswith(".model.0.bias")
            | ((p.grad + cfg.weight_decay_rate * before[n]).abs() < 1e-6)
            for n, p in net.named_parameters()}


def _check_losses(losses, jlosses):
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        assert abs(float(losses[k]) - float(jlosses[k])) <= 1e-5 * max(
            1.0, abs(float(jlosses[k]))), k


@pytest.mark.parametrize("triplet", [False, True], ids=["kl", "kl_triplet"])
def test_dec_update_matches_jax(triplet):
    """One update from the same weights and inputs: every parameter, the
    centres included, at 1e-5 under the eps-regime rule, and the centres'
    first Adam moment."""
    jcfg, cfg = dec_configs(triplet)
    params, state = init_net(jax.random.PRNGKey(10), jcfg, clustering=True)
    joptimizer = jmake_optimizer(jcfg)
    opt_state = joptimizer.init(params)
    net = dec_net(cfg, params, state)
    opt = make_optimizer(cfg, net.parameters())
    batch = jax_batch(jcfg)
    key = jax.random.PRNGKey(100)
    inputs = jbuild_inputs(jcfg, batch, jax.random.split(key)[0], True, False)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    params, state, opt_state, jlosses = jax.jit(_make_update(jcfg, joptimizer, False))(
        params, state, opt_state, batch, key)
    losses = update(net, opt, cfg, to_torch(inputs), None)
    _check_losses(losses, jlosses)
    assert {"kl"} | ({"triplet"} if triplet else set()) <= set(losses)
    _assert_params_close(net, params, state, _eps_regime(net, before, cfg), 2 * cfg.init_lr,
                         "dec step")
    centers = net.cluster_assignment.cluster_centers
    assert not torch.equal(centers, before["cluster_assignment.cluster_centers"])
    mu = ravel_pytree(params)[1](_amsgrad_state(opt_state).mu)["cluster_centers"]
    np.testing.assert_allclose(opt.state[centers]["exp_avg"].numpy(), np.asarray(mu),
                               rtol=1e-4, atol=1e-4 * float(np.abs(mu).max()))


def test_dec_masked_tail_step_matches_jax():
    """5 real encounters repeated to B=8, `sample_mask` 1 on them, KL on,
    against JAX `make_train_step(masked=True)`."""
    jcfg, cfg = dec_configs(False)
    params, state = init_net(jax.random.PRNGKey(20), jcfg, clustering=True)
    joptimizer = jmake_optimizer(jcfg)
    opt_state = joptimizer.init(params)
    net = dec_net(cfg, params, state)
    opt = make_optimizer(cfg, net.parameters())
    data = jax_batch(jcfg)
    idx = np.resize(np.array([6, 2, 5, 0, 3], np.int32), cfg.batch_size)
    mask = (np.arange(cfg.batch_size) < 5).astype(np.float32)
    batch = {k: v[idx] for k, v in data.items()}
    batch["sample_mask"] = mask
    key = jax.random.PRNGKey(21)
    inputs = jbuild_inputs(jcfg, batch, jax.random.split(key)[0], True, False)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    jstep = make_train_step(jcfg, joptimizer, False, gather=True, masked=True)
    params, state, opt_state, jlosses = jstep(
        params, state, opt_state, {k: jnp.asarray(v) for k, v in data.items()},
        jnp.asarray(idx), jnp.asarray(mask), key)
    losses = update(net, opt, cfg, to_torch(inputs), None)
    _check_losses(losses, jlosses)
    _assert_params_close(net, params, state, _eps_regime(net, before, cfg), 2 * cfg.init_lr,
                         "dec tail step")


# ------------------------------------------------------------ checkpoints
def test_dec_state_dict_roundtrip_names_the_centres():
    jcfg, cfg = dec_configs(False)
    params, state = init_net(jax.random.PRNGKey(0), jcfg, clustering=True)
    net = dec_net(cfg, params, state)
    sd = net.state_dict()
    assert "cluster_assignment.cluster_centers" in sd
    assert sd["cluster_assignment.cluster_centers"].shape == (K, cfg.dim_enc_hidden)
    p2, _ = jax_from_state_dict(sd)
    np.testing.assert_array_equal(p2["cluster_centers"], np.asarray(params["cluster_centers"]))


def test_dec_checkpoint_roundtrips_with_jax(tmp_path):
    """Port -> JAX: after a port update the JAX `load_checkpoint` gives the
    port's centres and, unravelled, their Adam moments. JAX -> port: a JAX
    DEC checkpoint's centres and moments land on the port's centres."""
    jcfg, cfg = dec_configs(False)
    params, state = init_net(jax.random.PRNGKey(30), jcfg, clustering=True)
    net = dec_net(cfg, params, state)
    opt = make_optimizer(cfg, net.parameters())
    update(net, opt, cfg, to_torch(jbuild_inputs(jcfg, jax_batch(jcfg), jax.random.PRNGKey(31),
                                                 True, False)), None)
    p_port, s_port = jax_from_state_dict(net.state_dict())
    path = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(path, 2, p_port, s_port, optimizer_to_jax(opt, net, 1))
    template = jmake_optimizer(jcfg).init(params)
    _, jparams, _, jopt, _ = jckpt.load_checkpoint(path, opt_state_template=template)
    centers = net.cluster_assignment.cluster_centers
    np.testing.assert_array_equal(np.asarray(jparams["cluster_centers"]), centers.detach().numpy())
    unravel = ravel_pytree(params)[1]
    ams = _amsgrad_state(jopt)
    for vec, key in ((ams.mu, "exp_avg"), (ams.nu, "exp_avg_sq"),
                     (ams.nu_max, "max_exp_avg_sq")):
        np.testing.assert_array_equal(np.asarray(unravel(vec)["cluster_centers"]),
                                      opt.state[centers][key].numpy(), err_msg=key)

    # JAX -> port: moments with a distinct value in the centres' slot
    joptimizer = jmake_optimizer(jcfg)
    opt_state = joptimizer.init(params)
    leaves, treedef = jax.tree_util.tree_flatten(opt_state)
    marked = {k: (jnp.full_like(v, 0.25) if k == "cluster_centers"
                  else jax.tree_util.tree_map(jnp.zeros_like, v)) for k, v in params.items()}
    vec = ravel_pytree(marked)[0]
    leaves = [vec if leaf.shape == vec.shape else leaf for leaf in leaves]
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, 4, params, state,
                          jax.tree_util.tree_unflatten(treedef, leaves))
    net2 = Net(cfg, generator=torch.Generator().manual_seed(5), clustering=True)
    opt2 = make_optimizer(cfg, net2.parameters())
    _, p2, s2, got_leaves, _ = ckpt.load_checkpoint(path, optimizer_to_jax(opt2, net2, 0))
    net2.load_state_dict(state_dict_from_jax(p2, s2), strict=True)
    optimizer_from_jax(opt2, net2, got_leaves)
    c2 = net2.cluster_assignment.cluster_centers
    np.testing.assert_array_equal(c2.detach().numpy(), np.asarray(params["cluster_centers"]))
    for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
        assert torch.equal(opt2.state[c2][key], torch.full_like(c2, 0.25)), key
        others = [opt2.state[p][key] for n, p in net2.named_parameters()
                  if n != "cluster_assignment.cluster_centers"]
        assert all(not t.any() for t in others), key
