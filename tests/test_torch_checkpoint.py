"""The port's checkpoints vs the JAX package's, on the CPU at a small width.

A checkpoint is the JAX npz: `params/...`, `state/...`, the optimizer
state's flat leaves `opt/00000...` and the JSON `__meta__`. Each package
restores the other's file:
  * port -> JAX `load_checkpoint` with the JAX optimizer's template: params
    and state exact, every optimizer leaf equal to the port's state (each
    vector unravelled by the JAX params' `ravel_pytree` and mapped to the
    port's parameter names);
  * JAX -> the port: the restored forward equals JAX's at 1e-5, and one
    further update of each package's optimizer from its restored state, on
    the same gradient, agrees at 1e-5.
Then `FlagDict`, `early_stop`, `merge_state` and `partial_restore` against
JAX's on the same inputs.
"""

import json

import jax
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from deep_interpolation_clustering_tpu.models import forward as jforward
from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.train import checkpoint as jckpt
from deep_interpolation_clustering_tpu.train.optim import make_optimizer as jmake_optimizer
from deep_interpolation_clustering_tpu.train.steps import build_inputs as jbuild_inputs
from deep_interpolation_clustering_tpu_torch.compat import (
    jax_from_state_dict,
    optimizer_from_jax,
    optimizer_to_jax,
    state_dict_from_jax,
)
from deep_interpolation_clustering_tpu_torch.compat.jax_params import OPT_VECTORS
from deep_interpolation_clustering_tpu_torch.info import METRICS
from deep_interpolation_clustering_tpu_torch.models import Net
from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt
from deep_interpolation_clustering_tpu_torch.train import make_optimizer, update
from deep_interpolation_clustering_tpu_torch.train.optim import clip_grad_global_norm_
from deep_interpolation_clustering_tpu_torch.train.steps import forward_and_losses
from test_torch_model import configs, jax_batch, port_net, to_torch

torch.set_num_threads(1)

OPTIMIZERS = ["adam", "sgd", "rmsprop"]
# the JAX leaf names behind each optimizer's vectors, in leaf order
JAX_VECTORS = {"adam": ("mu", "nu", "nu_max"), "sgd": ("trace",), "rmsprop": ("nu", "trace")}
TORCH_KIND = {"adam": "Adam", "sgd": "SGD", "rmsprop": "RMSprop"}


def _port_steps(name, n_steps=2, seed=31):
    """A port net with JAX's initial weights after `n_steps` updates of
    `name`, and the JAX (params, state) it started from."""
    jcfg, cfg = configs(dropout=0.0, optimizer=name)
    params, state = init_net(jax.random.PRNGKey(seed), jcfg)
    net = port_net(cfg, params, state)
    opt = make_optimizer(cfg, net.parameters())
    batch = jax_batch(jcfg)
    for step in range(n_steps):
        key = jax.random.PRNGKey(seed + 1 + step)
        update(net, opt, cfg, to_torch(jbuild_inputs(jcfg, batch, key, True, False)), None)
    return jcfg, cfg, net, opt, params


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_port_checkpoint_restores_in_jax(tmp_path, name):
    jcfg, cfg, net, opt, jparams0 = _port_steps(name)
    params, state = jax_from_state_dict(net.state_dict())
    leaves = optimizer_to_jax(opt, net, 2)
    path = str(tmp_path / "checkpoint.npz")
    ckpt.save_checkpoint(path, 5, params, state, leaves, extra={"lr": 1e-3, "metric": "loss"})

    template = jmake_optimizer(jcfg).init(jparams0)
    epoch, jparams, jstate, jopt, meta = jckpt.load_checkpoint(path, opt_state_template=template)
    assert epoch == 5 and meta["metric"] == "loss" and jopt is not None
    # params and state exact
    for got, want in ((jparams, params), (jstate, state)):
        g, w = jckpt._flatten_nested(got), jckpt._flatten_nested(want)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # every optimizer leaf: the template's structure, dtype and shape, and
    # the port's values
    flat = jax.tree_util.tree_flatten_with_path(jopt)[0]
    assert len(flat) == len(leaves) == 2 + (name == "adam") + len(JAX_VECTORS[name])
    for (path_, leaf), want, tmpl in zip(flat, leaves, jax.tree_util.tree_leaves(template)):
        assert leaf.dtype == tmpl.dtype and leaf.shape == tmpl.shape, jax.tree_util.keystr(path_)
        np.testing.assert_array_equal(np.asarray(leaf), want)
    names = [jax.tree_util.keystr(p) for p, _ in flat]
    assert names[:2] == [".count", ".hyperparams['learning_rate']"]
    assert [n.rsplit(".", 1)[-1] for n in names[-len(JAX_VECTORS[name]):]] == list(
        JAX_VECTORS[name])
    assert int(flat[0][1]) == 2
    assert np.float32(flat[1][1]) == np.float32(opt.param_groups[0]["lr"])
    # each vector, unravelled as JAX unravels it, is the port's state
    unravel = ravel_pytree(jparams0)[1]
    for (_, vec), key in zip(flat[-len(JAX_VECTORS[name]):], OPT_VECTORS[TORCH_KIND[name]]):
        per_name = state_dict_from_jax(unravel(vec), jstate)
        for n, p in net.named_parameters():
            np.testing.assert_array_equal(per_name[n].numpy(), opt.state[p][key].numpy(),
                                          err_msg=f"{key} {n}")


def _random_state(opt_state, rng):
    """The JAX optimizer state with every leaf replaced: count 2, a rate,
    moments of the size two steps leave (second moments positive)."""
    leaves, treedef = jax.tree_util.tree_flatten(opt_state)
    out = [np.asarray(2, np.int32), np.asarray(1.7e-3, np.float32)]
    for leaf in leaves[2:]:
        if leaf.shape == ():  # Adam's inner count
            out.append(np.asarray(2, np.int32))
        else:
            out.append((rng.rand(*leaf.shape).astype(np.float32) + 0.5) * 1e-2)
    return jax.tree_util.tree_unflatten(treedef, out)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_jax_checkpoint_restores_in_the_port(tmp_path, name):
    """Weights and optimizer state from a JAX checkpoint; then one more
    update from the same gradient (the port's backward on a batch) with
    each package's optimizer: every parameter within 1e-5. The moments
    are random and of the size a few steps leave, far from any eps."""
    jcfg, cfg = configs(dropout=0.0, optimizer=name)
    params, state = init_net(jax.random.PRNGKey(41), jcfg)
    joptimizer = jmake_optimizer(jcfg)
    opt_state = _random_state(joptimizer.init(params), np.random.RandomState(1))
    path = str(tmp_path / "checkpoint.npz")
    jckpt.save_checkpoint(path, 3, params, state, opt_state, extra={"lr": 3e-3})

    net = Net(cfg, generator=torch.Generator().manual_seed(0))  # other weights
    opt = make_optimizer(cfg, net.parameters())
    epoch, p2, s2, leaves, meta = ckpt.load_checkpoint(path, optimizer_to_jax(opt, net, 0))
    assert epoch == 3 and meta == {"epoch": 3, "lr": 3e-3} and leaves is not None
    net.load_state_dict(state_dict_from_jax(p2, s2), strict=True)
    for n, v in state_dict_from_jax(params, state).items():
        assert torch.equal(net.state_dict()[n], v), n
    assert optimizer_from_jax(opt, net, leaves) == 2
    # the leaves go back out unchanged (the rate is the trainer's to set)
    opt.param_groups[0]["lr"] = 1.7e-3
    for got, want in zip(optimizer_to_jax(opt, net, 2), jax.tree_util.tree_leaves(opt_state)):
        np.testing.assert_array_equal(got, np.asarray(want))

    # one more update from the same gradient
    for g in opt.param_groups:
        g["lr"] = cfg.init_lr
    jax_lr = opt_state.hyperparams["learning_rate"]
    opt_state.hyperparams["learning_rate"] = jax.numpy.asarray(cfg.init_lr, jax_lr.dtype)
    batch = jax_batch(jcfg)
    inputs = jbuild_inputs(jcfg, batch, jax.random.PRNGKey(44), True, False)
    opt.zero_grad()
    _, losses = forward_and_losses(net, cfg, to_torch(inputs), True, None)
    losses["loss"].backward()
    grads = jax_from_state_dict({**net.state_dict(), **{
        n: p.grad.clone() for n, p in net.named_parameters()}})[0]
    clip_grad_global_norm_(net.parameters(), cfg.grad_clip)
    opt.step()
    updates, _ = joptimizer.update(grads, opt_state, params)
    want = state_dict_from_jax(optax.apply_updates(params, updates), state)
    for n, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name} {n}")
    start = state_dict_from_jax(params, state)
    assert max(float((p.detach() - start[n]).abs().max())
               for n, p in net.named_parameters()) > 1e-4


def test_restored_forward_matches_jax(tmp_path):
    """A JAX checkpoint's weights give the port's eval forward JAX's
    latents and reconstructions at 1e-5."""
    jcfg, cfg = configs(dropout=0.0)
    params, state = init_net(jax.random.PRNGKey(45), jcfg)
    path = str(tmp_path / "checkpoint.npz")
    jckpt.save_checkpoint(path, 1, params, state)
    _, p2, s2, _, _ = ckpt.load_checkpoint(path)
    net = Net(cfg)
    net.load_state_dict(state_dict_from_jax(p2, s2), strict=True)
    inputs = jbuild_inputs(jcfg, jax_batch(jcfg), jax.random.PRNGKey(43), False, False)
    want = jforward(params, state, jcfg, inputs["x"], inputs["fake_x"],
                    inputs["fake_perm_idx"], train=False)
    t_in = to_torch(inputs)
    with torch.no_grad():
        got = net(t_in["x"], t_in["fake_x"], t_in["fake_perm_idx"], train=False)
    np.testing.assert_allclose(got.hidden.numpy(), np.asarray(want.hidden), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.rec.numpy(), np.asarray(want.rec), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_weights_only_or_other_layout_starts_the_optimizer_fresh(tmp_path, name, caplog):
    """A weights-only file, and one of another optimizer, restore the
    weights and leave no optimizer leaves, with the JAX log lines."""
    jcfg, cfg, net, opt, _ = _port_steps(name, n_steps=1)
    params, state = jax_from_state_dict(net.state_dict())
    template = optimizer_to_jax(opt, net, 1)
    other = "sgd" if name != "sgd" else "adam"
    _, cfg_o, net_o, opt_o, _ = _port_steps(other, n_steps=1)
    logger = ckpt.logger
    logger.addHandler(caplog.handler)
    try:
        for tag, leaves in (("weights", None), ("other", optimizer_to_jax(opt_o, net_o, 1))):
            path = str(tmp_path / f"{tag}.npz")
            ckpt.save_checkpoint(path, 1, params, state, leaves)
            caplog.clear()
            epoch, p2, s2, got, _ = ckpt.load_checkpoint(path, template)
            assert got is None and epoch == 1
            for k, v in ckpt._flatten_nested(params).items():
                np.testing.assert_array_equal(ckpt._flatten_nested(p2)[k], v)
            want = ("no optimizer state (weights-only)" if tag == "weights"
                    else "optimizer state layout mismatch")
            assert want in caplog.text
    finally:
        logger.removeHandler(caplog.handler)


# a scripted validation sequence: improvements, ties (<= improves), a
# metric missing from some rows, then a stall past the patience
SCRIPT = [
    {"loss": 3.0, "ae_mse": 2.0},
    {"loss": 2.5, "ae_mse": 2.1},
    {"loss": 2.5, "ae_mse": 1.9},
    {"loss": 2.6},
    {"loss": 2.4, "ae_mse": 1.95, "delta": 0.3},
    {"loss": 2.45, "ae_mse": 1.95},
    {"loss": 2.5, "ae_mse": 2.0},
    {"loss": 2.41, "ae_mse": 1.96},
    {"loss": 2.7, "ae_mse": 2.2},
    {"loss": 2.8, "ae_mse": 2.3},
]


@pytest.mark.parametrize("patience", [1, 3, 50])
def test_flag_dict_and_early_stop_match_jax(patience):
    got, want = ckpt.FlagDict(METRICS), jckpt.FlagDict(METRICS)
    stops = []
    for epoch, metrics in enumerate(SCRIPT, start=1):
        assert got.improved(metrics, epoch) == want.improved(metrics, epoch)
        assert got.to_dict() == want.to_dict()
        stop = got.early_stop(epoch, patience)
        assert stop == want.early_stop(epoch, patience)
        stops.append(stop)
    assert got.state_dict() == want.state_dict()
    assert json.loads(json.dumps(got.state_dict()))["best"]["delta"] == 0.3
    first = stops.index(True) + 1 if True in stops else None
    assert first == {1: 4, 3: 8, 50: None}[patience]


def test_merge_state_matches_jax():
    """Min-merging snapshots (a never-improved metric saved as null)."""
    snaps = []
    for upto in (3, 6, 9):
        f = jckpt.FlagDict(METRICS)
        for epoch, metrics in enumerate(SCRIPT[:upto], start=1):
            f.improved(metrics, epoch)
        snaps.append(json.loads(json.dumps(f.state_dict())))
    snaps.append({"best": {"loss": None, "ae_mse": 0.5}, "best_epoch": {"ae_mse": 11}})
    got, want = ckpt.FlagDict(METRICS), jckpt.FlagDict(METRICS)
    for s in snaps:
        got.merge_state(s)
        want.merge_state(s)
        assert got.to_dict() == want.to_dict()
    assert got.best["ae_mse"] == 0.5 and got.best_epoch["ae_mse"] == 11


def test_partial_restore_matches_jax():
    rng = np.random.RandomState(0)
    target = {"a": {"w": np.zeros((3, 2), np.float32), "b": np.zeros(2, np.float32)},
              "dec": {"centers": np.ones((4, 2), np.float32)}}
    source = {"a": {"w": rng.rand(3, 2), "b": rng.rand(3)}, "extra": {"x": rng.rand(2)}}
    got, got_loaded = ckpt.partial_restore(target, source)
    want, want_loaded = jckpt.partial_restore(target, source)
    assert got_loaded == want_loaded == ["a/w"]
    g, w = ckpt._flatten_nested(got), jckpt._flatten_nested(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype
        np.testing.assert_array_equal(g[k], w[k])


def test_weight_dirs_match_jax(tmp_path):
    got = ckpt.weight_dirs(str(tmp_path / "port"), METRICS)
    want = jckpt.weight_dirs(str(tmp_path / "jax"), METRICS)
    assert [p.replace("port", "jax") for p in got.values()] == list(want.values())
    assert ckpt.CKPT_NAME == jckpt.CKPT_NAME
