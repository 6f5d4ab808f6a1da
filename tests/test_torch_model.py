"""Port of the model (Net, losses, inputs, config, weight map) vs the JAX
package, on the CPU at a small width.

Both packages compute from the same weights (JAX `init_net` carried over by
`state_dict_from_jax`) and the same inputs (JAX `build_inputs` outputs).
Tolerance: 1e-5 max abs in float32 unless a test states otherwise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu import Config as JConfig
from deep_interpolation_clustering_tpu.data import ArrayDataset as JArrayDataset
from deep_interpolation_clustering_tpu.data import make_synthetic_cohorts, process_splits
from deep_interpolation_clustering_tpu.models import forward as jforward
from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.models.losses import compute_losses as jcompute_losses
from deep_interpolation_clustering_tpu.ops.interpolation import Planes as JPlanes
from deep_interpolation_clustering_tpu.train.checkpoint import _unflatten_nested
from deep_interpolation_clustering_tpu.train.steps import build_inputs as jbuild_inputs
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch import config as port_config
from deep_interpolation_clustering_tpu_torch.compat import jax_from_state_dict, state_dict_from_jax
from deep_interpolation_clustering_tpu_torch.models import Net
from deep_interpolation_clustering_tpu_torch.models.losses import compute_losses
from deep_interpolation_clustering_tpu_torch.ops.interpolation import Planes
from deep_interpolation_clustering_tpu_torch.train.steps import build_inputs

torch.set_num_threads(1)

ATOL = 1e-5
SMALL = dict(batch_size=8, num_timestamps=24, lstm_hidden=16, head_hidden=16)
AUX = {"future_vital": 0.5, "ICU": 1.0}  # covers the aux head too


def configs(**kw):
    """The same configuration in both packages."""
    jcfg = JConfig(**{**SMALL, **kw})
    cfg = Config.from_dict({k: getattr(jcfg, k) for k in Config.__dataclass_fields__})
    return jcfg, cfg


def jax_batch(jcfg, n=8, seed=21):
    cohorts = process_splits(
        make_synthetic_cohorts(n_total=40, max_obs=jcfg.num_timestamps, seed=seed),
        rng=np.random.RandomState(0),
    )
    ds = JArrayDataset(jcfg, cohorts["training"], "training")
    b = ds.batch(np.arange(n))
    b.pop("index")
    return {k: np.asarray(v, np.float32) for k, v in b.items()}


def to_torch(tree):
    """JAX `build_inputs` outputs (or batch dicts) -> torch, same structure."""
    if tree is None:
        return None
    if isinstance(tree, JPlanes):
        return Planes(*(to_torch(a) for a in tree))
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    a = np.array(tree)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)


def port_net(cfg, params, state):
    net = Net(cfg)
    net.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return net


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_state_dict_roundtrip_exact():
    jcfg, cfg = configs(aux_tasks=AUX)
    params, state = init_net(jax.random.PRNGKey(0), jcfg)
    net = port_net(cfg, params, state)
    assert set(net.state_dict()) == set(state_dict_from_jax(params, state))
    p2, s2 = jax_from_state_dict(net.state_dict())
    for (path, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path((params, state)),
        jax.tree_util.tree_leaves_with_path((p2, s2)),
    ):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
    assert jax.tree_util.tree_structure((params, state)) == \
        jax.tree_util.tree_structure((p2, s2))


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(train, use_kernels):
    """Net.forward vs JAX forward on the real+fake streams: hidden, rec,
    every aux head and (train) the BatchNorm running stats. Dropout 0."""
    jcfg, cfg = configs(aux_tasks=AUX, dropout=0.0)
    params, state = init_net(jax.random.PRNGKey(1), jcfg)
    inputs = jbuild_inputs(jcfg, jax_batch(jcfg), jax.random.PRNGKey(2), train, False)
    out = jforward(params, state, jcfg, inputs["x"], inputs["fake_x"],
                   inputs["fake_perm_idx"], train=train, key=jax.random.PRNGKey(3))
    net = port_net(cfg, params, state)
    ti = to_torch(inputs)
    with torch.no_grad():
        got = net(ti["x"], ti["fake_x"], ti["fake_perm_idx"], train=train,
                  use_kernels=use_kernels)
    assert _max_abs(got.hidden, out.hidden) <= ATOL
    assert _max_abs(got.rec, out.rec) <= ATOL
    assert set(got.aux) == set(out.aux) == {"future_vital", "ICU", "fake_det"}
    for k in got.aux:
        assert _max_abs(got.aux[k], out.aux[k]) <= ATOL, k
    _, s_port = jax_from_state_dict(net.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(out.state),
                                 jax.tree_util.tree_leaves_with_path(s_port)):
        assert _max_abs(a, b) <= ATOL, path


def test_forward_train_sample_mask_matches_jax():
    """A padded batch: BatchNorm moments weighted by the sample mask."""
    jcfg, cfg = configs(dropout=0.0)
    params, state = init_net(jax.random.PRNGKey(4), jcfg)
    batch = jax_batch(jcfg)
    batch["sample_mask"] = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    inputs = jbuild_inputs(jcfg, batch, jax.random.PRNGKey(5), True, False)
    out = jforward(params, state, jcfg, inputs["x"], inputs["fake_x"],
                   inputs["fake_perm_idx"], train=True, key=jax.random.PRNGKey(0),
                   sample_mask=inputs["sample_mask"])
    net = port_net(cfg, params, state)
    ti = to_torch(inputs)
    with torch.no_grad():
        got = net(ti["x"], ti["fake_x"], ti["fake_perm_idx"], train=True,
                  sample_mask=ti["sample_mask"])
    assert _max_abs(got.hidden, out.hidden) <= ATOL
    assert _max_abs(got.rec, out.rec) <= ATOL
    _, s_port = jax_from_state_dict(net.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(out.state), jax.tree_util.tree_leaves(s_port)):
        assert _max_abs(a, b) <= ATOL


@pytest.mark.parametrize("masked", [False, True])
def test_compute_losses_matches_jax(masked):
    """Both packages' losses from the same JAX `build_inputs` outputs and
    forward outputs."""
    jcfg, cfg = configs(aux_tasks=AUX)
    params, state = init_net(jax.random.PRNGKey(6), jcfg)
    batch = jax_batch(jcfg)
    if masked:
        batch["sample_mask"] = np.array([1, 0, 1, 1, 1, 1, 0, 1], np.float32)
    inputs = jbuild_inputs(jcfg, batch, jax.random.PRNGKey(7), True, False)
    out = jforward(params, state, jcfg, inputs["x"], inputs["fake_x"],
                   inputs["fake_perm_idx"], train=False)
    want = jcompute_losses(jcfg, inputs["ob"], inputs["padding_mask"], out,
                           inputs["aux_label"], inputs["future_vital_mask"],
                           inputs["fake_det_label"], inputs["sample_mask"],
                           inputs["fake_row_mask"])
    ti = to_torch(inputs)
    port_out = type("O", (), {"rec": to_torch(out.rec),
                              "aux": {k: to_torch(v) for k, v in out.aux.items()}})
    got = compute_losses(cfg, ti["ob"], ti["padding_mask"], port_out, ti["aux_label"],
                         ti["future_vital_mask"], ti["fake_det_label"],
                         ti["sample_mask"], ti["fake_row_mask"])
    assert set(got) == set(want) == {"loss", "ae_mse", "future_vital", "ICU",
                                     "fake_detection"}
    for k in got:
        assert abs(float(got[k]) - float(want[k])) <= ATOL * max(1.0, abs(float(want[k]))), k


@pytest.mark.parametrize("aug_input,denoise", [(False, False), (True, False), (True, True)])
def test_build_inputs_matches_jax_given_its_draws(aug_input, denoise):
    """The port's build_inputs fed the draws JAX takes from its key gives
    JAX's inputs: augmented and denoised real stream, fake stream,
    permutation and labels. 1e-6 where `noise*scale - scale/2` or the jitter
    `ob + noise*std` may fuse differently, exact elsewhere."""
    jcfg, cfg = configs(aug_input=aug_input)
    batch = jax_batch(jcfg)
    key = jax.random.PRNGKey(8)
    want = jbuild_inputs(jcfg, batch, key, True, denoise)
    k_aug, k_fake, k_fake_aug, _, _, _ = jax.random.split(key, 6)
    k_sel, k_noise = jax.random.split(k_fake)
    shape = batch["ob"].shape
    normal = lambda k: torch.from_numpy(np.array(jax.random.normal(k, (2,) + shape)))
    draws = {
        "aug_noise": normal(k_aug),
        "fake_bits": torch.from_numpy(
            np.array(jax.random.bits(k_sel, shape, dtype=jnp.uint32)).view(np.int32)),
        "fake_noise": torch.from_numpy(np.array(jax.random.uniform(k_noise, shape))),
        "fake_aug_noise": normal(k_fake_aug),
        "perm": torch.from_numpy(np.array(want["fake_perm_idx"]).astype(np.int64)),
    }
    got = build_inputs(cfg, to_torch(batch), None, True, denoise, draws)
    for name in ("padding_mask", "fake_perm_idx", "fake_det_label"):
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), name)
    assert _max_abs(got["ob"], want["ob"]) <= 1e-6
    for stream in ("x", "fake_x"):
        for a, b in zip(got[stream], want[stream]):
            assert _max_abs(a, b) <= 1e-6, stream


def test_onchip_parity_fixture_golden():
    """The committed fixture holds the original torch model's weights, an
    input (32, 24, 354) and its eval outputs at full width: the port's eval
    forward reproduces them at 1e-5."""
    path = os.path.join(os.path.dirname(__file__), "fixtures", "onchip_parity.npz")
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    params = _unflatten_nested(
        {k[len("params/"):]: v for k, v in arrays.items() if k.startswith("params/")})
    state = _unflatten_nested(
        {k[len("state/"):]: v for k, v in arrays.items() if k.startswith("state/")})
    cfg = Config(fake_detection=False, aux_tasks={})
    net = port_net(cfg, params, state)
    with torch.no_grad():
        out = net(torch.from_numpy(arrays["x"]), train=False)
    assert _max_abs(out.hidden, arrays["torch_hidden"]) <= ATOL
    assert _max_abs(out.rec, arrays["torch_rec"]) <= ATOL


def test_config_loads_jax_config_json(tmp_path):
    jcfg = JConfig(batch_size=32, lstm_hidden=64, use_pallas=True, seed=3)
    path = jcfg.save(str(tmp_path))
    cfg = Config.load(path)
    for f in Config.__dataclass_fields__:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.batch_size, cfg.lstm_hidden, cfg.seed) == (32, 64, 3)
    assert cfg.loss_components == jcfg.loss_components


def test_config_p2_fields_round_trip_with_jax(tmp_path, monkeypatch):
    """The K-selection fields load from a JAX config.json (tuples from JSON
    lists), are not ignored, and the port's saved config loads in JAX."""
    p2 = dict(k_max=6, select_opt_k=("elbow",), n_init=3, gap_b=4, gap_subsample=100,
              opt_eps=2.5, internal_metrics=("Dunn_Index", "Sihouette"), overwrite=True,
              dbscan_impl="sklearn")
    logged = []
    monkeypatch.setattr(port_config.log, "info", lambda msg, *a: logged.append(msg % a))
    cfg = Config.load(JConfig(**p2).save(str(tmp_path / "jax")))
    for name, value in p2.items():
        assert getattr(cfg, name) == value, name
        assert type(getattr(cfg, name)) is type(value), name
    ignored = " ".join(m for m in logged if "ignoring" in m)
    assert "use_pallas" in ignored and not any(name in ignored for name in p2)
    back = JConfig.load(cfg.save(str(tmp_path / "port")))
    for name, value in p2.items():
        assert getattr(back, name) == value, name
    for name in p2:
        assert getattr(Config(), name) == getattr(JConfig(), name), name


def test_config_rejects_unknown_and_bad_values(tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"batch_size": 4, "not_a_field": 1}))
    with pytest.raises(ValueError, match="unknown"):
        Config.load(str(path))
    with pytest.raises(ValueError):
        Config(optimizer="adagrad")
    with pytest.raises(ValueError):
        Config(batch_size=0)
    for k_max in (1, 0):
        with pytest.raises(ValueError, match="k_max"):
            Config(k_max=k_max)
    with pytest.raises(ValueError, match="dbscan_impl"):
        Config(dbscan_impl="gpu")
