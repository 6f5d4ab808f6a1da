"""The options the JAX package keeps off by default, ported: `fused_heads`
(`ops.nn.heads_apply_fused`, the fused `Net` forward) and
`rng_draw_bits=16` (16-bit select keys, float16 noise and normals), and
`viz_feat` (`Summary.add_embedding`, `Trainer.eval(viz_feat=True)` from
`cli.p1` and `cli.p3`), vs the JAX package on the CPU at a small width.

Tolerances: the fused forward and its BatchNorm statistics 1e-5 max abs
against JAX and against the port's unfused chain (the fused chain sums the
statistics by a product, in another order); the 16-bit draws and the
select on 16-bit keys exact; one train step under the repo's step rule
(losses 1e-5, parameters 1e-5 outside Adam's eps regime and within 2*lr in
it); the projector's tensors.tsv the same text for the same features, and
1e-5 for the latents of the two packages' eval.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.config import Config as JConfig
from deep_interpolation_clustering_tpu.data import ArrayDataset as JArrayDataset
from deep_interpolation_clustering_tpu.data import make_synthetic_cohorts, process_splits
from deep_interpolation_clustering_tpu.data.loader import augment_batch as jaugment_batch
from deep_interpolation_clustering_tpu.data.loader import make_fake_ob as jmake_fake_ob
from deep_interpolation_clustering_tpu.models import forward as jforward
from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.ops import nn as jnn
from deep_interpolation_clustering_tpu.ops.pallas_select import _select_xla
from deep_interpolation_clustering_tpu.train.optim import make_optimizer as jmake_optimizer
from deep_interpolation_clustering_tpu.train.steps import _make_update
from deep_interpolation_clustering_tpu.train.steps import build_inputs as jbuild_inputs
from deep_interpolation_clustering_tpu.train.summary import Summary as JSummary
from deep_interpolation_clustering_tpu.train.trainer import Trainer as JTrainer
from deep_interpolation_clustering_tpu_torch.cli import p1, p3
from deep_interpolation_clustering_tpu_torch.compat import jax_from_state_dict, state_dict_from_jax
from deep_interpolation_clustering_tpu_torch.data import ArrayDataset
from deep_interpolation_clustering_tpu_torch.data.loader import augment_batch, draw_bits, make_fake_ob
from deep_interpolation_clustering_tpu_torch.info import COHORTS, METRICS
from deep_interpolation_clustering_tpu_torch.ops import cuda_select as cs
from deep_interpolation_clustering_tpu_torch.ops.nn import Head, heads_apply_fused
from deep_interpolation_clustering_tpu_torch.train import Trainer, make_optimizer, update
from deep_interpolation_clustering_tpu_torch.train.steps import build_inputs
from deep_interpolation_clustering_tpu_torch.train.summary import Summary
from test_torch_model import AUX, configs, jax_batch, port_net, to_torch

torch.set_num_threads(1)

ATOL = 1e-5


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ------------------------------------------------------------ fused heads
def _heads(seed):
    """Three head trunks on a shared input width: a CompressFC-like one
    (ReLU, 2 outputs) and two plain ones, with drawn BatchNorm parameters
    and statistics; returns the port's (head, x) pairs and JAX's dicts."""
    g = torch.Generator().manual_seed(seed)
    in_dim, hidden = 12, 8
    specs = [(16, 3, True), (8, 6, False), (10, 2, False)]  # rows, outputs, relu
    port, jax_heads = [], []
    for rows, out_dim, relu in specs:
        h = Head(in_dim, hidden, out_dim, relu=relu)
        h.reset_parameters(g)
        bn = h.model[1]
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.uniform_(-0.5, 0.5, generator=g)
            bn.running_mean.uniform_(-0.5, 0.5, generator=g)
            bn.running_var.uniform_(0.5, 1.5, generator=g)
        x = torch.randn((rows, in_dim), generator=g)
        port.append((h, x))
        p = lambda t: jnp.asarray(t.detach().numpy())  # noqa: E731
        jax_heads.append({
            "params": {"fc1": {"w": p(h.model[0].weight), "b": p(h.model[0].bias)},
                       "bn": {"gamma": p(bn.weight), "beta": p(bn.bias)},
                       "fc2": {"w": p(h.model[-1].weight), "b": p(h.model[-1].bias)}},
            "state": {"bn": {"mean": p(bn.running_mean), "var": p(bn.running_var)}},
            "x": p(x), "relu": relu,
        })
    return port, jax_heads


@pytest.mark.parametrize("train,masked", [(False, False), (True, False), (True, True)])
def test_heads_apply_fused_matches_jax_and_the_unfused_heads(train, masked):
    port, jheads = _heads(1)
    masks = [None] * 3
    if masked:  # a padded tail on the first and last heads
        masks[0] = (torch.arange(16) < 11).float()
        masks[2] = (torch.arange(10) < 7).float()
        for jh, m in zip(jheads, masks):
            if m is not None:
                jh["row_mask"] = jnp.asarray(m.numpy())
    ys_j, states_j = jnn.heads_apply_fused(jheads, 0.0, train, None)
    unfused = [type(h)(12, 8, h.model[-1].weight.shape[0], h.relu) for h, _ in port]
    for u, (h, _) in zip(unfused, port):
        u.load_state_dict(h.state_dict())
    with torch.no_grad():
        ys = heads_apply_fused([(h, x, m) for (h, x), m in zip(port, masks)], 0.0, train, None)
        ys_u = [u(x, 0.0, train, None, m) for u, (_, x), m in zip(unfused, port, masks)]
    for i, ((h, _), u) in enumerate(zip(port, unfused)):
        assert _max_abs(ys[i], ys_j[i]) <= ATOL, i
        assert _max_abs(ys[i], ys_u[i]) <= ATOL, i
        bn, bn_u = h.model[1], u.model[1]
        for got, want, other in ((bn.running_mean, states_j[i]["bn"]["mean"], bn_u.running_mean),
                                 (bn.running_var, states_j[i]["bn"]["var"], bn_u.running_var)):
            assert _max_abs(got, want) <= ATOL, i
            assert _max_abs(got, other) <= ATOL, i


def test_heads_apply_fused_gradients_match_the_unfused_heads():
    port, _ = _heads(2)
    unfused = [type(h)(12, 8, h.model[-1].weight.shape[0], h.relu) for h, _ in port]
    for u, (h, _) in zip(unfused, port):
        u.load_state_dict(h.state_dict())
    w = [torch.randn(y.shape, generator=torch.Generator().manual_seed(i))
         for i, y in enumerate(h(x, 0.0, False, None) for h, x in port)]
    loss = sum((y * wi).sum() for y, wi in zip(heads_apply_fused(
        [(h, x, None) for h, x in port], 0.0, True, None), w))
    loss_u = sum((u(x, 0.0, True, None) * wi).sum() for u, (_, x), wi in zip(unfused, port, w))
    loss.backward()
    loss_u.backward()
    for (h, _), u in zip(port, unfused):
        for (name, p), p_u in zip(h.named_parameters(), u.parameters()):
            assert _max_abs(p.grad, p_u.grad) <= ATOL * max(1.0, float(p_u.grad.abs().max())), name


@pytest.mark.parametrize("train,masked", [(False, False), (True, False), (True, True)])
def test_fused_net_forward_matches_jax_and_unfused(train, masked):
    """Net.forward with `fused_heads` against the JAX fused forward (same
    weights, JAX's inputs) and against the port's unfused forward: the
    latent, the reconstruction, every head and the BatchNorm statistics."""
    jcfg, cfg = configs(aux_tasks=AUX, dropout=0.0, fused_heads=True)
    assert cfg.fused_heads
    params, state = init_net(jax.random.PRNGKey(11), jcfg)
    batch = jax_batch(jcfg)
    if masked:
        batch["sample_mask"] = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32)
    inputs = jbuild_inputs(jcfg, batch, jax.random.PRNGKey(12), train, False)
    out = jax.jit(lambda p, s, x, fx, perm, m: jforward(
        p, s, jcfg, x, fx, perm, train=train, key=jax.random.PRNGKey(3), sample_mask=m))(
        params, state, inputs["x"], inputs["fake_x"], inputs["fake_perm_idx"],
        inputs["sample_mask"])
    ti = to_torch(inputs)
    nets = {fused: port_net(cfg.replace(fused_heads=fused), params, state)
            for fused in (True, False)}
    got = {}
    with torch.no_grad():
        for fused, net in nets.items():
            got[fused] = net(ti["x"], ti["fake_x"], ti["fake_perm_idx"], train=train,
                             sample_mask=ti["sample_mask"])
    for want in (out, got[False]):
        assert _max_abs(got[True].hidden, want.hidden) <= ATOL
        assert _max_abs(got[True].rec, want.rec) <= ATOL
        assert set(got[True].aux) == set(want.aux) == {"future_vital", "ICU", "fake_det"}
        for k in want.aux:
            assert _max_abs(got[True].aux[k], want.aux[k]) <= ATOL, k
    _, s_fused = jax_from_state_dict(nets[True].state_dict())
    _, s_unfused = jax_from_state_dict(nets[False].state_dict())
    for other in (out.state, s_unfused):
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(s_fused),
                                     jax.tree_util.tree_leaves_with_path(other)):
            assert _max_abs(a, b) <= ATOL, path


# ----------------------------------------------------------- 16-bit draws
def _jax_16bit_fake_draws(key, shape):
    k_sel, k_noise = jax.random.split(key)
    u16 = np.array(jax.random.bits(k_sel, shape, dtype=jnp.uint16))
    bits = (u16.astype(np.uint32) << 16).view(np.int32)
    noise = np.array(jax.random.uniform(k_noise, shape, dtype=jnp.float16))
    return torch.from_numpy(bits), torch.from_numpy(noise)


def test_make_fake_ob_and_augment_batch_16bit_match_jax():
    """Fed JAX's uint16 bits (shifted left by 16) and float16 draws, the
    port's fake sample and augmentation equal JAX's `draw_bits=16` ones."""
    jcfg, _ = configs()
    batch = jax_batch(jcfg)
    ob, mask, ts = (batch[k] for k in ("ob", "padding_mask", "timestamp"))
    key = jax.random.PRNGKey(13)
    want = np.array(jmake_fake_ob(ob, mask, key, 5.0, draw_bits=16))
    bits, noise = _jax_16bit_fake_draws(key, ob.shape)
    assert noise.dtype == torch.float16
    got = make_fake_ob(torch.from_numpy(ob), torch.from_numpy(mask), 5.0, bits, noise,
                       draw_bits_width=16)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, ob)

    normals = torch.from_numpy(np.array(jax.random.normal(key, (2,) + ob.shape,
                                                          dtype=jnp.float16)))
    want_ob, want_ts = jaugment_batch(ob, ts, mask, key, 0.1, draw_bits=16)
    got_ob, got_ts = augment_batch(torch.from_numpy(ob), torch.from_numpy(ts),
                                   torch.from_numpy(mask), 0.1, normals, draw_bits_width=16)
    np.testing.assert_array_equal(got_ob.numpy(), np.array(want_ob))
    np.testing.assert_array_equal(got_ts.numpy(), np.array(want_ts))


@pytest.mark.parametrize("t", [24, 354])
def test_select_on_16bit_keys_is_bit_identical_to_jax(t):
    """16 random bits leave many ties in the keys' random part, which the
    slot position breaks: the plain select (and the wrapper on the CPU)
    equal JAX's sort select bit for bit."""
    rng = np.random.RandomState(t)
    rows = 64
    n_valid = rng.randint(0, t + 1, size=rows).astype(np.int32)
    k = np.where(n_valid > 0, np.maximum(1, n_valid // 2), 0).astype(np.int32)
    u16 = rng.randint(0, 2**16, size=(rows, t)).astype(np.uint32)
    u16[:8] &= 0xF  # rows of heavy ties
    bits = u16 << 16
    want = np.array(_select_xla(jnp.asarray(bits), jnp.asarray(n_valid)[:, None],
                                jnp.asarray(k)[:, None]))
    args = [torch.from_numpy(a) for a in (bits.view(np.int32), n_valid, k)]
    np.testing.assert_array_equal(cs._select_sort(*args).numpy(), want)
    got = cs.fake_select_mask(*(a.reshape((8, 8) + a.shape[1:]) for a in args))
    np.testing.assert_array_equal(got.reshape(rows, t).numpy(), want)


def test_16bit_draws_from_a_generator():
    """`draw_bits(width=16)` leaves the low 16 bits 0; build_inputs under
    `rng_draw_bits=16` hands the select such bits and draws float16 noise
    and normals."""
    g = torch.Generator().manual_seed(0)
    bits = draw_bits((4096,), g, "cpu", width=16)
    assert bits.dtype == torch.int32 and not (bits & 0xFFFF).any()
    assert (bits < 0).any() and (bits > 0).any()
    _, cfg = configs(rng_draw_bits=16, aug_input=True)
    seen = {}
    select, randn = cs.fake_select_mask, torch.randn

    def spy_select(b, *a, **kw):
        seen["bits"] = b
        return select(b, *a, **kw)

    def spy_randn(*a, **kw):
        seen.setdefault("normal_dtypes", []).append(kw.get("dtype"))
        return randn(*a, **kw)

    import deep_interpolation_clustering_tpu_torch.data.loader as loader

    loader.fake_select_mask, torch.randn = spy_select, spy_randn
    try:
        build_inputs(cfg, to_torch(jax_batch(configs()[0])), torch.Generator().manual_seed(1),
                     True, False)
    finally:
        loader.fake_select_mask, torch.randn = select, randn
    assert not (seen["bits"] & 0xFFFF).any()
    assert seen["normal_dtypes"] == [torch.float16, torch.float16]


# --------------------------------------------------- one step of each option
@pytest.mark.parametrize("option", [dict(fused_heads=True), dict(rng_draw_bits=16),
                                    dict(fused_heads=True, rng_draw_bits=16, aug_input=True)],
                         ids=["fused_heads", "draw16", "both_aug"])
def test_one_train_step_matches_jax(option):
    """One update from the same weights with JAX's inputs (its 16-bit draws
    where asked): losses within 1e-5, parameters within 1e-5 outside Adam's
    eps regime and within 2*lr in it, BatchNorm statistics within 1e-5."""
    jcfg, cfg = configs(dropout=0.0, aux_tasks=AUX, **option)
    params, state = init_net(jax.random.PRNGKey(10), jcfg)
    joptimizer = jmake_optimizer(jcfg)
    jupdate = jax.jit(_make_update(jcfg, joptimizer, False))
    net = port_net(cfg, params, state)
    opt = make_optimizer(cfg, net.parameters())
    batch = jax_batch(jcfg)
    key = jax.random.PRNGKey(100)
    inputs = jbuild_inputs(jcfg, batch, jax.random.split(key)[0], True, False)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    params, state, _, jlosses = jupdate(params, state, joptimizer.init(params), batch, key)
    losses = update(net, opt, cfg, to_torch(inputs), None)
    for k in jlosses:
        assert abs(float(losses[k]) - float(jlosses[k])) <= ATOL * max(
            1.0, abs(float(jlosses[k]))), k
    want = state_dict_from_jax(params, state)
    for name, p in net.named_parameters():
        diff = (p.detach() - want[name]).abs()
        eps_regime = ((p.grad + cfg.weight_decay_rate * before[name]).abs() < 1e-6) | \
            name.endswith(".model.0.bias")
        outside = (diff > ATOL + ATOL * want[name].abs()) & ~eps_regime
        assert not outside.any(), name
        assert float(diff.max()) <= 2 * cfg.init_lr, name
    for name, v in net.state_dict().items():
        if "running" in name:
            assert _max_abs(v, want[name]) <= ATOL, name


# ------------------------------------------------------------------ viz_feat
def _tsv(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f == "tensors.tsv":
                with open(os.path.join(d, f)) as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_add_embedding_writes_what_jax_writes(tmp_path):
    feats = np.random.RandomState(0).randn(20, 16).astype(np.float32)
    for name, cls in (("jax", JSummary), ("port", Summary)):
        s = cls(str(tmp_path / name))
        s.add_embedding(feats, 3, "validation")
        s.close()
    got, want = _tsv(tmp_path / "port"), _tsv(tmp_path / "jax")
    assert list(want) == [os.path.join("00003", "validation", "tensors.tsv")]
    assert got == want


def test_eval_viz_feat_embeds_the_latents_as_jax_does(tmp_path):
    """`Trainer.eval(viz_feat=True)` of both packages from the same
    weights: a projector of the cohort's latents at the trainer's epoch."""
    jcfg = JConfig(batch_size=8, num_timestamps=24, lstm_hidden=16, head_hidden=16)
    _, cfg = configs(**{k: getattr(jcfg, k) for k in ("batch_size", "num_timestamps")})
    cohorts = process_splits(make_synthetic_cohorts(n_total=40, max_obs=24, seed=5),
                             rng=np.random.RandomState(0))
    copy = lambda d: {k: np.array(v, copy=True) for k, v in d.items()}  # noqa: E731
    jtr = JTrainer(jcfg, {"validation": JArrayDataset(jcfg, copy(cohorts["validation"]),
                                                      "validation")}, str(tmp_path / "jax"))
    tr = Trainer(cfg, {"validation": ArrayDataset(cfg, copy(cohorts["validation"]),
                                                  "validation")},
                 str(tmp_path / "port"), device="cpu")
    tr.net.load_state_dict(state_dict_from_jax(jtr.params, jtr.state), strict=True)
    jtr.epoch = tr.epoch = 2
    want = jtr.eval("validation", viz_feat=True, metric="ae_mse")
    got = tr.eval("validation", viz_feat=True, metric="ae_mse")
    jtr.close()
    tr.close()
    jfiles, files = _tsv(tmp_path / "jax" / "summary"), _tsv(tmp_path / "port" / "summary")
    assert list(files) == list(jfiles) == [os.path.join("00002", "validation", "tensors.tsv")]
    parse = lambda text: np.array([[float(v) for v in line.split("\t")]  # noqa: E731
                                   for line in text.strip().split("\n")])
    (tsv,), (jtsv,) = files.values(), jfiles.values()
    np.testing.assert_array_equal(parse(tsv), got["hidden"])
    assert _max_abs(parse(tsv), parse(jtsv)) <= ATOL
    assert _max_abs(got["hidden"], want["hidden"]) <= ATOL


@pytest.mark.parametrize("stage", [p1, p3], ids=["p1", "p3"])
def test_cli_evals_with_viz_feat(tmp_path, monkeypatch, stage):
    """`cli.p1` and `cli.p3` dump every (metric, cohort) with `viz_feat`,
    as the JAX CLIs do."""
    calls = []

    class Recorder:
        def __init__(self, *a, **kw):
            pass

        def eval(self, cohort, **kw):
            calls.append((kw["metric"], cohort, kw["generate_feat"], kw["viz_feat"]))

        def close(self):
            pass

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(stage, "make_datasets", lambda cfg: {})
    monkeypatch.setattr(stage, "Trainer" if stage is p1 else "ClusterTrainer", Recorder)
    stage.main(["--mode", "eval"], device="cpu")
    metrics = ("loss", "ae_mse") if stage is p1 else METRICS
    assert calls == [(m, c, True, True) for m in metrics for c in COHORTS]
