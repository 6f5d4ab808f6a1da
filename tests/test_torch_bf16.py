"""The port's bfloat16 `compute_dtype` vs the JAX package's, on the CPU at a
small width (B=8, T=24, H=16, head_hidden 16).

JAX's bf16 step is `_compute_cast` -> `build_inputs` -> `_forward_and_losses`
(`train/steps.py:178-218`); the port's is `cast_batch` -> `build_inputs` ->
`forward_and_losses` on `compute_params` (`train/steps.py`). Checked:
  * dtypes: every named intermediate (the input planes of the real and fake
    streams, the SCI and CCI outputs, the encoder's output and latent, the
    decoder's output, each head's logits, `rec`, the aux outputs, each loss,
    the BatchNorm state) has the JAX step's type (`jax.eval_shape`), at the
    default Config (mixed: the fake stream's `ob` is float32) and at
    `fake_detection=False, loss="ae_mse"` (all bfloat16);
  * values: one step from the same weights and the same `build_inputs`
    draws, each loss within 5e-2 relative of JAX's bf16 loss (JAX's own bar,
    tests/test_loss_modes.py:93) and of the port's float32 loss; the
    flattened gradient's cosine similarity with JAX's bf16 gradient >= 0.99
    (measured: 0.99976 at the default Config, 0.99678 at ae_mse); parameters
    and Adam state float32 after an update;
  * the kernel boundaries: the biLSTM at bfloat16 against JAX
    `bilstm_forward(use_pallas=True)` in interpret mode (atol 8e-3, gradient
    dtypes bfloat16, as tests/test_pallas_kernels.py:150 checks JAX's), the
    RBF push at bfloat16 against JAX's XLA function (atol 3e-2, that test's
    bar) and SCI against it as `test_sci_bf16_boundary_matches_jax` states,
    outputs and input gradients in the JAX dtypes;
  * the entry point: `cli.p1 --compute_dtype bfloat16` for two epochs, finite
    losses, float32 checkpoints that the JAX `Config.load` and checkpoint
    reader take.
Dropout is 0 wherever values are compared.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu import Config as JConfig
from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.models import net as jnet
from deep_interpolation_clustering_tpu.ops import interpolation as jinterp
from deep_interpolation_clustering_tpu.ops.lstm import bilstm_forward as jbilstm_forward
from deep_interpolation_clustering_tpu.ops.lstm import lstm_init
from deep_interpolation_clustering_tpu.ops.rbf import rbf_push as jrbf_push
from deep_interpolation_clustering_tpu.train.checkpoint import load_checkpoint as jload_ckpt
from deep_interpolation_clustering_tpu.train.steps import _compute_cast, _forward_and_losses
from deep_interpolation_clustering_tpu.train.steps import build_inputs as jbuild_inputs
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.cli import p0, p1
from deep_interpolation_clustering_tpu_torch.compat import state_dict_from_jax
from deep_interpolation_clustering_tpu_torch.models import net as tnet
from deep_interpolation_clustering_tpu_torch.ops import cuda_interp
from deep_interpolation_clustering_tpu_torch.ops.interpolation import Planes
from deep_interpolation_clustering_tpu_torch.ops.lstm import bilstm_forward
from deep_interpolation_clustering_tpu_torch.ops.nn import Head
from deep_interpolation_clustering_tpu_torch.train import make_optimizer, update
from deep_interpolation_clustering_tpu_torch.train.steps import (
    build_inputs,
    cast_batch,
    compute_params,
    forward_and_losses,
)
from test_torch_interp import _planes, _sci_float64
from test_torch_lstm import _port_weights
from test_torch_model import AUX, configs, jax_batch, port_net

torch.set_num_threads(1)

BF16 = dict(compute_dtype="bfloat16")
VARIANTS = {"default": {}, "ae_mse": dict(fake_detection=False, loss="ae_mse")}
R, HOURS = 6, 6.0


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_torch(tree):
    """JAX arrays (bfloat16 included) -> torch tensors of the same dtype."""
    if tree is None:
        return None
    if isinstance(tree, tuple):  # JAX `Planes`
        return Planes(*(_to_torch(a) for a in tree))
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a.copy())


def _planes_dtypes(inputs):
    out = {}
    for stream in ("x", "fake_x"):
        if inputs[stream] is not None:
            for field, a in zip(("ob", "mask", "ts", "ae"), inputs[stream]):
                out[f"{stream}.{field}"] = _name(a.dtype)
    return out


class _Recorder:
    """Records the dtype of each named intermediate of one forward."""

    def __init__(self):
        self.seen = {}
        self.lstm = 0
        self.heads = 0

    def put(self, name, a):
        self.seen[name] = _name(a.dtype)

    def sci(self, reps):
        for i, rep in enumerate(reps):
            self.put(f"sci[{i}]", rep)
        return reps

    def lstm_out(self, out):
        name = ("encoder", "decoder")[min(self.lstm, 1)]
        self.lstm += 1
        for field, a in zip(("out", "h", "c"), out):
            self.put(f"{name}.{field}", a)
        return out

    def head(self, y):
        self.put(f"head[{self.heads}]", y)
        self.heads += 1
        return y


def _net_dtypes(rec, out, losses, state_dtypes):
    d = dict(rec.seen)
    d["hidden"] = _name(out.hidden.dtype)
    d["rec"] = _name(out.rec.dtype)
    for k, v in out.aux.items():
        d[f"aux.{k}"] = _name(v.dtype)
    for k, v in losses.items():
        d[f"loss.{k}"] = _name(v.dtype)
    d["bn_state"] = sorted(set(state_dtypes))
    return d


def _jax_dtypes(jcfg, params, state, batch, monkeypatch):
    rec = _Recorder()
    sci_streams, cci, lstm, head = (jnet._sci_streams, jnet.cci_forward,
                                    jnet.bilstm_forward, jnet.nn.head_apply)
    monkeypatch.setattr(jnet, "_sci_streams", lambda *a, **k: rec.sci(sci_streams(*a, **k)))
    monkeypatch.setattr(jnet, "cci_forward", lambda *a, **k: (
        lambda y: (rec.put("cci", y), y)[1])(cci(*a, **k)))
    monkeypatch.setattr(jnet, "bilstm_forward", lambda *a, **k: rec.lstm_out(lstm(*a, **k)))
    monkeypatch.setattr(jnet.nn, "head_apply", lambda *a, **k: (
        lambda ys: (rec.head(ys[0]), ys)[1])(head(*a, **k)))
    # one stream: `_encode` takes SCI itself, not through `_sci_streams`
    monkeypatch.setattr(jnet, "_encode", lambda params, cfg, x: jnet._encode_rep(
        params, cfg, rec.sci([jnet._sci(params, cfg, x)])[0]))
    seen = {}

    def step(params, state, batch, key):
        params, batch = _compute_cast(jcfg, params, batch)
        k_in, k_drop = jax.random.split(key)
        inputs = jbuild_inputs(jcfg, batch, k_in, train=True, denoise=False)
        seen.update(_planes_dtypes(inputs))
        return _forward_and_losses(params, state, jcfg, inputs, True, k_drop)

    out, losses = jax.eval_shape(step, params, state, batch, jax.random.PRNGKey(3))
    state_dtypes = [_name(a.dtype) for a in jax.tree_util.tree_leaves(out.state)]
    d = _net_dtypes(rec, out, losses, state_dtypes)
    d.update(seen)
    return d


def _port_dtypes(cfg, net, batch, monkeypatch):
    rec = _Recorder()
    sci_streams, cci, lstm, head_fwd = (tnet.Net._sci_streams, tnet.cci_forward,
                                        tnet.bilstm_forward, Head.forward)
    monkeypatch.setattr(tnet.Net, "_sci_streams",
                        lambda self, *a, **k: rec.sci(sci_streams(self, *a, **k)))
    monkeypatch.setattr(tnet, "cci_forward", lambda *a, **k: (
        lambda y: (rec.put("cci", y), y)[1])(cci(*a, **k)))
    monkeypatch.setattr(tnet, "bilstm_forward", lambda *a, **k: rec.lstm_out(lstm(*a, **k)))
    monkeypatch.setattr(Head, "forward", lambda self, *a, **k: rec.head(head_fwd(self, *a, **k)))
    gen = torch.Generator().manual_seed(0)
    inputs = build_inputs(cfg, cast_batch(cfg, batch), gen, True, False)
    out, losses = forward_and_losses(net, cfg, inputs, True, gen,
                                     params=compute_params(net, cfg))
    state_dtypes = [_name(b.dtype) for n, b in net.named_buffers() if "running" in n]
    d = _net_dtypes(rec, out, losses, state_dtypes)
    d.update(_planes_dtypes(inputs))
    return d


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_intermediates_have_jax_dtypes(variant, monkeypatch):
    jcfg, cfg = configs(aux_tasks=AUX, **BF16, **VARIANTS[variant])
    params, state = init_net(jax.random.PRNGKey(1), jcfg)
    batch = jax_batch(jcfg)
    with monkeypatch.context() as m:
        want = _jax_dtypes(jcfg, params, state, batch, m)
    got = _port_dtypes(cfg, port_net(cfg, params, state),
                       {k: torch.from_numpy(v) for k, v in batch.items()}, monkeypatch)
    assert got == want
    # the JAX step's types at the Net's outputs, named outright
    f32, bf16 = "float32", "bfloat16"
    assert want["bn_state"] == [f32]
    if variant == "default":
        assert (want["fake_x.ob"], want["fake_x.mask"], want["x.ob"]) == (f32, bf16, bf16)
        assert {want[k] for k in ("hidden", "rec", "aux.future_vital", "aux.fake_det",
                                  "encoder.out", "decoder.out")} == {f32}
    else:
        assert {want[k] for k in ("hidden", "rec", "aux.future_vital", "loss.loss",
                                  "loss.ae_mse")} == {bf16}


def _jax_grads_and_losses(jcfg, params, state, batch, key):
    """The JAX bf16 step's gradient and float32 losses, as `_make_update`'s
    `loss_fn` computes them, and the `build_inputs` draws it took."""
    k_in, k_drop = jax.random.split(key)

    def loss_fn(params):
        p, b = _compute_cast(jcfg, params, batch)
        inputs = jbuild_inputs(jcfg, b, k_in, train=True, denoise=False)
        _, losses = _forward_and_losses(p, state, jcfg, inputs, True, k_drop)
        losses = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), losses)
        return losses["loss"], losses

    grads, losses = jax.grad(loss_fn, has_aux=True)(params)
    _, b = _compute_cast(jcfg, params, batch)
    inputs = jbuild_inputs(jcfg, b, k_in, train=True, denoise=False)
    return grads, {k: float(v) for k, v in losses.items()}, inputs


def _port_grads_and_losses(cfg, net, inputs):
    net.zero_grad(set_to_none=True)
    _, losses = forward_and_losses(net, cfg, inputs, True, None,
                                   params=compute_params(net, cfg))
    losses = {k: v.to(torch.float32) for k, v in losses.items()}
    losses["loss"].backward()
    # a head the loss does not reach has no gradient: JAX's is zeros
    return ({n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in net.named_parameters()},
            {k: float(v.detach()) for k, v in losses.items()})


def _flat(grads, names):
    return torch.cat([grads[n].reshape(-1).to(torch.float64) for n in names])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_values_match_jax_bf16(variant):
    """One step's losses and gradient against JAX's bf16 step and the port's
    float32 step, from the same weights and draws."""
    jcfg, cfg = configs(aux_tasks=AUX, dropout=0.0, **BF16, **VARIANTS[variant])
    params, state = init_net(jax.random.PRNGKey(1), jcfg)
    batch = jax_batch(jcfg)
    jgrads, jlosses, inputs = _jax_grads_and_losses(jcfg, params, state, batch,
                                                    jax.random.PRNGKey(5))
    net = port_net(cfg, params, state)
    grads, losses = _port_grads_and_losses(cfg, net, _to_torch(inputs))
    assert all(g.dtype == torch.float32 for g in grads.values())
    # the float32 step on the same draws (the inputs' float planes upcast)
    f32_inputs = _to_torch(inputs)
    f32_inputs = {k: (Planes(*(a.float() for a in v)) if isinstance(v, tuple) else
                      v.float() if isinstance(v, torch.Tensor) and v.is_floating_point()
                      else {kk: vv.float() for kk, vv in v.items()} if isinstance(v, dict)
                      else v) for k, v in f32_inputs.items()}
    cfg32 = cfg.replace(compute_dtype="float32")
    _, losses32 = _port_grads_and_losses(cfg32, port_net(cfg32, params, state), f32_inputs)
    assert set(losses) == set(jlosses)
    for k in jlosses:
        assert abs(losses[k] - jlosses[k]) <= 5e-2 * abs(jlosses[k]), (k, losses[k], jlosses[k])
        assert abs(losses[k] - losses32[k]) <= 5e-2 * abs(losses32[k]), (k, losses[k],
                                                                          losses32[k])
    want = {n: v for n, v in state_dict_from_jax(jgrads, state).items() if n in grads}
    names = sorted(grads)
    a, b = _flat(grads, names), _flat(want, names)
    cosine = float(torch.dot(a, b) / (a.norm() * b.norm()))
    assert cosine >= 0.99, cosine


def test_update_keeps_float32_params_and_adam_state():
    jcfg, cfg = configs(aux_tasks=AUX, **BF16)
    params, state = init_net(jax.random.PRNGKey(1), jcfg)
    net = port_net(cfg, params, state)
    opt = make_optimizer(cfg, net.parameters())
    _, _, inputs = _jax_grads_and_losses(jcfg, params, state, jax_batch(jcfg),
                                         jax.random.PRNGKey(5))
    losses = update(net, opt, cfg, _to_torch(inputs), torch.Generator().manual_seed(0))
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in losses.values())
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    assert {b.dtype for n, b in net.named_buffers() if "running" in n} == {torch.float32}
    for p in net.parameters():
        assert {v.dtype for v in opt.state[p].values() if v.is_floating_point()
                and v.dim()} == {torch.float32}


def test_config_takes_bfloat16_and_names_both_choices():
    assert Config(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="float32.*bfloat16"):
        Config(compute_dtype="float16")


# ------------------------------------------------------- kernel boundaries
def test_bilstm_bf16_boundary_matches_jax_pallas():
    """As tests/test_pallas_kernels.py:150: bfloat16 parameters and input;
    the outputs keep the input's type, the gradients the parameters'."""
    t_len, b, feat, hidden = 6, 9, 18, 128
    params = lstm_init(jax.random.PRNGKey(1), feat, hidden)
    bf16 = jnp.bfloat16
    params16 = jax.tree.map(lambda a: a.astype(bf16), params)
    x16 = jax.random.normal(jax.random.PRNGKey(2), (t_len, b, feat), bf16)
    want = jbilstm_forward(params16, x16, use_pallas=True)

    def jloss(p):
        o, _, _ = jbilstm_forward(p, x16, use_pallas=True)
        return jnp.sum(o.astype(jnp.float32))

    jgrads = jax.grad(jloss)(params16)
    assert {a.dtype for a in jax.tree.leaves(jgrads)} == {jnp.dtype(bf16)}

    w = _port_weights(params, feat, hidden).to(torch.bfloat16)
    x = _to_torch(x16)
    got = bilstm_forward(w, x)
    for g, wt in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(wt, np.float32),
                                   atol=8e-3)
    got[0].float().sum().backward()
    for p in w.parameters():
        assert p.grad.dtype == torch.bfloat16
        assert torch.isfinite(p.grad.float()).all()


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _bf16_ulp(a):
    """One bfloat16 ulp at each value (8 significant bits)."""
    a = np.abs(np.asarray(a, np.float64))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("fake", [False, True], ids=["bf16_ob", "f32_ob"])
def test_sci_bf16_boundary_matches_jax(fake):
    """`cuda_interp.sci` on bfloat16 planes (and, as the fake stream gives
    it, a float32 `ob` beside them): the JAX output type, input gradients in
    each input's type. Values: JAX's XLA `sci_forward` at bfloat16 carries
    its own rounding (measured against a float64 evaluation on these inputs:
    0.076, 0.27 and 0.14 max abs on the smooth, intensity and transient
    blocks), more than the 3e-2 bar, so the port is held (a) to JAX's XLA
    function on the same values upcast to float32 and the result cast back,
    as JAX's own boundary (`ops/lstm.py:84-99`) computes a bfloat16 call:
    atol 3e-2 plus one bfloat16 ulp of the output (two roundings of float32
    values ~1e-5 apart may land an ulp apart; at the intensity block's
    |w| ~ 40 an ulp is 0.25), and (b) against the float64 evaluation: on
    each block no farther than JAX's bfloat16 computation is."""
    rng = np.random.RandomState(3)
    ob, mask, ts = _planes(rng, t=24)
    kernel = rng.rand(ob.shape[1]).astype(np.float32)
    ob_t = torch.from_numpy(ob) if fake else _bf16(ob)
    k_t, m_t, t_t = _bf16(kernel), _bf16(mask), _bf16(ts)
    ob_t.requires_grad_(True)
    k_t.requires_grad_(True)
    got = cuda_interp.sci(k_t, ob_t, m_t, t_t, R, HOURS)
    vals = [a.detach().float().numpy() for a in (k_t, ob_t, m_t, t_t)]  # as given

    def jax_sci(dtypes):
        k, o, m, t = (jnp.asarray(v, d) for v, d in zip(vals, dtypes))
        return jinterp.sci_forward(k, jinterp.Planes(o, m, t, m), R, HOURS)

    given = [jnp.float32 if a.dtype == torch.float32 else jnp.bfloat16
             for a in (k_t, ob_t, m_t, t_t)]
    want16 = jax_sci(given)
    assert _name(got.dtype) == str(want16.dtype)
    out = got.detach().float().numpy()
    want = np.asarray(jax_sci([jnp.float32] * 4).astype(want16.dtype), np.float32)
    assert np.all(np.abs(out - want) <= 3e-2 + _bf16_ulp(want))
    ref = _sci_float64(vals[1], vals[2], vals[3], vals[0])
    c = ob.shape[1]
    for blk in range(3):
        cols = slice(blk * c, (blk + 1) * c)
        port_err = np.abs(out[..., cols] - ref[..., cols]).max()
        jax_err = np.abs(np.asarray(want16, np.float64)[..., cols] - ref[..., cols]).max()
        assert port_err <= jax_err, (blk, port_err, jax_err)
    got.float().sum().backward()
    assert ob_t.grad.dtype == ob_t.dtype and k_t.grad.dtype == torch.bfloat16


def test_rbf_push_bf16_boundary_matches_jax():
    rng = np.random.RandomState(4)
    _, mask, ts = _planes(rng, t=24)
    b, c, _ = mask.shape
    proj = rng.randn(b, c, R).astype(np.float32)
    kernel = rng.rand(c).astype(np.float32)
    b16 = jnp.bfloat16
    want = jrbf_push(jnp.asarray(kernel, b16), jnp.asarray(proj, b16),
                     jinterp.Planes(jnp.asarray(mask, b16), jnp.asarray(mask, b16),
                                    jnp.asarray(ts, b16), jnp.asarray(mask, b16)),
                     R, HOURS, "gaussian", use_pallas=False)
    k_t, p_t = _bf16(kernel).requires_grad_(True), _bf16(proj).requires_grad_(True)
    got = cuda_interp.rbf_push(k_t, p_t, _bf16(mask), _bf16(ts), R, HOURS)
    assert got.dtype == torch.bfloat16 and want.dtype == b16
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32),
                               atol=3e-2)
    got.float().sum().backward()
    assert k_t.grad.dtype == torch.bfloat16 and p_t.grad.dtype == torch.bfloat16


# ------------------------------------------------------------ entry point
W = ["--batch_size", "8", "--num_timestamps", "24", "--lstm_hidden", "16",
     "--head_hidden", "16", "--max_epochs", "3"]


def test_p1_bf16_two_epochs_writes_float32_checkpoints(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    p0.main(["--synthetic", "60", "--synthetic_max_obs", "24", "--num_timestamps", "24"])
    p1.main(W + ["--compute_dtype", "bfloat16"], device="cpu")
    exp = os.path.join("Results", "Pretrain")
    rows = [r for r in _summary_rows(exp) if r["scope"] in ("train", "valid")]
    assert len(rows) == 4
    assert all(np.isfinite(v) for r in rows for k, v in r.items()
               if isinstance(v, float))
    jcfg = JConfig.load(os.path.join(exp, "config.json"))
    assert jcfg.compute_dtype == "bfloat16"
    for metric in ("loss", "ae_mse"):
        _, params, state, _, _ = jload_ckpt(os.path.join(exp, "weight", metric,
                                                         "checkpoint.npz"))
        leaves = jax.tree_util.tree_leaves((params, state))
        assert leaves and {np.asarray(a).dtype for a in leaves} == {np.dtype(np.float32)}


def _summary_rows(exp):
    import json
    with open(os.path.join(exp, "summary", "events.jsonl")) as f:
        return [json.loads(line) for line in f]
