"""The port's data-parallel path on the CPU: two gloo ranks against one
process, and against the JAX package's step on a 2-device mesh.

Two spawns of two ranks each (`parallel.spawn`, each with a timeout):
  * `ops`: the collectives, global BatchNorm and the fused heads (moments,
    running statistics, dropout drawn at the global shape, gradients), the
    masked losses, `target_distribution` and the permuted gather with its
    gradient, each at 2 ranks against 1; and one train step at 2 ranks,
    unmasked and with a masked tail whose second share is all padding,
    against the port's 1-rank step (invariant 1) and the JAX step on
    `make_mesh(2)` fed the same `build_inputs` draws (invariant 4);
  * `trainers`: two `Trainer` epochs (dropout and augmentation on, a
    ragged tail that leaves rank 1's share all padding) and an eval pass
    against one process (invariant 1), the ranks bit-identical (invariant
    3), rank 1 writing nothing; then `ClusterTrainer.init_centers` and one
    DEC epoch (KL and triplet terms) at 2 ranks against one process; then
    two epochs under `compute_dtype="bfloat16"`, each validated and
    checkpointed: finite losses, float32 checkpoints that the JAX `Config.load`
    and checkpoint reader take.

Tolerances (invariant 1, the JAX package's sharded-vs-single band,
tests/test_trainer.py and tests/test_multihost.py): losses within 1e-5,
parameters at most 5e-3 apart with no more than 0.1% of elements beyond
1e-4, BatchNorm running statistics within rtol 1e-5, validation ae_mse
within 5e-4, latents within 1e-4, rec_ob within rtol 3e-4 / atol 1e-4.
After several steps a running mean also carries the drift of the fc1 bias
in front of it (`_running_band`). The op-level checks hold 2 ranks to 1
within 1e-6, relative and absolute (float32 summation order); gathers,
broadcasts and masks are exact. Against JAX the step is held to
tests/test_torch_step.py's tolerances.
"""

import os

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu_torch import Config, parallel
from deep_interpolation_clustering_tpu_torch.data import (
    ArrayDataset,
    make_synthetic_cohorts,
    process_splits,
)
from deep_interpolation_clustering_tpu_torch.models import Net
from deep_interpolation_clustering_tpu_torch.models import losses as L
from deep_interpolation_clustering_tpu_torch.ops.dec import target_distribution
from deep_interpolation_clustering_tpu_torch.ops.interpolation import Planes
from deep_interpolation_clustering_tpu_torch.ops.nn import BatchNorm, Head, heads_apply_fused
from deep_interpolation_clustering_tpu_torch.train import ClusterTrainer, Trainer
from deep_interpolation_clustering_tpu_torch.train import make_optimizer, update

torch.set_num_threads(1)

D = 2
B, T, H = 16, 16, 16
SPAWN_TIMEOUT_S = 240
AUX = {"future_vital": 0.5, "ICU": 1.0}


def _world(r, address):
    parallel.initialize(address, D, r, "cpu", "gloo", timeout_s=SPAWN_TIMEOUT_S)


def _np(t):
    return t.detach().numpy().copy()


def _tree(x, fn):
    if x is None:
        return None
    if isinstance(x, Planes):
        return Planes(*(fn(a) for a in x))
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def _shard_inputs(inputs, r, d):
    """Rank r's share of global `build_inputs` outputs: its rows of every
    plane, its block of the permuted 2B labels and masks, the whole perm."""
    def rows(a):
        k = a.shape[0] // d
        return a[r * k:(r + 1) * k]
    return {k: (v if k == "fake_perm_idx" or v is None else _tree(v, rows))
            for k, v in inputs.items()}


def _state(net, opt):
    sd = {k: _np(v) for k, v in net.state_dict().items()}
    moments = {f"{n}.{k}": _np(v) for n, p in net.named_parameters()
               for k, v in opt.state[p].items()}
    grads = {n: _np(p.grad) for n, p in net.named_parameters()}
    return sd, moments, grads


# ---------------------------------------------------------------- ops rank
def _ops_rank(r, address, case):
    _world(r, address)
    try:
        out = {}
        rows = parallel.shard_rows(B)
        x = torch.as_tensor(case["x"])
        out["all_sum"] = _np(parallel.all_sum(torch.full((3,), float(r + 1))))
        out["gather"] = _np(parallel.gather_rows(x[rows]))
        out["fetch"] = parallel.device_fetch({"x": [x[rows]], "n": 3})
        out["blocks"] = _np(parallel.gather_blocks(torch.as_tensor(case["blocks"][r]), 3))
        t = torch.full((4,), float(r))
        parallel.broadcast_([t])
        out["broadcast"] = _np(t)
        out["replicated"] = parallel.replicated([("same", torch.ones(3)),
                                                 ("rank", torch.full((2,), float(r)))])
        # global BatchNorm, masked and not, forward, running stats, gradients
        for masked in (False, True):
            bn = BatchNorm(x.shape[1])
            xl = x[rows].clone().requires_grad_(True)
            mask = torch.as_tensor(case["mask"])[rows] if masked else None
            y = bn(xl, True, mask)
            (y * torch.as_tensor(case["w"])[rows]).sum().backward()
            parallel.all_sum_grads_(bn.parameters())
            out[f"bn{masked}"] = dict(y=_np(y), dx=_np(xl.grad), dw=_np(bn.weight.grad),
                                      db=_np(bn.bias.grad), mean=_np(bn.running_mean),
                                      var=_np(bn.running_var))
        # two heads, one masked, fused and plain, with dropout
        for fused in (False, True):
            gen = torch.Generator().manual_seed(5)
            heads = [Head(x.shape[1], 6, 3, relu=True), Head(x.shape[1], 6, 2)]
            for h in heads:
                h.reset_parameters(torch.Generator().manual_seed(9))
            z = torch.as_tensor(case["z"])
            triples = [(heads[0], x[rows], None),
                       (heads[1], z[parallel.shard_rows(z.shape[0])],
                        torch.as_tensor(case["zmask"])[parallel.shard_rows(z.shape[0])])]
            if fused:
                ys = heads_apply_fused(triples, 0.3, True, gen)
            else:
                ys = [h(xh, 0.3, True, gen, m) for h, xh, m in triples]
            out[f"heads{fused}"] = dict(
                ys=[_np(y) for y in ys],
                stats=[(_np(h.model[1].running_mean), _np(h.model[1].running_var))
                       for h in heads])
        # the masked losses: each rank's share, summed
        sm = torch.as_tensor(case["mask"])[rows]
        ob = torch.as_tensor(case["ob"])[rows]
        rec = torch.as_tensor(case["rec"])[rows].requires_grad_(True)
        pm = torch.as_tensor(case["pm"])[rows]
        shares = {
            "rec": L.rec_loss(ob, rec, pm, sm)["ae_mse"],
            "rec_nomask": L.rec_loss(ob, rec, pm)["ae_mse"],
            "bce": L.bce_with_logits(x[rows, 0], (x[rows, 1] > 0).float(), 2.0, sm),
            "bce_nomask": L.bce_with_logits(x[rows, 0], (x[rows, 1] > 0).float(), 2.0),
            "kl": L.kl_loss(torch.softmax(x[rows, :3], 1), torch.softmax(x[rows, 3:6], 1),
                            sm)["kl"],
            "kl_nomask": L.kl_loss(torch.softmax(x[rows, :3], 1),
                                   torch.softmax(x[rows, 3:6], 1))["kl"],
            "triplet": L.triplet_loss(x[rows, :4], x[rows, 4:8], z[rows, :4], 0.5,
                                      sm)["triplet"],
        }
        shares["rec"].backward()
        out["rec_grad"] = _np(rec.grad)
        out["losses"] = {k: float(parallel.all_sum(v.detach())) for k, v in shares.items()}
        q = torch.softmax(x[rows, :4], 1)
        out["target"] = _np(target_distribution(q, sm))
        # the permuted gather and its gradient
        a = x[rows].clone().requires_grad_(True)
        b = z[rows].clone().requires_grad_(True)
        perm = torch.as_tensor(case["perm"])
        share = parallel.permuted_share(a, b, perm)
        (share * torch.as_tensor(case["pw"])[parallel.shard_rows(2 * B)]).sum().backward()
        out["perm"] = dict(share=_np(share), da=_np(a.grad), db=_np(b.grad))
        # one train step from the given weights on the given inputs
        cfg = case["cfg"]
        steps = {}
        for tag, inputs in case["steps"].items():
            net = Net(cfg)
            net.load_state_dict({k: torch.as_tensor(v) for k, v in case["sd"].items()})
            opt = make_optimizer(cfg, net.parameters())
            mine = _tree(_shard_inputs(inputs, r, D), torch.as_tensor)
            losses = update(net, opt, cfg, mine, None)
            steps[tag] = ({k: float(v) for k, v in losses.items()},) + _state(net, opt)
        out["steps"] = steps
        return out
    finally:
        parallel.shutdown()


def _jax_step_case():
    """Weights, JAX's global `build_inputs` draws (unmasked, and a masked
    tail of 5 real rows) and JAX's step on `make_mesh(2)` for the tail."""
    import jax
    from test_torch_model import configs, jax_batch, port_net, to_torch

    from deep_interpolation_clustering_tpu.models import init_net
    from deep_interpolation_clustering_tpu.parallel import make_mesh, replicate_tree, shard_batch
    from deep_interpolation_clustering_tpu.train.optim import make_optimizer as jmake_optimizer
    from deep_interpolation_clustering_tpu.train.steps import _make_update
    from deep_interpolation_clustering_tpu.train.steps import build_inputs as jbuild_inputs

    jcfg, cfg = configs(batch_size=B, num_timestamps=T, lstm_hidden=H, head_hidden=H,
                        dropout=0.0, aux_tasks=AUX)
    params, state = init_net(jax.random.PRNGKey(30), jcfg)
    joptimizer = jmake_optimizer(jcfg)
    opt_state = joptimizer.init(params)
    mesh = make_mesh(D)
    jupdate = jax.jit(_make_update(jcfg, joptimizer, False))
    full = jax_batch(jcfg, n=B)
    tail = np.resize(np.array([6, 2, 5, 0, 3]), B)
    masked = {k: v[tail] for k, v in full.items()}
    masked["sample_mask"] = (np.arange(B) < 5).astype(np.float32)
    steps = {}
    for tag, batch in (("full", full), ("tail", masked)):
        key = jax.random.PRNGKey(31)
        inputs = jbuild_inputs(jcfg, batch, jax.random.split(key)[0], True, False)
        steps[tag] = _tree(to_torch(inputs), lambda t: t.numpy())
    jax_out = jupdate(*(replicate_tree(mesh, t) for t in (params, state, opt_state)),
                      shard_batch(mesh, batch), key)
    sd = {k: v.numpy() for k, v in port_net(cfg, params, state).state_dict().items()}
    return cfg, sd, steps, jax_out


@pytest.fixture(scope="module")
def ops_run():
    rng = np.random.RandomState(0)
    cfg, sd, steps, jax_out = _jax_step_case()
    mask = np.zeros(B, np.float32)
    mask[:5] = 1.0  # rank 1's share is all padding
    case = dict(
        x=rng.randn(B, 8).astype(np.float32),
        z=rng.randn(B, 8).astype(np.float32),
        zmask=(rng.rand(B) < 0.6).astype(np.float32),
        w=rng.randn(B, 8).astype(np.float32),
        mask=mask,
        blocks=[rng.randn(6, 2).astype(np.float32) for _ in range(D)],
        ob=rng.randn(B, 3, T).astype(np.float32),
        rec=rng.randn(B, 3, T).astype(np.float32),
        pm=(rng.rand(B, 3, T) < 0.5).astype(np.float32),
        perm=rng.permutation(2 * B),
        pw=rng.randn(2 * B, 8).astype(np.float32),
        cfg=cfg, sd=sd, steps=steps,
    )
    address = f"127.0.0.1:{parallel.free_port()}"
    ranks = parallel.spawn(_ops_rank, D, (address, case), timeout_s=SPAWN_TIMEOUT_S)
    return dict(case=case, ranks=ranks, jax=jax_out)


def _cat(ranks, fn):
    return np.concatenate([fn(o) for o in ranks])


def test_collectives_exact(ops_run):
    case, ranks = ops_run["case"], ops_run["ranks"]
    for o in ranks:
        np.testing.assert_array_equal(o["all_sum"], np.full(3, 3.0))
        np.testing.assert_array_equal(o["gather"], case["x"])  # x + 0 = x
        np.testing.assert_array_equal(o["fetch"]["x"][0], case["x"])
        assert o["fetch"]["n"] == 3
        np.testing.assert_array_equal(o["broadcast"], np.zeros(4))
        assert o["replicated"] == ["rank"]
        want = np.concatenate([blk.reshape(3, 2, 2)[i] for i in range(3)
                               for blk in case["blocks"]])
        np.testing.assert_array_equal(o["blocks"], want)


@pytest.mark.parametrize("masked", [False, True], ids=["all_rows", "row_mask"])
def test_global_batchnorm(ops_run, masked):
    """Moments over both ranks' rows: outputs, input and affine gradients
    and running statistics equal the one-process BatchNorm's."""
    case, ranks = ops_run["case"], ops_run["ranks"]
    bn = BatchNorm(8)
    x = torch.as_tensor(case["x"]).requires_grad_(True)
    y = bn(x, True, torch.as_tensor(case["mask"]) if masked else None)
    (y * torch.as_tensor(case["w"])).sum().backward()
    got = [o[f"bn{masked}"] for o in ranks]
    np.testing.assert_allclose(_cat(got, lambda g: g["y"]), _np(y), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_cat(got, lambda g: g["dx"]), _np(x.grad), rtol=1e-6,
                               atol=1e-6)
    for g in got:
        np.testing.assert_allclose(g["dw"], _np(bn.weight.grad), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["db"], _np(bn.bias.grad), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["mean"], _np(bn.running_mean), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(g["var"], _np(bn.running_var), rtol=1e-5)
    for k in ("mean", "var"):  # the ranks' statistics are the same bits
        np.testing.assert_array_equal(got[0][k], got[1][k])


@pytest.mark.parametrize("fused", [False, True], ids=["heads", "fused_heads"])
def test_heads_dropout_at_global_shape(ops_run, fused):
    """Dropout drawn at the global shape and sliced: the ranks' rows of the
    heads' outputs are the one-process outputs (same masks), and so are the
    running statistics."""
    case, ranks = ops_run["case"], ops_run["ranks"]
    gen = torch.Generator().manual_seed(5)
    heads = [Head(8, 6, 3, relu=True), Head(8, 6, 2)]
    for h in heads:
        h.reset_parameters(torch.Generator().manual_seed(9))
    x, z = torch.as_tensor(case["x"]), torch.as_tensor(case["z"])
    triples = [(heads[0], x, None), (heads[1], z, torch.as_tensor(case["zmask"]))]
    if fused:
        ys = heads_apply_fused(triples, 0.3, True, gen)
    else:
        ys = [h(xh, 0.3, True, gen, m) for h, xh, m in triples]
    for i, y in enumerate(ys):
        got = _cat(ranks, lambda o: o[f"heads{fused}"]["ys"][i])
        assert np.array_equal(got == 0, _np(y) == 0)  # the same dropped elements
        np.testing.assert_allclose(got, _np(y), rtol=1e-6, atol=1e-6)
    for o in ranks:
        for (mean, var), h in zip(o[f"heads{fused}"]["stats"], heads):
            np.testing.assert_allclose(mean, _np(h.model[1].running_mean), rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(var, _np(h.model[1].running_var), rtol=1e-5)


def test_masked_losses_sum_to_the_global_loss(ops_run):
    """Each rank's share (its sum over the global count) sums to the one
    process loss, a padding-only share included; so does the gradient."""
    case, ranks = ops_run["case"], ops_run["ranks"]
    x, z = torch.as_tensor(case["x"]), torch.as_tensor(case["z"])
    sm = torch.as_tensor(case["mask"])
    ob, pm = torch.as_tensor(case["ob"]), torch.as_tensor(case["pm"])
    rec = torch.as_tensor(case["rec"]).requires_grad_(True)
    want = {
        "rec": L.rec_loss(ob, rec, pm, sm)["ae_mse"],
        "rec_nomask": L.rec_loss(ob, rec, pm)["ae_mse"],
        "bce": L.bce_with_logits(x[:, 0], (x[:, 1] > 0).float(), 2.0, sm),
        "bce_nomask": L.bce_with_logits(x[:, 0], (x[:, 1] > 0).float(), 2.0),
        "kl": L.kl_loss(torch.softmax(x[:, :3], 1), torch.softmax(x[:, 3:6], 1), sm)["kl"],
        "kl_nomask": L.kl_loss(torch.softmax(x[:, :3], 1), torch.softmax(x[:, 3:6], 1))["kl"],
        "triplet": L.triplet_loss(x[:, :4], x[:, 4:8], z[:, :4], 0.5, sm)["triplet"],
    }
    want["rec"].backward()
    for o in ranks:
        for k, v in want.items():
            v = float(v.detach())
            assert abs(o["losses"][k] - v) <= 1e-6 * max(1.0, abs(v)), k
    np.testing.assert_allclose(_cat(ranks, lambda o: o["rec_grad"]), _np(rec.grad), atol=1e-8)


def test_target_distribution_over_the_global_batch(ops_run):
    case, ranks = ops_run["case"], ops_run["ranks"]
    q = torch.softmax(torch.as_tensor(case["x"])[:, :4], 1)
    want = target_distribution(q, torch.as_tensor(case["mask"]))
    np.testing.assert_allclose(_cat(ranks, lambda o: o["target"]), _np(want), rtol=1e-6,
                               atol=1e-6)


def test_permuted_share_and_its_gradient(ops_run):
    """The fake-detection gather: each rank's block of cat(A, B)[perm], and
    gradients neither dropped nor counted twice across the gather."""
    case, ranks = ops_run["case"], ops_run["ranks"]
    a = torch.as_tensor(case["x"]).requires_grad_(True)
    b = torch.as_tensor(case["z"]).requires_grad_(True)
    rows = torch.cat([a, b])[torch.as_tensor(case["perm"])]
    (rows * torch.as_tensor(case["pw"])).sum().backward()
    np.testing.assert_array_equal(_cat(ranks, lambda o: o["perm"]["share"]), _np(rows))
    np.testing.assert_allclose(_cat(ranks, lambda o: o["perm"]["da"]), _np(a.grad), atol=1e-7)
    np.testing.assert_allclose(_cat(ranks, lambda o: o["perm"]["db"]), _np(b.grad), atol=1e-7)


def _params_band(got, want, tag):
    """Invariant 1's parameter band: at most 5e-3 apart, no more than 0.1%
    of the elements beyond 1e-4."""
    n_viol = n_tot = 0
    for k, w in want.items():
        diff = np.abs(got[k] - w)
        assert diff.max() < 5e-3, f"{tag} {k}: {diff.max():.2e}"
        n_viol += int((diff > 1e-4).sum())
        n_tot += diff.size
    assert n_viol <= max(1, n_tot // 1000), f"{tag}: {n_viol}/{n_tot} beyond 1e-4"


def _running_band(got, want):
    """Running statistics after several steps: the variances within rtol
    1e-5; each mean within rtol 1e-5 plus the largest difference of the fc1
    bias in front of it, which the mean carries (that bias has no gradient
    through a train-mode BatchNorm, and Adam moves it on float32 noise:
    tests/test_torch_step.py corrects its running-mean check the same way)."""
    for k, v in _running(want).items():
        atol = 0.0
        if k.endswith("running_mean"):
            bias = k.replace("1.running_mean", "0.bias")
            atol = float(np.abs(got[bias] - want[bias]).max())
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=atol, err_msg=k)


def _running(sd):
    return {k: v for k, v in sd.items() if "running" in k}


def _params(sd):
    return {k: v for k, v in sd.items() if "running" not in k and "num_batches" not in k}


@pytest.mark.parametrize("tag", ["full", "tail"])
def test_step_two_ranks_match_one(ops_run, tag):
    """Invariants 1 and 3 at the step: the 2-rank step from the same weights
    and draws gives the 1-process step's losses, parameters and running
    statistics, and both ranks hold the same bits afterwards."""
    case, ranks = ops_run["case"], ops_run["ranks"]
    cfg = case["cfg"]
    net = Net(cfg)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in case["sd"].items()})
    opt = make_optimizer(cfg, net.parameters())
    losses = update(net, opt, cfg, _tree(case["steps"][tag], torch.as_tensor), None)
    sd, moments, _ = _state(net, opt)
    for o in ranks:
        got_losses, got_sd, _, _ = o["steps"][tag]
        for k, v in losses.items():
            assert abs(got_losses[k] - float(v)) <= 1e-5, (tag, k)
        _params_band(_params(got_sd), _params(sd), tag)
        for k, v in _running(sd).items():
            np.testing.assert_allclose(got_sd[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    for a, b in zip(ranks[0]["steps"][tag][1:3], ranks[1]["steps"][tag][1:3]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_step_two_ranks_match_jax_mesh(ops_run):
    """Invariant 4: the port's 2-rank tail step (masked BatchNorm and
    losses, rank 1's share all padding) on JAX's draws against JAX's step
    on `make_mesh(2)`, at tests/test_torch_step.py's tolerances."""
    import jax
    from test_torch_step import _assert_params_close

    case, tag = ops_run["case"], "tail"
    got_losses, got_sd, _, grads = ops_run["ranks"][0]["steps"][tag]
    params, state, _, jlosses = jax.device_get(ops_run["jax"])
    for k in jlosses:
        assert abs(got_losses[k] - float(jlosses[k])) <= 1e-5 * max(
            1.0, abs(float(jlosses[k]))), (tag, k)
    net = Net(case["cfg"])
    net.load_state_dict({k: torch.as_tensor(v) for k, v in got_sd.items()})
    before = case["sd"]
    eps_regime = {n: torch.as_tensor(
        n.endswith(".model.0.bias")
        | (np.abs(grads[n] + case["cfg"].weight_decay_rate * before[n]) < 1e-6))
        for n, _ in net.named_parameters()}
    _assert_params_close(net, params, state, eps_regime, 2 * case["cfg"].init_lr, tag)
    from deep_interpolation_clustering_tpu_torch.compat import state_dict_from_jax

    for name, v in state_dict_from_jax(params, state).items():
        if "running" in name:
            np.testing.assert_allclose(got_sd[name], v.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


# ----------------------------------------------------------- trainer rank
def _cohorts():
    cohorts = process_splits(make_synthetic_cohorts(n_total=90, max_obs=T, seed=5),
                             rng=np.random.RandomState(0))
    # 2 full batches and a 5-row tail (rank 1's share all padding); the
    # validation split one batch and a 5-row tail
    sizes = {"training": 2 * B + 5, "validation": B + 5}
    return {c: {k: v[:n] for k, v in cohorts[c].items()} for c, n in sizes.items()}


def _cfgs():
    p1 = Config(batch_size=B, num_timestamps=T, lstm_hidden=H, head_hidden=H,
                aux_tasks=AUX, aug_input=True, max_epochs=3)
    p3 = p1.replace(loss="ae_mse_sup_fake_detect_triplet_kl", triple_margin=1.0,
                    cluster_number=3, kmeans_n_init=3)
    return p1, p3


def _train(cfg, ds, exp, epochs=2):
    tr = Trainer(cfg, ds, exp, device="cpu")
    losses = []
    for _ in range(epochs):
        losses.append(tr.train_one_epoch())
        tr.epoch += 1
    valid, dumps = tr.eval_one_epoch("valid", ds["validation"], False, ("hidden", "rec_ob"))
    return tr, losses, valid, {k: np.concatenate(v) for k, v in dumps.items()}


def _dec(cfg, ds, exp, pre):
    ct = ClusterTrainer(cfg, ds, exp, pretrain_exp_path=pre, device="cpu")
    prev = ct.init_centers()
    centers = _np(ct.net.cluster_assignment.cluster_centers)
    epoch = ct.train_one_epoch()
    delta, n_changed, _, metrics = ct.generate_pred_cluster("valid", ds["validation"], prev)
    sd = {k: _np(v) for k, v in ct.net.state_dict().items()}
    ct.close()
    return dict(prev=prev.numpy(), centers=centers, epoch=epoch, delta=delta,
                n_changed=n_changed, metrics=metrics, sd=sd)


def _bf16(cfg, cohorts, exp):
    """Two bfloat16 epochs, each validated and checkpointed (rank 0 writes)."""
    tr = Trainer(cfg, {c: ArrayDataset(cfg, d, c) for c, d in cohorts.items()}, exp,
                 device="cpu")
    rows = []
    for _ in range(2):
        train = tr.train_one_epoch()
        valid, _ = tr.eval_one_epoch("valid", tr.datasets["validation"], False, ("hidden",))
        tr.aly_pred("valid", dict(valid))
        rows.append((train, valid))
        tr.epoch += 1
    dtypes = {str(p.dtype) for p in tr.net.parameters()}
    tr.close()
    return dict(rows=rows, dtypes=dtypes)


def _trainer_rank(r, address, cohorts, root, pre):
    _world(r, address)
    try:
        cfg, dcfg = _cfgs()
        ds = {c: ArrayDataset(cfg, d, c) for c, d in cohorts.items()}
        tr, losses, valid, dumps = _train(cfg, ds, os.path.join(root, f"p1_rank{r}"))
        sd, moments, _ = _state(tr.net, tr.opt)
        tr.close()
        dec = _dec(dcfg, {c: ArrayDataset(dcfg, d, c) for c, d in cohorts.items()},
                   os.path.join(root, f"p3_rank{r}"), pre)
        bf16 = _bf16(cfg.replace(compute_dtype="bfloat16"), cohorts,
                     os.path.join(root, "p1_bf16"))
        return dict(losses=losses, valid=valid, dumps=dumps, sd=sd, moments=moments, dec=dec,
                    bf16=bf16)
    finally:
        parallel.shutdown()


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp"))
    cohorts = _cohorts()
    cfg, dcfg = _cfgs()
    ds = {c: ArrayDataset(cfg, d, c) for c, d in cohorts.items()}
    # the one-process run, whose checkpoint the DEC runs start from
    tr, losses, valid, dumps = _train(cfg, ds, os.path.join(root, "p1_single"))
    tr.aly_pred("valid", dict(valid))
    sd, _, _ = _state(tr.net, tr.opt)
    tr.close()
    pre = os.path.join(root, "p1_single")
    address = f"127.0.0.1:{parallel.free_port()}"
    ranks = parallel.spawn(_trainer_rank, D, (address, cohorts, root, pre),
                           timeout_s=SPAWN_TIMEOUT_S)
    dec = _dec(dcfg, {c: ArrayDataset(dcfg, d, c) for c, d in cohorts.items()},
               os.path.join(root, "p3_single"), pre)
    return dict(root=root, ranks=ranks, one=dict(losses=losses, valid=valid, dumps=dumps,
                                                 sd=sd, dec=dec))


def test_trainer_epochs_two_ranks_match_one(trainer_run):
    """Invariant 1 over two epochs with dropout, augmentation and a ragged
    tail whose second share is all padding, then an eval pass whose last
    batch is padded the same way."""
    one = trainer_run["one"]
    for o in trainer_run["ranks"]:
        for got, want in zip(o["losses"], one["losses"]):
            for k in want:
                assert abs(got[k] - want[k]) < 1e-5, k
        _params_band(_params(o["sd"]), _params(one["sd"]), "trainer")
        _running_band(o["sd"], one["sd"])
        assert abs(o["valid"]["ae_mse"] - one["valid"]["ae_mse"]) < 5e-4
        np.testing.assert_allclose(o["dumps"]["hidden"], one["dumps"]["hidden"], atol=1e-4)
        np.testing.assert_allclose(o["dumps"]["rec_ob"], one["dumps"]["rec_ob"], rtol=3e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(o["dumps"]["__index__"], one["dumps"]["__index__"])


def test_trainer_ranks_bit_identical(trainer_run):
    """Invariant 3: parameters, BatchNorm buffers and optimizer state, and
    the gathered dumps, are the same bits on both ranks."""
    a, b = trainer_run["ranks"]
    for key in ("sd", "moments", "dumps"):
        assert a[key].keys() == b[key].keys()
        for k in a[key]:
            np.testing.assert_array_equal(a[key][k], b[key][k], err_msg=f"{key} {k}")
    assert a["losses"] == b["losses"] and a["valid"] == b["valid"]


def test_trainer_rank_one_writes_nothing(trainer_run):
    root = trainer_run["root"]
    assert os.path.exists(os.path.join(root, "p1_rank0", "config.json"))
    assert os.path.exists(os.path.join(root, "p1_rank0", "summary", "events.jsonl"))
    for stage in ("p1", "p3"):
        assert not os.path.exists(os.path.join(root, f"{stage}_rank1"))


def test_dec_init_centers_and_epoch_two_ranks(trainer_run):
    """`init_centers` (rank 0 fits on the gathered latents and broadcasts)
    and one DEC epoch with the KL and triplet terms, against one process;
    the ranks' centres, labels and delta are the same."""
    one = trainer_run["one"]["dec"]
    a, b = (o["dec"] for o in trainer_run["ranks"])
    np.testing.assert_array_equal(a["centers"], b["centers"])
    np.testing.assert_allclose(a["centers"], one["centers"], atol=1e-4)
    np.testing.assert_array_equal(a["prev"], one["prev"])
    for k in one["epoch"]:
        assert abs(a["epoch"][k] - one["epoch"][k]) < 1e-5, k
    assert (a["delta"], a["n_changed"]) == (one["delta"], one["n_changed"])
    assert (b["delta"], b["n_changed"]) == (one["delta"], one["n_changed"])
    _params_band(_params(a["sd"]), _params(one["sd"]), "dec")
    _running_band(a["sd"], one["sd"])
    for k in a["sd"]:
        np.testing.assert_array_equal(a["sd"][k], b["sd"][k], err_msg=k)


def test_bf16_epochs_two_ranks_write_float32_checkpoints(trainer_run):
    from deep_interpolation_clustering_tpu import Config as JConfig
    from deep_interpolation_clustering_tpu.train.checkpoint import load_checkpoint

    a, b = (o["bf16"] for o in trainer_run["ranks"])
    assert a["rows"] == b["rows"] and len(a["rows"]) == 2
    assert all(np.isfinite(v) for row in a["rows"] for part in row for v in part.values())
    assert a["dtypes"] == {"torch.float32"}
    exp = os.path.join(trainer_run["root"], "p1_bf16")
    assert JConfig.load(os.path.join(exp, "config.json")).compute_dtype == "bfloat16"
    for metric in ("loss", "ae_mse"):
        _, params, state, _, _ = load_checkpoint(os.path.join(exp, "weight", metric,
                                                              "checkpoint.npz"))
        leaves = [np.asarray(v) for v in _leaves((params, state))]
        assert leaves and {v.dtype for v in leaves} == {np.dtype(np.float32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for x in tree.values() for v in _leaves(x)]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _leaves(x)]
    return [tree]
