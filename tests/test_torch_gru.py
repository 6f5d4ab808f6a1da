"""mTAN's GRUs through the recurrence pair G1 (`ops/cuda_gru.py`) on the CPU,
where the pair's wrappers take its plain version: held against `nn.GRU` at
the three GRUs of mTAN's published widths (the encoder's 256 -> 256 and the
decoder's 20 -> 50, both bidirectional, the classifier's 20 -> 256), small
B and T. Outputs, last states and the gradients of the input and of every
parameter within 1e-6 of their largest element in float32 and 1e-12 in
float64, through the autograd function (the kernels' path) and through the
plain forward differentiated by autograd (`use_kernel=False`). Also: the
launch geometry and the wrapper's constants against `csrc/gru.cu`, the
tracer's counter, the eval forward saving nothing, the modules G1 refuses,
and mTAN's parameter names, order, draws and checkpoint layout, which G1
leaves as `nn.GRU` made them.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.models.mtan import MTAN
from deep_interpolation_clustering_tpu_torch.ops import cuda_gru as cg
from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt
from deep_interpolation_clustering_tpu_torch.utils import tracing

SOURCE = Path(cg.__file__).resolve().parent.parent / "csrc" / "gru.cu"
# the cell's GRUs at mTAN's published widths: (input, H, bidirectional)
GRUS = {"encoder": (256, 256, True), "decoder": (20, 50, True), "classifier": (20, 256, False)}
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


def _run(fn, module, x, g_out, g_last):
    out, last = fn(x)
    grads = torch.autograd.grad((out * g_out).sum() + (last * g_last).sum(),
                                [x, *module.parameters()])
    return [out.detach(), last.detach(), *grads]


def _close(got, want, tol, what):
    top = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * top, f"{what}: {err:.3g} of the largest {top:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("use_kernel", [True, False], ids=["function", "plain"])
@pytest.mark.parametrize("which", list(GRUS))
def test_g1_matches_nn_gru(which, use_kernel, dtype):
    n_in, hidden, bi = GRUS[which]
    torch.manual_seed(3)
    module = nn.GRU(n_in, hidden, bidirectional=bi, batch_first=True).to(dtype)
    b, t_len, dirs = 3, 7, 2 if bi else 1
    x = torch.randn(b, t_len, n_in, dtype=dtype, requires_grad=True)
    g_out = torch.randn(b, t_len, dirs * hidden, dtype=dtype)
    g_last = torch.randn(dirs, b, hidden, dtype=dtype)
    got = _run(lambda v: cg.gru(module, v, use_kernel), module, x, g_out, g_last)
    want = _run(module, module, x, g_out, g_last)
    names = ["out", "last", "x", *(n for n, _ in module.named_parameters())]
    assert len(got) == len(names) == len(want)
    for name, a, w in zip(names, got, want):
        assert a.shape == w.shape and a.dtype == dtype, name
        _close(a, w, TOL[dtype], f"{which} {name}")


def test_saved_is_what_the_backward_takes():
    """The plain forward's saved planes: r, z, n, h W_hn^T + b_hn and h_prev,
    each step's h_prev the output of the step before it in walk order."""
    torch.manual_seed(4)
    b, t_len, hidden = 2, 5, 6
    xg = torch.randn(b, t_len, 2, 3 * hidden, dtype=torch.float64)
    w_hh = torch.randn(2, 3 * hidden, hidden, dtype=torch.float64)
    b_hh = torch.randn(2, 3 * hidden, dtype=torch.float64)
    out, saved = cg._fwd_plain(xg, w_hh, b_hh)
    assert saved.shape == (b, t_len, 2, cg.SAVED, hidden)
    h_prev = saved[:, :, :, cg.SAVED - 1]
    torch.testing.assert_close(h_prev[:, 1:, 0], out[:, :-1, 0], rtol=0, atol=0)
    torch.testing.assert_close(h_prev[:, :-1, 1], out[:, 1:, 1], rtol=0, atol=0)
    assert not h_prev[:, 0, 0].any() and not h_prev[:, -1, 1].any()
    r, z, n, hn = saved[:, :, :, 0], saved[:, :, :, 1], saved[:, :, :, 2], saved[:, :, :, 3]
    torch.testing.assert_close(out, n + z * (h_prev - n))
    assert ((r > 0) & (r < 1) & (z > 0) & (z < 1)).all() and (n.abs() < 1).all()
    gh_n = torch.einsum("btdk,djk->btdj", h_prev, w_hh[:, 2 * hidden:]) + b_hh[:, 2 * hidden:]
    torch.testing.assert_close(hn, gh_n)


def test_the_eval_forward_saves_nothing():
    module = nn.GRU(4, 6, bidirectional=True, batch_first=True)
    x = torch.randn(2, 3, 4)
    calls = []
    plain = cg.gru_fwd.plain
    cg.gru_fwd.plain = lambda *a: calls.append(a[-1]) or plain(*a)
    try:
        with torch.no_grad():
            out, last = cg.gru(module, x)
        cg.gru(module, x)
    finally:
        cg.gru_fwd.plain = plain
    assert calls == [False, True]
    want, want_last = module(x)
    torch.testing.assert_close(out, want.detach())
    torch.testing.assert_close(last, want_last.detach())


def test_each_call_of_either_kernel_counts():
    module = nn.GRU(4, 6, batch_first=True)
    x = torch.randn(2, 3, 4, requires_grad=True)
    tracing.enable("cpu")
    try:
        out, last = cg.gru(module, x)
        (out.sum() + last.sum()).backward()
        with torch.no_grad():
            cg.gru(module, x)
        counters = tracing.report()["counters"]
    finally:
        tracing.disable()
    assert counters[cg.COUNTER] == 3  # two forwards, one backward


@pytest.mark.parametrize("module", [
    nn.GRU(4, 6, num_layers=2, batch_first=True),
    nn.GRU(4, 6),
    nn.GRU(4, 6, bias=False, batch_first=True),
], ids=["two_layers", "time_first", "no_bias"])
def test_g1_refuses_what_it_does_not_compute(module):
    with pytest.raises(ValueError, match="mtan_gru"):
        cg.gru(module, torch.randn(2, 3, 4))


def _cuda_constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, f"csrc/gru.cu defines no {name}"
    return int(m.group(1))


def test_the_wrappers_constants_are_the_sources():
    assert cg.MAX_HIDDEN == _cuda_constant("kMaxHidden")
    assert cg.SMALL_HIDDEN == _cuda_constant("kSmallHidden")
    assert cg.CLUSTER_UNITS == _cuda_constant("kClusterUnits")
    assert cg.SAVED == _cuda_constant("kSaved")
    assert "gru.cu" in cg.cb.SOURCES


@pytest.mark.parametrize("hidden", [1, 3, 50, 64, 68, 100, 128, 200, 256])
def test_geometry_covers_every_unit_in_a_cluster(hidden):
    cluster, units = cg.geometry(hidden)
    assert cluster * units >= hidden > (cluster - 1) * units
    threads = 512
    splits = threads // units
    # the forward's threads: units x splits of a k sum over a range that
    # covers H; a portable cluster of at most 8 blocks
    k_width = cg.MAX_HIDDEN if cluster > 1 else cg.SMALL_HIDDEN
    assert units * splits == threads and cluster <= 8
    assert k_width >= hidden and k_width % splits == 0
    if hidden <= cg.SMALL_HIDDEN:
        assert (cluster, units) == (1, cg.SMALL_HIDDEN)


@pytest.mark.parametrize("hidden", [0, 66, 130, 257])
def test_geometry_refuses_widths_the_kernels_do_not_take(hidden):
    with pytest.raises(ValueError, match="mtan_gru"):
        cg.geometry(hidden)


GRU_PARAMETERS = [
    f"{module}.gru_rnn.{kind}_{part}_l0{sfx}"
    for module, sfxs in (("rec", ("", "_reverse")), ("dec", ("", "_reverse")),
                         ("classifier", ("",)))
    for sfx in sfxs for kind in ("weight", "bias") for part in ("ih", "hh")
]


def test_mtans_parameters_and_checkpoint_layout_are_nn_grus():
    """G1 reads the GRUs' parameters from the `nn.GRU` modules: their names,
    shapes, places in `named_parameters` and draws, and the checkpoint's
    leaves, are those of the modules."""
    cfg = Config(model="mtan", mtan_ref_points=8, mtan_embed_time=16)
    net = MTAN(cfg, torch.Generator().manual_seed(5))
    names = [n for n, _ in net.named_parameters()]
    grus = [n for n in names if ".gru_rnn." in n]
    assert sorted(grus) == sorted(GRU_PARAMETERS)
    for module in (net.rec.gru_rnn, net.dec.gru_rnn, net.classifier.gru_rnn):
        assert isinstance(module, nn.GRU) and module.batch_first and module.num_layers == 1
    # each GRU's tensors together, in nn.GRU's own order
    for prefix in ("rec.gru_rnn.", "dec.gru_rnn.", "classifier.gru_rnn."):
        own = [n for n in names if n.startswith(prefix)]
        assert own == [prefix + n for n, _ in net.get_submodule(prefix[:-1]).named_parameters()]
        first = names.index(own[0])
        assert names[first:first + len(own)] == own
    shapes = dict((n, tuple(p.shape)) for n, p in net.named_parameters())
    h_rec, h_gen, latent = cfg.mtan_rec_hidden, cfg.mtan_gen_hidden, cfg.mtan_latent_dim
    assert shapes["rec.gru_rnn.weight_hh_l0_reverse"] == (3 * h_rec, h_rec)
    assert shapes["dec.gru_rnn.weight_ih_l0"] == (3 * h_gen, latent)
    assert shapes["classifier.gru_rnn.bias_hh_l0"] == (3 * h_rec,)
    # the same seed draws the same parameters
    again = MTAN(cfg, torch.Generator().manual_seed(5))
    for (n, p), q in zip(net.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n
    to_tree, from_tree = ckpt.layout("mtan")
    params, state = to_tree(net.state_dict())
    flat = ckpt._flatten_nested(params)
    assert state == {} and sorted(flat) == sorted(n.replace(".", "/") for n in names)
    for n in GRU_PARAMETERS:
        np.testing.assert_array_equal(flat[n.replace(".", "/")],
                                      net.state_dict()[n].numpy())
    back = from_tree(params, state)
    assert list(back) == list(net.state_dict())
