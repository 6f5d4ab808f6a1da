"""mTAN's hand kernels on the card against their plain versions: the
encoder attention pair (`ops/cuda_mtan.py`, `csrc/mtan.cu`) and the GRU
recurrence pair G1 (`ops/cuda_gru.py`, `csrc/gru.cu`). They need a CUDA card
and `nvcc`, so they skip elsewhere; they import neither JAX nor this
directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_mtan_gpu.py

At R = D = 128 (mTAN's reference points and time embedding), for T in
{1, 24, 48, 354, 1024} slots and B in {1, 13, 256} encounters of C = 6
channels, with fully padded channels, front-packed counts and scattered
masks: the forward's weighted sums within 1e-5 and its max and log-sum
within 1e-5 of the plain version's, each gradient (dQ, dK, the values')
within 1e-4 of its largest element, and two runs bit-identical. G1 at
the cell's three GRUs (the encoder's 256 -> 256 and the decoder's 20 -> 50,
both bidirectional, the classifier's 20 -> 256) over R = 128 steps, at B =
256 and at a ragged 13: its outputs and last states within 1e-5 of their
largest element of the plain version's and of `nn.GRU`'s (cuDNN, the
library yardstick), every gradient (the input's and each parameter's)
within 1e-4, and two runs bit-identical. A train step through the
trainer's captured graph counts both pairs' calls (`mtan.attn_launches`,
`mtan.gru_launches`) and launches all four kernels.
"""

import tempfile

import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.data import (
    ArrayDataset,
    make_synthetic_cohorts,
    process_splits,
)
from deep_interpolation_clustering_tpu_torch.ops import cuda_gru as cg
from deep_interpolation_clustering_tpu_torch.ops import cuda_mtan as cm
from deep_interpolation_clustering_tpu_torch.train import Trainer
from deep_interpolation_clustering_tpu_torch.utils import resolve_device, tracing

pytestmark = pytest.mark.gpu

C, R, D = 6, 128, 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: mTAN's hand-written attention kernels")
    return resolve_device("cuda")  # TF32 off


def _inputs(b: int, t_len: int, dev):
    gen = torch.Generator(device=dev).manual_seed(1000 * b + t_len)
    heads = b * C
    q = torch.randn((R, D), generator=gen, device=dev)
    k = torch.randn((heads, t_len, D), generator=gen, device=dev)
    counts = torch.randint(0, t_len + 1, (heads,), generator=gen, device=dev)
    counts[::5] = 0  # fully padded channels
    slots = torch.arange(t_len, device=dev)
    mask = (slots[None, :] < counts[:, None]).to(torch.float32)
    scattered = (torch.rand((heads, t_len), generator=gen, device=dev) < 0.3).to(torch.float32)
    mask[1::7] = scattered[1::7]  # observations not at the front
    ob = torch.randn((heads, t_len), generator=gen, device=dev) * mask
    g_ob = torch.randn((heads, R), generator=gen, device=dev)
    g_m = torch.randn((heads, R), generator=gen, device=dev)
    return q, k, ob, mask, g_ob, g_m


def _close(got, want, tol, what):
    top = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * top, f"{what}: {err:.3g} of the largest {top:.3g}"


@pytest.mark.parametrize("b", [1, 13, 256])
@pytest.mark.parametrize("t_len", [1, 24, 48, 354, 1024])
def test_pair_against_plain(dev, b, t_len):
    q, k, ob, mask, g_ob, g_m = _inputs(b, t_len, dev)
    scale = D ** -0.5
    got = cm.attn_fwd(q, k, ob, mask, scale)
    want = cm._attn_fwd_plain(q, k, ob, mask, scale)
    torch.cuda.synchronize()
    for name, x, y in zip(("out_ob", "out_m", "max", "lse"), got, want):
        err = float(((x - y).abs() / torch.clamp(y.abs(), min=1.0)).max())
        assert err <= 1e-5, (name, err)
    out_ob, out_m, _, lse = got
    grads = cm.attn_bwd(q, k, ob, mask, out_ob, out_m, lse, g_ob, g_m, scale)
    plain = cm._attn_bwd_plain(q, k, ob, mask, out_ob, out_m, lse, g_ob, g_m, scale)
    torch.cuda.synchronize()
    for name, x, y in zip(("dk", "dob", "dq"), grads, plain):
        _close(x, y, 1e-4, name)
    again = cm.attn_fwd(q, k, ob, mask, scale)
    again_grads = cm.attn_bwd(q, k, ob, mask, out_ob, out_m, lse, g_ob, g_m, scale)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(torch.equal(x, y) for x, y in zip(grads, again_grads))


# the cell's GRUs (input width, H, bidirectional) at mTAN's published widths
GRUS = {"encoder": (256, 256, True), "decoder": (20, 50, True), "classifier": (20, 256, False)}


def _gru_grads(fn, module, x, g_out, g_last):
    out, last = fn(x)
    leaves = [x, *module.parameters()]
    grads = torch.autograd.grad((out * g_out).sum() + (last * g_last).sum(), leaves)
    return [out.detach(), last.detach(), *grads]


@pytest.mark.parametrize("b", [13, 256])
@pytest.mark.parametrize("which", list(GRUS))
def test_gru_pair_against_plain_and_library(dev, which, b):
    n_in, hidden, bi = GRUS[which]
    torch.manual_seed(100 + b)
    module = torch.nn.GRU(n_in, hidden, bidirectional=bi, batch_first=True).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7 * b + hidden)
    x = torch.randn((b, R, n_in), generator=gen, device=dev, requires_grad=True)
    dirs = 2 if bi else 1
    g_out = torch.randn((b, R, dirs * hidden), generator=gen, device=dev)
    g_last = torch.randn((dirs, b, hidden), generator=gen, device=dev)
    launches = cg.gru_fwd.launches, cg.gru_bwd.launches
    got = _gru_grads(lambda v: cg.gru(module, v), module, x, g_out, g_last)
    assert (cg.gru_fwd.launches, cg.gru_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    plain = _gru_grads(lambda v: cg.gru(module, v, use_kernel=False), module, x, g_out, g_last)
    library = _gru_grads(module, module, x, g_out, g_last)
    torch.cuda.synchronize()
    names = ["out", "last", "x", *(n for n, _ in module.named_parameters())]
    for want, what in ((plain, "plain"), (library, "nn.GRU")):
        for name, a, w in zip(names, got, want):
            _close(a, w, 1e-5 if name in ("out", "last") else 1e-4, f"{which} {name} vs {what}")
    again = _gru_grads(lambda v: cg.gru(module, v), module, x, g_out, g_last)
    assert all(torch.equal(a, w) for a, w in zip(got, again))


def test_graphed_mtan_step_runs_the_pair(dev):
    cfg = Config(model="mtan", batch_size=16, num_timestamps=48, max_epochs=2, grad_clip=0.0,
                 init_lr=1e-4)
    cohorts = process_splits(make_synthetic_cohorts(n_total=60, max_obs=48, seed=3),
                             rng=np.random.RandomState(0))
    datasets = {k: ArrayDataset(cfg, v, k) for k, v in cohorts.items()}
    with tempfile.TemporaryDirectory() as d:
        trainer = Trainer(cfg, datasets, d, device=dev)
        fwd, bwd = cm.attn_fwd.launches, cm.attn_bwd.launches
        gru_fwd, gru_bwd = cg.gru_fwd.launches, cg.gru_bwd.launches
        tracing.enable(dev)
        try:
            trainer.train()
            counters = tracing.report()["counters"]
        finally:
            tracing.disable()
        trainer.close()
    assert cm.attn_fwd.launches > fwd and cm.attn_bwd.launches > bwd
    assert cg.gru_fwd.launches > gru_fwd and cg.gru_bwd.launches > gru_bwd
    # counted at capture (the train graphs, full and tail, and the eval
    # graphs) and on every replay: three GRUs a forward, three a backward
    assert counters.get(cm.COUNTER, 0) >= 2
    steps = counters["train.steps"]
    assert counters.get(cg.COUNTER, 0) >= 6 * steps
