"""The optimizer tail's kernel pair on the card (`ops/cuda_optim.py`,
`csrc/optim.cu`) against the plain tail it replaces. They need a CUDA card
and `nvcc`, so they skip elsewhere; they import neither JAX nor this
directory's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_optim_gpu.py

The plain tail is `clip_grad_global_norm_` and then the card's Adam of
`make_optimizer` (torch's capturable amsgrad Adam on float64 step counts).
From the same parameters and gradients at the model's 37 leaf shapes, with
weight decay, 20 steps with the clip engaged on even steps and idle on odd
ones and the rate changed before step 11: every parameter and all four
state entries within 1e-6 of themselves plus 1e-6 of their largest value
(as `chip_smoke.py` holds the card's optimizer to the CPU's), and the
global norm within 1e-6. With no clip an overflowed norm clips nothing.
Two runs of the pair are bit-identical. The wrapper `clip_adam_` counts
one launch a step; the profiler sees its two kernels run, once each a
step, and nothing else: eagerly, in each replay of a CUDA graph that
captured it, and, for more leaves than one launch takes, once for each
group of leaves.
"""

import math
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
from deep_interpolation_clustering_tpu_torch.models.net import Net
from deep_interpolation_clustering_tpu_torch.ops import _cuda_build as cb
from deep_interpolation_clustering_tpu_torch.ops import cuda_optim
from deep_interpolation_clustering_tpu_torch.train import Trainer
from deep_interpolation_clustering_tpu_torch.train.optim import (
    clip_adam_step_,
    clip_grad_global_norm_,
    make_optimizer,
    set_learning_rate,
)
from deep_interpolation_clustering_tpu_torch.utils import resolve_device
from deep_interpolation_clustering_tpu_torch.utils.profiling import device_profile

pytestmark = pytest.mark.gpu

STEPS = 20
MAX_NORM = 15.0
KERNELS = ("optim_partials_kernel", "optim_update_kernel")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the optimizer's hand-written kernels")
    return resolve_device("cuda")  # TF32 off


def _adam(dev, shapes):
    cfg = Config(weight_decay_rate=4e-4)
    gen = torch.Generator().manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(s, generator=gen).to(dev)) for s in shapes]
    return params, make_optimizer(cfg, params)


def _model_shapes():
    shapes = [tuple(p.shape) for p in Net(Config()).parameters()]
    assert len(shapes) == 37
    return shapes


def _counts():
    return cuda_optim.clip_adam_.launches


def _kernels(names):
    """Each of the pair's kernels by the count of `names` (profiled kernel
    names) that hold it, and the count of the others under "other"."""
    out = {k: sum(k in n for n in names) for k in KERNELS}
    out["other"] = len(names) - sum(out.values())
    return out


def _profiled(fn):
    """The kernels one call of `fn` runs on the device, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _run(dev, shapes, kernel: bool):
    """STEPS steps of the pair (`kernel`) or of the plain tail from the same
    start and gradients; returns the parameters, the optimizer, the norms
    and the optimizer kernels' launches."""
    params, opt = _adam(dev, shapes)
    gen = torch.Generator().manual_seed(1)
    norms = []
    cb.reset_launch_counts()
    for step in range(STEPS):
        if step == 10:
            set_learning_rate(opt, 1e-4)
        scale = 50.0 if step % 2 == 0 else 1e-3
        for p in params:
            p.grad = (torch.randn(p.shape, generator=gen) * scale).to(dev)
        if kernel:
            norms.append(clip_adam_step_(opt, MAX_NORM))
        else:
            norms.append(clip_grad_global_norm_(params, MAX_NORM))
            opt.step()
    torch.cuda.synchronize()
    return params, opt, torch.stack(norms).cpu(), _counts()


def _within(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    top = float(want.abs().max())
    return not bool(((got - want).abs() > 1e-6 * want.abs() + 1e-6 * top).any())


def _check_against_plain(dev, shapes):
    kp, kopt, knorms, launches = _run(dev, shapes, True)
    pp, popt, pnorms, plain_launches = _run(dev, shapes, False)
    assert plain_launches == 0
    torch.testing.assert_close(knorms, pnorms, rtol=1e-6, atol=0)
    assert bool((pnorms[0::2] >= MAX_NORM).all()) and bool((pnorms[1::2] < MAX_NORM).all())
    for a, b in zip(kp, pp):
        assert set(kopt.state[a]) == {"step", "exp_avg", "exp_avg_sq", "max_exp_avg_sq"}
        assert kopt.state[a]["step"].dtype == torch.float64
        assert float(kopt.state[a]["step"]) == float(popt.state[b]["step"]) == STEPS
        assert _within(a, b)
        for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
            assert _within(kopt.state[a][k], popt.state[b][k]), k
    return launches


def test_kernel_pair_matches_the_plain_tail(dev):
    assert _check_against_plain(dev, _model_shapes()) == STEPS


def test_leaves_past_one_launch_take_the_same_two_kernels(dev):
    n = 2 * cuda_optim.MAX_LEAVES + 5
    shapes = [(3 + i % 7, 1 + (i * 37) % 3000) for i in range(n)]
    assert _check_against_plain(dev, shapes) == STEPS
    # three groups of leaves: each kernel three times a step, nothing else
    params, opt = _adam(dev, shapes)
    for p in params:
        p.grad = torch.randn_like(p)
    clip_adam_step_(opt, MAX_NORM)  # builds the kernels
    names = _profiled(lambda: clip_adam_step_(opt, MAX_NORM))
    assert _kernels(names) == {**{k: 3 for k in KERNELS}, "other": 0}, names


def test_no_clip_leaves_an_overflowed_norm_alone(dev):
    """With no clip, the largest leaf's gradients near 1e18 (the sum of
    squares overflows float32) clip nothing: the gradients and parameters
    stay finite and match the plain tail, Adam without the clip."""
    shapes = _model_shapes()
    big = max(range(len(shapes)), key=lambda i: math.prod(shapes[i]))
    (kp, kopt), (pp, popt) = _adam(dev, shapes), _adam(dev, shapes)
    gen = torch.Generator().manual_seed(4)
    for _ in range(3):
        for i, (a, b) in enumerate(zip(kp, pp)):
            a.grad = (torch.randn(a.shape, generator=gen) * (1e18 if i == big else 1.0)).to(dev)
            b.grad = a.grad.clone()
        norm = clip_adam_step_(kopt, None)
        popt.step()
        assert float(norm) == float("inf")
        for a, b in zip(kp, pp):
            assert bool(torch.isfinite(a.grad).all()) and bool(torch.isfinite(a).all())
            assert torch.equal(a.grad, b.grad)
            assert _within(a, b)


def test_kernel_pair_repeats_bit_for_bit(dev):
    a, aopt, anorms, _ = _run(dev, _model_shapes(), True)
    b, bopt, bnorms, _ = _run(dev, _model_shapes(), True)
    assert torch.equal(anorms, bnorms)
    for p, q in zip(a, b):
        assert torch.equal(p, q)
        for k, v in aopt.state[p].items():
            assert torch.equal(v, bopt.state[q][k]), k


def test_captured_pair_is_two_launches_a_replay(dev):
    """Captured in a CUDA graph, the wrapper records one launch; five
    replays count five and give the eager pair's five steps bit for bit,
    and each replay the profiler holds runs the two kernels once each."""
    shapes = _model_shapes()
    gen = torch.Generator().manual_seed(3)
    grads = [torch.randn(s, generator=gen).to(dev) for s in shapes]

    def start():
        params, opt = _adam(dev, shapes)
        for p, g in zip(params, grads):
            p.grad = g.clone()
        return params, opt

    def next_grads(params):
        for p, g in zip(params, grads):
            p.grad.copy_(g)

    eager = start()
    for _ in range(5):  # the first also builds the kernels
        next_grads(eager[0])
        clip_adam_step_(eager[1], MAX_NORM)
    graphed = start()
    graph = torch.cuda.CUDAGraph()
    before = cb.captured_counts()
    with torch.cuda.graph(graph):
        clip_adam_step_(graphed[1], MAX_NORM)
    recorded = {k: n - before[k] for k, n in cb.captured_counts().items() if n != before[k]}
    assert recorded == {"clip_adam": 1}
    cb.reset_launch_counts()
    for _ in range(5):
        next_grads(graphed[0])
        graph.replay()
        cb.add_launches(recorded)
    torch.cuda.synchronize()
    assert _counts() == 5
    (a, aopt), (b, bopt) = eager, graphed
    for p, q in zip(a, b):
        assert torch.equal(p, q)
        for k, v in aopt.state[p].items():
            assert torch.equal(v, bopt.state[q][k]), k
    prof = device_profile(graph.replay, 5)
    replays = [_kernels([n for n, c in r.items() for _ in range(c)])
               for r in prof["replay_kernels"]]
    # CUPTI may drop a replay's events: most of the five are held
    assert prof["graph_launches"] == 5 and 2 * len(replays) > 5, prof["replay_kernels"]
    assert all(r == {**{k: 1 for k in KERNELS}, "other": 0} for r in replays), replays


def test_fused_epoch_counts_one_launch_a_step(dev):
    """A fused p1 epoch at the default Config (two full batches and a
    masked tail): each train graph recorded one launch of the wrapper, and
    the epoch's replays count one a step."""
    cfg = Config()
    n_train, n_valid = 2 * cfg.batch_size + 60, 300
    share = (n_train + 0.5) / (n_train + n_valid)
    cohorts = process_splits(
        make_synthetic_cohorts(n_total=n_train + n_valid, max_obs=cfg.num_timestamps,
                               seed=11, split=(share, 1.0 - share, 0.0)),
        rng=np.random.RandomState(0))
    ds = {k: ArrayDataset(cfg, cohorts[k], k) for k in ("training", "validation")}
    tr = Trainer(cfg, ds, tempfile.mkdtemp(), device=dev)
    tr._dispatch_fused_epoch()  # warm-up and capture
    torch.cuda.synchronize()
    cb.reset_launch_counts()
    table, _ = tr._dispatch_fused_epoch()
    torch.cuda.synchronize()
    assert int(table.shape[0]) == 3
    assert _counts() == 3
    train = [g for key, g in tr._graphs.items() if key[0] == "train"]
    assert len(train) == 2  # the full batches' and the masked tail's
    for graph in train:
        assert graph.launches.get("clip_adam") == 1
    tr.close()
