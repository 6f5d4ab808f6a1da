"""mTAN (`Config.model = "mtan"`, `models/mtan.py`) on the CPU against the
benchmark's plain reference (`portbench/reference/mtan.py`, mTAN's own code
form: the union time axis, the scores repeated over the value columns,
`nn.GRU`), on seeded weights: the forward's losses within 1e-5 relative,
every gradient leaf within 1e-4 of its largest element (a leaf whose
gradient is 0 in exact arithmetic under 1e-5 of the median leaf's), and the encoder's
attention within 1e-6, at small widths and once at the published ones.
Then the p1 trainer, p2 and p4 on mTAN's dumps, and each combination that
mTAN does not support raising.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import cohort as bench_cohort  # noqa: E402
from portbench.reference import mtan as reference  # noqa: E402
from portbench.reference.train import prepare  # noqa: E402

from deep_interpolation_clustering_tpu_torch import Config  # noqa: E402
from deep_interpolation_clustering_tpu_torch.cli import convert, p1, p2, p4  # noqa: E402
from deep_interpolation_clustering_tpu_torch.cli.common import save_processed  # noqa: E402
from deep_interpolation_clustering_tpu_torch.data import (  # noqa: E402
    ArrayDataset,
    make_synthetic_cohorts,
    process_splits,
)
from deep_interpolation_clustering_tpu_torch.models.mtan import KL_WAIT, MTAN  # noqa: E402
from deep_interpolation_clustering_tpu_torch.ops import cuda_mtan  # noqa: E402
from deep_interpolation_clustering_tpu_torch.train import ClusterTrainer, Trainer  # noqa: E402
from deep_interpolation_clustering_tpu_torch.train.steps import (  # noqa: E402
    build_inputs,
    forward_and_losses,
    gather_batch,
)

torch.set_num_threads(1)

SMALL = dict(batch_size=4, num_timestamps=24, mtan_ref_points=8, mtan_embed_time=16,
             mtan_rec_hidden=16, mtan_gen_hidden=8, mtan_latent_dim=4)
PUBLISHED = dict(batch_size=2, num_timestamps=12)  # mTAN's widths are Config's defaults
BASE = dict(model="mtan", grad_clip=0.0, init_lr=1e-4, weight_decay_rate=0.0,
            fake_detection=False)


def _cfg(**kw) -> Config:
    return Config(**BASE, **kw)


def _ref_cfg(cfg: Config) -> dict:
    return {k: getattr(cfg, k) for k in (
        "num_variables", "hours_from_admission", "batch_size", "scale", "init_lr",
        "weight_decay_rate", "grad_clip", "seed", "mtan_ref_points", "mtan_embed_time",
        "mtan_rec_hidden", "mtan_gen_hidden", "mtan_latent_dim", "mtan_alpha")}


def _setup(cfg: Config, seed: int = 5):
    """The reference's raw cohort, the port's net on the reference's seeded
    weights, and one batch of both."""
    raw = bench_cohort.make(40, (0.7, 0.15), cfg.num_timestamps, seed, "cpu",
                            cfg.hours_from_admission, min_obs=1)["training"]
    net = MTAN(cfg)
    weights = reference.init_weights({k: tuple(p.shape) for k, p in net.named_parameters()},
                                     seed + 1, "cpu")
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(weights[k])
    rows = np.arange(cfg.batch_size)
    data = {k: torch.as_tensor(v) for k, v in ArrayDataset(cfg, raw, "training").arrays().items()}
    batch = gather_batch(data, torch.as_tensor(rows))
    # a padded channel, and a channel with one observation
    batch["padding_mask"][0, 1] = 0.0
    batch["padding_mask"][1, 2] = 0.0
    batch["padding_mask"][1, 2, 0] = 1.0
    ref_batch = prepare(raw, rows, _ref_cfg(cfg), "cpu")
    ref_batch["mask"] = batch["padding_mask"].clone()
    return raw, net, weights, batch, ref_batch


@pytest.mark.parametrize("widths", [SMALL, PUBLISHED], ids=["small", "published"])
def test_losses_and_gradients_match_the_reference(widths):
    cfg = _cfg(**widths)
    _, net, weights, batch, ref_batch = _setup(cfg)
    epoch = KL_WAIT + 3  # a KL weight above 0
    net.set_epoch(epoch)
    gen = torch.Generator().manual_seed(9)
    eps = torch.randn((cfg.batch_size, cfg.mtan_ref_points, cfg.mtan_latent_dim), generator=gen)
    inputs = build_inputs(cfg, batch, None, True, False, {"eps": eps})
    _, losses = forward_and_losses(net, cfg, inputs, True, None)
    losses["loss"].backward()
    model = reference._Precision("float32").model(_ref_cfg(cfg), weights, "cpu")
    want, grads = reference.batch_losses(model, _ref_cfg(cfg), ref_batch, eps,
                                         reference.kl_weight(epoch), grads=True)
    assert set(losses) == set(reference.LOSS_KEYS)
    for k in reference.LOSS_KEYS:
        assert abs(float(losses[k]) - want[k]) <= 1e-5 * abs(want[k]), (k, float(losses[k]),
                                                                          want[k])
    # a leaf the softmax makes nought (a key bias b_k adds the same q . b_k
    # to every score of a row: its gradient is 0 but for rounding), under
    # 1e-5 of the median leaf's largest element, is held to be as nought on
    # both sides
    tops = {name: float(g.abs().max()) for (name, _), g in zip(model.named_parameters(), grads)}
    median = float(np.median(list(tops.values())))
    for (name, _), g in zip(model.named_parameters(), grads):
        got = dict(net.named_parameters())[name].grad
        if tops[name] < 1e-5 * median:
            assert float(got.abs().max()) <= 1e-5 * median, name
        else:
            assert float((got - g).abs().max()) <= 1e-4 * tops[name], name


def test_eval_forward_is_the_posterior_mean():
    cfg = _cfg(**SMALL)
    _, net, weights, batch, ref_batch = _setup(cfg)
    inputs = build_inputs(cfg, batch, None, False, False)
    assert inputs["eps"] is None
    with torch.no_grad():
        out, losses = forward_and_losses(net, cfg, inputs, False, None)
        again, _ = forward_and_losses(net, cfg, inputs, False, None)
    assert torch.equal(out.hidden, again.hidden) and out.hidden.shape == (4, 16)
    model = reference._Precision("float32").model(_ref_cfg(cfg), weights, "cpu")
    with torch.no_grad():
        want, _ = reference.batch_losses(model, _ref_cfg(cfg), ref_batch, None, 0.0)
        hidden = reference.block_terms(model, _ref_cfg(cfg), ref_batch, None)["hidden"]
    for k in reference.LOSS_KEYS:
        assert abs(float(losses[k]) - want[k]) <= 1e-5 * abs(want[k]), k
    assert float((out.hidden - hidden).abs().max()) <= 1e-6


@pytest.mark.parametrize("use_kernel", [True, False], ids=["pair", "plain"])
def test_encoder_attention_matches_the_reference(use_kernel):
    """The port's per-channel attention (the pair's plain versions, or the
    plain forward under autograd) and W_o, against mTAN's repeated-score
    attention over the union axis, with a padded channel and a channel
    with one observation."""
    cfg = _cfg(**SMALL)
    _, net, weights, batch, ref_batch = _setup(cfg)
    rec = net.rec
    ob, mask = batch["ob"] * batch["padding_mask"], batch["padding_mask"]
    with torch.no_grad():
        w_q, w_k, w_o = rec.att.linears
        q = w_q(rec.embed(net.reference_times(ob)))
        k = w_k(rec.embed(batch["timestamp"] / cfg.hours_from_admission))
        h_ob, h_m = cuda_mtan.encoder_attention(q, k, ob, mask, use_kernel)
        got = w_o(torch.cat([h_ob, h_m], dim=1).permute(0, 2, 1))
        model = reference._Precision("float32").model(_ref_cfg(cfg), weights, "cpu")
        x, tt, _, obs = reference.union(ref_batch, cfg.hours_from_admission)
        enc = model.rec
        want = enc.att(enc.learn_time_embedding(enc.query.unsqueeze(0)),
                       enc.learn_time_embedding(tt), x, torch.cat([obs, obs], 2))
    assert float((got - want).abs().max()) <= 1e-6
    # the padded channel's columns are 0; the one observation's weight is 1
    assert float(h_ob[0, 1].abs().max()) == 0.0 and float(h_m[0, 1].abs().max()) == 0.0
    torch.testing.assert_close(h_m[1, 2], torch.ones_like(h_m[1, 2]), rtol=0, atol=1e-6)
    torch.testing.assert_close(h_ob[1, 2], ob[1, 2, 0].expand_as(h_ob[1, 2]), rtol=0, atol=1e-6)


def _pickled_cohort(root: Path) -> str:
    base = str(root / "Data")
    cohorts = process_splits(make_synthetic_cohorts(n_total=40, max_obs=16, seed=4),
                             rng=np.random.RandomState(0))
    save_processed(Config(base_path=base), cohorts)
    return base


def test_p1_trains_and_p2_p4_read_the_dumps(tmp_path):
    base, results = _pickled_cohort(tmp_path), str(tmp_path / "Results")
    flags = ["--model", "mtan", "--batch_size", "8", "--num_timestamps", "16",
             "--mtan_ref_points", "8", "--mtan_embed_time", "16", "--mtan_gen_hidden", "8",
             "--mtan_latent_dim", "4", "--max_epochs", "3", "--grad_clip", "0",
             "--base_path", base, "--results_path", results]
    exp = p1.main(flags, device="cpu")
    for metric in ("loss", "ae_mse"):
        for cohort in ("training", "validation", "testing"):
            dump = np.load(os.path.join(exp, "out_feat", metric, f"{cohort}.npy"),
                           allow_pickle=True).item()
            assert dump["hidden"].shape[1] == 256 and np.isfinite(dump["hidden"]).all()
            assert dump["rec_ob"].shape == dump["ob"].shape
    p2.main(["--k_max", "4", "--n_init", "2", "--gap_b", "2", "--base_path", base,
             "--results_path", results, "--restore_metrics", "ae_mse"], device="cpu")
    labels = p4.main(["--stage", "Pretrain", "--restore_metrics", "loss", "--cluster_method",
                      "kmeans", "--num_clusters", "3", "--kmeans_n_init", "2",
                      "--base_path", base, "--results_path", results], device="cpu")
    assert set(labels["loss"]) == {"training", "validation", "testing"}
    assert all(set(np.unique(v)) <= {0, 1, 2} for v in labels["loss"].values())


def test_one_trainer_epoch_and_the_kl_weight(tmp_path):
    cfg = _cfg(**SMALL, max_epochs=2)
    raw = bench_cohort.make(40, (0.7, 0.15), cfg.num_timestamps, 3, "cpu",
                            cfg.hours_from_admission)
    datasets = {k: ArrayDataset(cfg, v, k) for k, v in raw.items()}
    trainer = Trainer(cfg, datasets, str(tmp_path), device="cpu")
    before = {k: p.detach().clone() for k, p in trainer.net.named_parameters()}
    valid = trainer.train()
    trainer.close()
    assert set(valid) >= set(reference.LOSS_KEYS) and np.isfinite(valid["loss"])
    assert float(trainer.net.kl_weight) == 0.0  # epoch 1, before KL_WAIT
    trainer._epoch_batches(KL_WAIT + 2)  # each epoch's batches set its KL weight first
    assert float(trainer.net.kl_weight) == pytest.approx(1.0 - 0.99 ** 2)
    moved = [k for k, p in trainer.net.named_parameters() if not torch.equal(p, before[k])]
    assert len(moved) == len(before)


def test_a_checkpoint_holds_the_weights_and_adam_state_in_the_ports_layout(tmp_path):
    from deep_interpolation_clustering_tpu_torch.compat import (
        optimizer_from_jax, optimizer_to_jax,
    )
    from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt
    from deep_interpolation_clustering_tpu_torch.train.optim import make_optimizer

    cfg = _cfg(**SMALL, max_epochs=2)
    raw = bench_cohort.make(40, (0.7, 0.15), cfg.num_timestamps, 3, "cpu",
                            cfg.hours_from_admission)
    datasets = {k: ArrayDataset(cfg, v, k) for k, v in raw.items()}
    trainer = Trainer(cfg, datasets, str(tmp_path / "p1"), device="cpu")
    trainer.train()
    trainer.close()
    to_tree, from_tree = ckpt.layout("mtan")
    net, opt = trainer.net, trainer.opt
    params, state = to_tree(net.state_dict())
    assert state == {} and set(params) == {"rec", "dec", "classifier"}
    path = ckpt.save_checkpoint(str(tmp_path / "c.npz"), 1, params, state,
                                optimizer_to_jax(opt, net, 7, (to_tree, from_tree)))
    fresh = MTAN(cfg)
    fresh_opt = make_optimizer(cfg, fresh.parameters())
    template = optimizer_to_jax(fresh_opt, fresh, 0, (to_tree, from_tree))
    _, p2, s2, leaves, _ = ckpt.load_checkpoint(path, template)
    fresh.load_state_dict(from_tree(p2, s2), strict=True)
    assert optimizer_from_jax(fresh_opt, fresh, leaves, (to_tree, from_tree)) == 7
    for (name, p), q in zip(net.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), name
        for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key].cpu(), fresh_opt.state[q][key].cpu()), (name, key)
    written = tmp_path / "p1" / "weight" / "loss" / ckpt.CKPT_NAME
    assert ckpt.load_meta(str(written))["model"] == "mtan"


def test_unsupported_combinations_raise(tmp_path):
    with pytest.raises(ValueError, match="compute_dtype"):
        _cfg(compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="data-parallel"):
        _cfg(data_parallel=2)
    with pytest.raises(ValueError, match="data-parallel"):
        _cfg(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="aux_tasks"):
        MTAN(_cfg(aux_tasks={"future_vital": 0.5, "ICU": 1.0}))
    cfg = _cfg(**SMALL, max_epochs=2)
    raw = bench_cohort.make(40, (0.7, 0.15), cfg.num_timestamps, 3, "cpu",
                            cfg.hours_from_admission)
    datasets = {k: ArrayDataset(cfg, v, k) for k, v in raw.items()}
    with pytest.raises(ValueError, match="DEC head"):
        ClusterTrainer(cfg, datasets, str(tmp_path / "dec"), device="cpu")
    trainer = Trainer(cfg, datasets, str(tmp_path / "p1"), device="cpu")
    trainer.train()
    trainer.close()
    src = tmp_path / "p1" / "weight" / "loss" / "checkpoint.npz"
    with pytest.raises(ValueError, match="no mTAN"):
        convert.to_torch(str(src), str(tmp_path / "model.pth.tar"))
    torch.save({"state_dict": trainer.net.state_dict()}, tmp_path / "mtan.pth.tar")
    with pytest.raises(ValueError, match="no mTAN"):
        convert.to_jax(str(tmp_path / "mtan.pth.tar"), str(tmp_path / "out.npz"))
