"""Port of the checkpoint converter (`cli/convert.py`) vs the JAX one, on
the CPU.

`to_torch` of both packages on the same npz: the tars' state_dicts
array-equal (dtypes included) and their optimizer dicts equal, for adam,
sgd and rmsprop; the tar loads into the port's `Net` with `strict=True`
and into the optimizer class named, which then takes a step. `to_jax` of
both packages on a tar written from a port `Net`: the npz entries equal.
Directory mode round-trips every leaf bit for bit. The torch model of the
reference is not needed: the tars are written the way the reference writes
them (utils.py:141-145), from the port's `Net`, whose state_dict has the
reference's names.
"""

import os

import jax
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.cli.convert import main as jconvert_main
from deep_interpolation_clustering_tpu.models import init_net
from deep_interpolation_clustering_tpu.train import checkpoint as jckpt
from deep_interpolation_clustering_tpu_torch.cli.convert import main as convert_main
from deep_interpolation_clustering_tpu_torch.models import Net
from deep_interpolation_clustering_tpu_torch.train import checkpoint as ckpt
from deep_interpolation_clustering_tpu_torch.train import make_optimizer
from test_torch_model import configs

torch.set_num_threads(1)

_OPTIMIZERS = {"adam": torch.optim.Adam, "sgd": torch.optim.SGD, "rmsprop": torch.optim.RMSprop}


def _jax_npz(path, seed=3, lr=2e-4, epoch=5):
    jcfg, _ = configs()
    params, state = init_net(jax.random.PRNGKey(seed), jcfg)
    return jckpt.save_checkpoint(path, epoch, params, state, extra={"lr": lr})


def _reference_tar(path, cfg, seed=4, epoch=7, lr=2e-4):
    """A tar written as the reference writes one, from a port Net with
    non-trivial BatchNorm statistics."""
    net = Net(cfg, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.uniform_(-1, 1, generator=torch.Generator().manual_seed(seed))
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2, generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(net.parameters(), lr=lr, weight_decay=4e-4, amsgrad=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"epoch": epoch, "state_dict": net.state_dict(),
                "optimizer": opt.state_dict()}, path)
    return net


def _load_tar(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_npz_equal(got, want, skip=()):
    assert sorted(set(got) - set(skip)) == sorted(set(want) - set(skip))
    for k in want:
        if k not in skip:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("optimizer", list(_OPTIMIZERS))
def test_to_torch_matches_jax_and_restores(tmp_path, optimizer):
    npz = _jax_npz(str(tmp_path / "checkpoint.npz"))
    flags = ["--optimizer", optimizer, "--weight_decay", "1e-3"]
    jconvert_main(["to_torch", "--src", npz, "--dst", str(tmp_path / "jax.tar"), *flags])
    convert_main(["to_torch", "--src", npz, "--dst", str(tmp_path / "port.tar"), *flags])
    got, want = _load_tar(tmp_path / "port.tar"), _load_tar(tmp_path / "jax.tar")
    assert got["epoch"] == want["epoch"] == 5
    assert list(got["state_dict"]) == list(want["state_dict"])
    for k, v in want["state_dict"].items():
        g = got["state_dict"][k]
        assert g.dtype == v.dtype, k
        if k.endswith("num_batches_tracked"):
            # the JAX tar holds this 0 with shape (1,) (np.ascontiguousarray
            # lifts a 0-d array to 1-d); the port's has BatchNorm1d's own
            # shape (), as a tar the reference saves; torch loads either
            assert tuple(g.shape) == () and tuple(v.shape) == (1,) and int(g) == int(v) == 0
        else:
            assert torch.equal(g, v), k
    assert got["optimizer"] == want["optimizer"]
    assert got["optimizer"]["param_groups"][0]["lr"] == 2e-4

    _, cfg = configs(optimizer=optimizer)
    net = Net(cfg)
    net.load_state_dict(want["state_dict"], strict=True)
    net.load_state_dict(got["state_dict"], strict=True)
    assert all(int(v) == 0 for k, v in net.state_dict().items()
               if k.endswith("num_batches_tracked"))
    opt = make_optimizer(cfg, net.parameters())
    assert isinstance(opt, _OPTIMIZERS[optimizer])
    opt.load_state_dict(got["optimizer"])
    assert opt.param_groups[0]["weight_decay"] == 1e-3
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()  # every hyperparameter the class reads is there


def test_to_jax_matches_jax(tmp_path):
    _, cfg = configs()
    tar = str(tmp_path / "weight" / "ae_mse" / "model.pth.tar")
    _reference_tar(tar, cfg)
    jconvert_main(["to_jax", "--src", tar, "--dst", str(tmp_path / "jax.npz")])
    convert_main(["to_jax", "--src", tar, "--dst", str(tmp_path / "port.npz")])
    got, want = _npz(tmp_path / "port.npz"), _npz(tmp_path / "jax.npz")
    _assert_npz_equal(got, want)
    meta = ckpt.load_meta(str(tmp_path / "port.npz"))
    assert meta == {"epoch": 7, "imported_from": os.path.abspath(tar), "lr": 2e-4}
    assert not any(k.startswith("opt/") for k in got)


def test_directory_mode_round_trip(tmp_path):
    """A weight root with two metrics: to_torch, then to_jax, gives every
    params/state leaf back bit for bit, the epoch and the rate; the tars
    restore a port Net that gives the original's forward."""
    _, cfg = configs()
    root = tmp_path / "weight"
    nets = {}
    for i, metric in enumerate(("loss", "ae_mse")):
        tar = str(tmp_path / "ref" / metric / "model.pth.tar")
        nets[metric] = _reference_tar(tar, cfg, seed=10 + i, epoch=3 + i, lr=1e-3 * (i + 1))
        convert_main(["to_jax", "--src", tar, "--dst", str(root / metric / "checkpoint.npz")])
    convert_main(["to_torch", "--src", str(root), "--dst", str(tmp_path / "tars")])
    convert_main(["to_jax", "--src", str(tmp_path / "tars"), "--dst", str(tmp_path / "back")])
    for i, metric in enumerate(("loss", "ae_mse")):
        first = _npz(root / metric / "checkpoint.npz")
        again = _npz(tmp_path / "back" / metric / "checkpoint.npz")
        _assert_npz_equal(again, first, skip=("__meta__",))
        meta = ckpt.load_meta(str(tmp_path / "back" / metric / "checkpoint.npz"))
        assert (meta["epoch"], meta["lr"]) == (3 + i, 1e-3 * (i + 1))
        blob = _load_tar(tmp_path / "tars" / metric / "model.pth.tar")
        net = Net(cfg)
        net.load_state_dict(blob["state_dict"], strict=True)
        for k, v in nets[metric].state_dict().items():
            assert torch.equal(net.state_dict()[k], v), (metric, k)


def test_directory_mode_without_checkpoints_errors(tmp_path):
    (tmp_path / "empty" / "loss").mkdir(parents=True)
    with pytest.raises(SystemExit):
        convert_main(["to_torch", "--src", str(tmp_path / "empty"), "--dst",
                      str(tmp_path / "out")])
