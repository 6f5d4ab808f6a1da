"""Row-sharded cohort storage (`parallel.cohort.ShardedCohort`, the JAX
`parallel/cohort.py`) on the CPU, two gloo ranks in one spawn:

  * against JAX `ShardedCohort` on `make_mesh(2)` (the conftest's virtual
    CPU devices), built from the same arrays and taken through the same
    orders (an epoch shuffle with a ragged tail, a second shuffle, back to
    the identity): each rank's block storage equals JAX's shard r exactly
    (both are copies), and so do `epoch_order`, `identity_order` and
    `eval_mask`; `nbytes_per_device` is ceil(n/B) * B/D rows' worth;
  * the trainers: p1 (`cli.p1`'s body, two epochs over a training cohort
    with a ragged tail whose padded share is rank 1's) and then p3 (two DEC
    epochs from that run) at two ranks with `shard_cohort` true and false:
    checkpoints, dumps and summary rows the same bits.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from deep_interpolation_clustering_tpu.parallel import make_mesh
from deep_interpolation_clustering_tpu.parallel.cohort import ShardedCohort as JShardedCohort
from deep_interpolation_clustering_tpu_torch import Config, parallel
from deep_interpolation_clustering_tpu_torch.cli import p1 as cli_p1
from deep_interpolation_clustering_tpu_torch.cli import p3 as cli_p3
from deep_interpolation_clustering_tpu_torch.cli.common import save_processed
from deep_interpolation_clustering_tpu_torch.data import make_synthetic_cohorts, process_splits
from deep_interpolation_clustering_tpu_torch.info import COHORTS, METRICS
from deep_interpolation_clustering_tpu_torch.parallel.cohort import ShardedCohort

torch.set_num_threads(1)

D = 2
B, T, H = 8, 16, 16
SPAWN_TIMEOUT_S = 300
N_ROWS = 21  # 2 full blocks of 8 and a 5-row tail


def _arrays():
    rng = np.random.RandomState(3)
    return {"ob": rng.randn(N_ROWS, 3, 5).astype(np.float32),
            "mask": (rng.rand(N_ROWS, 3, 5) > 0.5).astype(np.float32),
            "label": rng.rand(N_ROWS).astype(np.float32)}


def _orders():
    rng = np.random.RandomState(4)
    return [rng.permutation(N_ROWS), rng.permutation(N_ROWS)]


def _cfg(root, shard, **kw):
    return Config(batch_size=B, num_timestamps=T, lstm_hidden=H, head_hidden=H,
                  aux_tasks={"future_vital": 0.5}, max_epochs=3, early_stopping=100,
                  base_path=os.path.join(root, "Data"), shard_cohort=shard,
                  results_path=os.path.join(root, "sharded" if shard else "replicated"), **kw)


def _storage(c):
    return {k: v.numpy().copy() for k, v in c.data3.items()}


def _rank(r, address, root):
    parallel.initialize(address, D, r, "cpu", "gloo", timeout_s=SPAWN_TIMEOUT_S)
    try:
        c = ShardedCohort(_arrays(), B, torch.device("cpu"))
        seen = {"nbytes": c.nbytes_per_device(), "identity": c.identity_order(),
                "eval_mask": c.eval_mask, "stages": [_storage(c)], "epoch_orders": []}
        for order in _orders():
            tgt = c.epoch_order(order)
            seen["epoch_orders"].append(tgt)
            c.ensure(tgt)
            seen["stages"].append(_storage(c))
        c.ensure(c.identity_order())
        seen["stages"].append(_storage(c))
        before = c.data3
        c.ensure(c.identity_order())  # unchanged: no relayout
        seen["unchanged_kept"] = c.data3 is before
        for shard in (True, False):
            cfg = _cfg(root, shard)
            pre = cli_p1._run(cfg, torch.device("cpu"))
            cli_p3._run(cfg.replace(loss="ae_mse_sup_fake_detect_kl", cluster_number=3,
                                    kmeans_n_init=3, stopping_delta=0.0),
                        torch.device("cpu"), pretrain_path=pre)
        return seen
    finally:
        parallel.shutdown()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cohort"))
    cohorts = process_splits(make_synthetic_cohorts(n_total=80, max_obs=T, seed=9),
                             rng=np.random.RandomState(0))
    sizes = {"training": 2 * B + 5, "validation": B + 5, "testing": 6}
    cohorts = {c: {k: v[:sizes[c]] for k, v in cohorts[c].items()} for c in COHORTS}
    save_processed(Config(base_path=os.path.join(root, "Data")), cohorts)
    address = f"127.0.0.1:{parallel.free_port()}"
    ranks = parallel.spawn(_rank, D, (address, root), timeout_s=SPAWN_TIMEOUT_S)
    return dict(root=root, ranks=ranks)


def _jax_stages():
    jc = JShardedCohort(make_mesh(D), _arrays(), B)
    stages = [jax.device_get(jc.data3)]
    for order in _orders():
        jc.ensure(jc.epoch_order(order))
        stages.append(jax.device_get(jc.data3))
    jc.ensure(jc.identity_order())
    stages.append(jax.device_get(jc.data3))
    return jc, stages


def test_block_storage_equals_jax_shards(run):
    jc, stages = _jax_stages()
    pb = B // D
    for r, seen in enumerate(run["ranks"]):
        assert len(seen["stages"]) == len(stages)
        for i, (got, want) in enumerate(zip(seen["stages"], stages)):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], np.asarray(want[k])[:, r * pb:(r + 1) * pb],
                                              err_msg=f"rank {r} stage {i} {k}")
        assert seen["unchanged_kept"]


def test_orders_and_masks_equal_jax(run):
    jc = JShardedCohort(make_mesh(D), _arrays(), B)
    for seen in run["ranks"]:
        np.testing.assert_array_equal(seen["identity"], jc.identity_order())
        np.testing.assert_array_equal(seen["eval_mask"], jc.eval_mask)
        for got, order in zip(seen["epoch_orders"], _orders()):
            np.testing.assert_array_equal(got, jc.epoch_order(order))


def test_nbytes_per_device_is_a_share_of_the_blocks(run):
    arrays = _arrays()
    row_bytes = sum(v[0].nbytes for v in arrays.values())
    want = -(-N_ROWS // B) * (B // D) * row_bytes
    for seen in run["ranks"]:
        assert seen["nbytes"] == want
    assert want < sum(v.nbytes for v in arrays.values())


def _run_files(exp):
    out = {}
    for m in METRICS:
        path = os.path.join(exp, "weight", m, "checkpoint.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                out[("ckpt", m)] = {k: z[k] for k in z.files}
        for cohort in COHORTS:
            path = os.path.join(exp, "out_feat", m, f"{cohort}.npy")
            if os.path.exists(path):
                out[("dump", m, cohort)] = np.load(path, allow_pickle=True).item()
    with open(os.path.join(exp, "summary", "events.jsonl")) as f:
        out["rows"] = [json.loads(line) for line in f]
    return out


@pytest.mark.parametrize("stage", ["Pretrain", "Clustering"])
def test_sharded_trainers_are_the_replicated_bits(run, stage):
    got = _run_files(os.path.join(run["root"], "sharded", stage))
    want = _run_files(os.path.join(run["root"], "replicated", stage))
    assert got.keys() == want.keys()
    assert len([k for k in want if k[0] == "ckpt"]) >= 2
    assert len([k for k in want if k[0] == "dump"]) == 3 * (2 if stage == "Pretrain" else 3)
    assert got["rows"] == want["rows"] and want["rows"]
    for k in want:
        if k == "rows":
            continue
        assert got[k].keys() == want[k].keys()
        for name in want[k]:
            np.testing.assert_array_equal(np.asarray(got[k][name]), np.asarray(want[k][name]),
                                          err_msg=f"{stage} {k} {name}")
