"""Port of p0 (gridding, abnormal-vital targets, the two caches, `cli.p0`)
vs the JAX package, on the CPU.

The raw fixture is the one of `tests/test_p0_raw.py`, copied: 60
encounters, 2-8 records a vital over 7.5 hours, outcome columns. Both
packages' p0 run on the same inputs in two directories; their pickles are
compared key by key (array-equal, same dtypes), the aux CSV byte for byte
and the fingerprint sidecars as strings. No tolerance: p0 is NumPy and
pandas work that both packages do with the same code.
"""

import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest

from deep_interpolation_clustering_tpu import Config as JConfig
from deep_interpolation_clustering_tpu.cli import p0 as jp0
from deep_interpolation_clustering_tpu.data import generate_data as jgenerate_data
from deep_interpolation_clustering_tpu.data.abnormal import (
    extract_abnormal_vitals as jextract_abnormal_vitals,
)
from deep_interpolation_clustering_tpu_torch import Config
from deep_interpolation_clustering_tpu_torch.cli import p0, p1, p2, p3, p4
from deep_interpolation_clustering_tpu_torch.data import generate_data
from deep_interpolation_clustering_tpu_torch.data.abnormal import extract_abnormal_vitals
from deep_interpolation_clustering_tpu_torch.info import COHORTS, USE_FEATURES

PROCESSED = os.path.join("Data", "model_data", "split_processed")
RAW = os.path.join("Data", "model_data", "split_org")
AUX = os.path.join("Data", "next_hour_abnormal_norm_val.csv")
SYNTHETIC = ["--synthetic", "120", "--synthetic_max_obs", "24", "--num_timestamps", "24"]


@pytest.fixture
def raw_dir(tmp_path, rng):
    """The raw fixture of tests/test_p0_raw.py."""
    n = 60
    ids = [f"e{i:03d}" for i in range(n)]
    encounter = pd.DataFrame({
        "encounter_deiden_id": ids,
        "AKI_overall": rng.randint(0, 2, n),
        "mort_status_30d": rng.randint(0, 2, n),
    })
    vitals = {}
    for v in USE_FEATURES:
        rows = []
        for e in ids:
            k = rng.randint(2, 9)
            for t in sorted(rng.rand(k) * 7.5):  # includes hour 6-7 records
                rows.append((e, t, rng.rand() * 50 + 60))
        vitals[v] = pd.DataFrame(
            rows, columns=["encounter_deiden_id", "time_stamp", "measurement"]
        )
    split_ids = {
        "training": ids[:40], "validation": ids[40:50], "testing": ids[50:],
    }
    d = tmp_path / "raw"
    d.mkdir()
    encounter.to_csv(d / "encounter.csv", index=False)
    with open(d / "vitals.pickle", "wb") as f:
        pickle.dump(vitals, f)
    with open(d / "split_ids.pickle", "wb") as f:
        pickle.dump(split_ids, f)
    return str(d)


def _load(folder):
    out = {}
    for cohort in COHORTS:
        with open(os.path.join(folder, f"{cohort}.pickle"), "rb") as f:
            out[cohort] = pickle.load(f)
    return out


def _assert_splits_equal(got, want):
    assert set(got) == set(want)
    for cohort in want:
        assert set(got[cohort]) == set(want[cohort]), cohort
        for k, v in want[cohort].items():
            g = got[cohort][k]
            if isinstance(v, np.ndarray):
                assert g.dtype == v.dtype, (cohort, k)
                np.testing.assert_array_equal(g, v, err_msg=f"{cohort}/{k}")
            else:
                assert list(g) == list(v), (cohort, k)


def _read(path, mode="r"):
    with open(path, mode) as f:
        return f.read()


def _mtimes(root):
    return {os.path.join(d, f): os.path.getmtime(os.path.join(root, d, f))
            for d in (PROCESSED, RAW) if os.path.isdir(os.path.join(root, d))
            for f in os.listdir(os.path.join(root, d))}


def _run(main, root, monkeypatch, argv):
    root.mkdir(exist_ok=True)
    monkeypatch.chdir(root)
    main(argv)


def test_generate_data_and_abnormal_vitals_match_jax(raw_dir):
    with open(os.path.join(raw_dir, "vitals.pickle"), "rb") as f:
        vitals = pickle.load(f)
    with open(os.path.join(raw_dir, "split_ids.pickle"), "rb") as f:
        split_ids = pickle.load(f)
    encounter = pd.read_csv(os.path.join(raw_dir, "encounter.csv"))
    six_hours = {k: df[df["time_stamp"] <= 6] for k, df in vitals.items()}
    for cohort in COHORTS:
        for max_length in (None, 3):
            got = generate_data(split_ids[cohort], six_hours, max_length)
            want = jgenerate_data(split_ids[cohort], six_hours, max_length)
            _assert_splits_equal({cohort: got}, {cohort: want})
    got = extract_abnormal_vitals(vitals, encounter, 6)
    want = jextract_abnormal_vitals(vitals, encounter, 6)
    assert list(got.columns) == list(want.columns)
    assert got[list(USE_FEATURES)].isna().values.any()  # unobserved hour-7 vitals
    pd.testing.assert_frame_equal(got, want, check_exact=True)


@pytest.mark.parametrize("source", ["synthetic", "raw"])
def test_cli_p0_writes_what_jax_writes(tmp_path, raw_dir, monkeypatch, source):
    """Every pickle of split_processed and split_org key by key, the aux CSV
    byte for byte, the p0.fp and p0_raw.fp strings."""
    argv = SYNTHETIC if source == "synthetic" else ["--raw_dir", raw_dir]
    _run(jp0.main, tmp_path / "jax", monkeypatch, argv)
    _run(p0.main, tmp_path / "port", monkeypatch, argv)
    jroot, root = tmp_path / "jax", tmp_path / "port"
    for folder, sidecar in ((PROCESSED, "p0.fp"), (RAW, "p0_raw.fp")):
        _assert_splits_equal(_load(root / folder), _load(jroot / folder))
        assert _read(root / folder / sidecar) == _read(jroot / folder / sidecar)
    if source == "raw":
        assert _read(root / AUX, "rb") == _read(jroot / AUX, "rb")
        assert "future_vital" in _load(root / PROCESSED)["training"]
    else:
        assert not (root / AUX).exists()


# what each run changes, and which stage it must recompute
_CACHE_CASES = {
    # identical inputs: nothing rewritten
    "skip": ([], False, False),
    # a preprocessing knob: the processed pickles again, the raw slices reused
    "config_change": (["--holdout_frac", "0.3"], True, False),
    # other raw bytes: both stages again
    "source_change": ("source", True, True),
    # no sidecar beside the pickles: recompute them, never trust existence
    "sidecar_missing": ("sidecar", True, False),
    # no aux CSV: the raw stage that writes it runs again
    "aux_missing": ("aux", True, True),
}


@pytest.mark.parametrize("case", list(_CACHE_CASES))
def test_p0_caches(tmp_path, raw_dir, monkeypatch, case):
    """The cache cases of tests/test_p0_raw.py on the port's p0; the
    gridding is replaced by a failure wherever the raw cache must serve."""
    change, processed_again, raw_again = _CACHE_CASES[case]
    argv = ["--raw_dir", raw_dir]
    _run(p0.main, tmp_path / "run", monkeypatch, argv)
    before = _mtimes(tmp_path / "run")
    extra = []
    if change == "source":
        with open(os.path.join(raw_dir, "encounter.csv"), "a") as f:
            f.write("\n")
    elif change == "sidecar":
        os.remove(os.path.join(PROCESSED, "p0.fp"))
    elif change == "aux":
        os.remove(AUX)
    else:
        extra = change
    if not raw_again:
        def boom(*a, **k):
            raise AssertionError("generate_data ran despite a valid raw cache")
        monkeypatch.setattr(p0, "generate_data", boom)
    p0.main(argv + extra)
    after = _mtimes(tmp_path / "run")
    pkl = os.path.join(PROCESSED, "training.pickle")
    org = os.path.join(RAW, "training.pickle")
    assert (after[pkl] > before[pkl]) == processed_again
    assert (after[org] > before[org]) == raw_again
    assert os.path.exists(os.path.join(PROCESSED, "p0.fp")) and os.path.exists(AUX)
    if case == "config_change":
        tr = _load(PROCESSED)["training"]
        assert tr["padding_mask"].sum() > tr["drop_mask"].sum()


def test_p0_synthetic_raw_cache_keys_on_the_seed(tmp_path, monkeypatch):
    _run(p0.main, tmp_path / "run", monkeypatch, SYNTHETIC)
    org = os.path.join(RAW, "training.pickle")
    t0 = os.path.getmtime(org)

    def boom(*a, **k):
        raise AssertionError("make_synthetic_cohorts ran despite the raw cache")

    monkeypatch.setattr(p0, "make_synthetic_cohorts", boom)
    p0.main(SYNTHETIC + ["--holdout_frac", "0.3"])
    assert os.path.getmtime(org) == t0
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path / "run")
    p0.main(SYNTHETIC + ["--seed", "99"])
    assert os.path.getmtime(org) > t0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_cache_written_by_either_package_is_a_hit_for_the_other(
        tmp_path, raw_dir, monkeypatch, writer):
    """The processed cache: nothing rewritten; after a hold-out change the
    raw slices the other package wrote are reused (no gridding)."""
    first, second = (jp0, p0) if writer == "jax" else (p0, jp0)
    argv = ["--raw_dir", raw_dir]
    _run(first.main, tmp_path / "run", monkeypatch, argv)
    before = _mtimes(tmp_path / "run")

    def boom(*a, **k):
        raise AssertionError("gridded again despite the other package's cache")

    monkeypatch.setattr(second, "generate_data", boom)
    second.main(argv)
    assert _mtimes(tmp_path / "run") == before
    second.main(argv + ["--holdout_frac", "0.3"])
    after = _mtimes(tmp_path / "run")
    pkl, org = (os.path.join(d, "training.pickle") for d in (PROCESSED, RAW))
    assert after[pkl] > before[pkl] and after[org] == before[org]


def test_p0_rank_gate(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        p0.main(SYNTHETIC + ["--num_processes", "2"])
    p0.main(SYNTHETIC + ["--num_processes", "2", "--process_id", "1"])
    assert not os.path.exists("Data")
    p0.main(SYNTHETIC + ["--num_processes", "2", "--process_id", "0"])
    assert os.path.exists(os.path.join(PROCESSED, "p0.fp"))


@pytest.mark.parametrize("stage", [p1, p2, p3, p4], ids=["p1", "p2", "p3", "p4"])
def test_later_stages_refuse_more_than_one_process(tmp_path, monkeypatch, stage):
    """More than one process is a multi-process launch now: `--num_processes
    2` without `--process_id`, `--coordinator_address` or torchrun's env://
    variables is refused, naming the missing flag and variables, before
    anything is written."""
    monkeypatch.chdir(tmp_path)
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=r"--process_id.*MASTER_ADDR, MASTER_PORT"):
        stage.main(["--num_processes", "2"], device="cpu")
    assert os.listdir(tmp_path) == []


def test_config_keeps_the_process_fields_out_of_config_json(tmp_path):
    """As the JAX `Config`: `save` leaves them out, `load` drops them from a
    file that has them, and a JAX config.json round-trips."""
    cfg = Config(num_processes=2, process_id=1, coordinator_address="10.0.0.1:8476",
                 data_parallel=2, fused_heads=True, rng_draw_bits=16)
    path = cfg.save(str(tmp_path))
    with open(path) as f:
        saved = json.load(f)
    assert not {"num_processes", "process_id", "coordinator_address"} & set(saved)
    assert saved["fused_heads"] is True and saved["rng_draw_bits"] == 16
    assert saved["data_parallel"] == 2
    back = Config.load(path)
    assert (back.num_processes, back.process_id, back.coordinator_address,
            back.data_parallel, back.fused_heads) == (0, -1, "", 2, True)
    jcfg = JConfig.load(path)
    assert jcfg.fused_heads and jcfg.rng_draw_bits == 16 and jcfg.data_parallel == 2
    with open(path, "w") as f:
        json.dump(dict(saved, num_processes=4, process_id=3,
                       coordinator_address="10.0.0.1:8476"), f)
    again = Config.load(path)
    assert (again.num_processes, again.coordinator_address) == (0, "")
    jpath = JConfig(fused_heads=True, num_processes=2, process_id=0,
                    coordinator_address="10.0.0.1:8476").save(str(tmp_path), "jax")
    assert Config.load(jpath).fused_heads and Config.load(jpath).coordinator_address == ""
