"""The work counts against values worked by hand at small shapes."""

import pytest

from portbench.tests.helpers import ROOT  # noqa: F401  (the repo root on the path)

from portbench import work


def test_lstm_work_h2_r2():
    # T=2 steps, B=1 row, H=2: units = 2 directions x 2 steps x 1 x 2 = 8;
    # gates 2*2*1*8 = 32, seqs 2*1*2 = 4, weights 2*2*8 + 2*8 = 48,
    # states 2*2*1*2 = 8; FMAs 8 units x 4H = 64
    n_bytes, flop, expf = work.lstm_work(2, 1, 2, backward=False)
    assert n_bytes == 4 * (32 + 48 + 8 + 16)
    assert flop == 2 * 64 + 14 * 8
    assert expf == 5 * 8
    n_bytes, flop, expf = work.lstm_work(2, 1, 2, backward=True)
    assert n_bytes == 4 * (32 + 48 + 8 + 16 + 16 + 32 + 48 + 8)
    assert flop == 3 * 2 * 64 + 30 * 8
    assert expf == 6 * 8


def test_bound_takes_the_longer_of_bytes_and_operations():
    ms, by = work.bound(3.35e9, 0, 0)  # 3.35 GB at 3.35 TB/s: 1 ms
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = work.bound(0, 67e9, 0)  # 67 GFLOP at 67 TFLOP/s: 1 ms
    assert ms == pytest.approx(1.0) and by == "operations"


def test_kernel_work_at_a_small_shape():
    # one encounter, C=2 channels, T=3 slots, R=2, 4 observed slots
    assert work.select_work(2, 3) == (2 * 3 * 5 + 2 * 8, 0, 0)
    assert work.sci_forward_work(1, 2, 3, 2, 4) == (3 * 6 * 4 + 1 * 2 * 6 * 4, 12 * 2 * 4,
                                                   2 * 2 * 4)
    assert work.rbf_work(1, 2, 3, 2, 4) == (3 * 6 * 4 + 2 * 2 * 4, 7 * 2 * 4, 2 * 4)


def test_model_flops_h2():
    # B=1, C=1, R=1, H=2, head 1, two streams, 1 observed slot an encounter
    s = work.Shapes(b=1, c=1, t=1, r=1, hidden=2, head_hidden=1, streams=2,
                    obs_per_encounter=1.0)
    enc = 2 * 1 * 2 * 2 * (3 + 2) * 8  # R x rows x 2 flop x dirs x (F + H) x 4H
    dec = 2 * 1 * 1 * 2 * (4 + 2) * 8
    heads = 2 * 1 * (4 * 1 + 1 * 1) + 2 * 1 * (4 + 1) + 2 * 2 * 1 * (4 + 2)
    cci = 2 * 2 * 1 * 1
    units = 2 * 2 * 2 + 2 * 1 * 2
    assert work.model_flops(s, train=False) == enc + dec + heads + cci + 14 * units \
        + 12 * 2 + 7
    assert work.model_flops(s) == 3 * (enc + dec + heads + cci) + 44 * units \
        + 12 * 2 + 7 + 23 * 2 + 14
