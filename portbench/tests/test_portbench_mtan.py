"""The mTAN cell (`mtan_t354_b256.p1`) on the CPU: a rehearsal is correct,
the TF32 control and each planted fault are not (`faults.py`'s, and
`M1_FAULTS` in the encoder attention's backward), and `mtan_work.py`'s
counts match values worked by hand at small shapes."""

import pytest

from portbench.tests.helpers import core, rehearse

from portbench import mtan_work
from portbench.faults import FAULTS

CELL = "mtan_t354_b256.p1"


def m1_gradient(at: int, scale: float):
    """A fault in M1's backward (`EncoderAttention.backward`): its dQ
    (`at` 0) or dK (`at` 1) times `scale`; planted as `faults.py`'s are."""
    def plant(setattr):
        from deep_interpolation_clustering_tpu_torch.ops import cuda_mtan as cm

        inner = cm.EncoderAttention.backward

        def backward(ctx, g_ob, g_m):
            grads = list(inner(ctx, g_ob, g_m))
            grads[at] = grads[at] * scale
            return tuple(grads)
        setattr(cm.EncoderAttention, "backward", staticmethod(backward))
    return plant


M1_FAULTS = {"dq_zeroed": m1_gradient(0, 0.0), "dq_doubled": m1_gradient(0, 2.0),
             "dk_halved": m1_gradient(1, 0.5)}


def test_a_rehearsal_is_correct():
    run = rehearse(CELL, seed=2190000001)
    assert set(run.checks) == set(run.cell.limits)
    out = core.result(run, "cpu")
    assert out["correct"] is True, run.checks
    assert set(out["rehearsal_metrics"]) == {"p1_enc_per_s", "setup_s"}
    assert run.readings["tag"] == "p1" and run.readings["flops_per_step"] > 0


def test_the_tf32_control_fails():
    run = rehearse(CELL, seed=12, control=True)
    assert core.result(run, "cpu")["correct"] is True
    failed = [k for k, v in run.control.items() if k in run.cell.limits and v > run.cell.limits[k]]
    assert failed, (run.control, run.cell.limits)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    run = rehearse(CELL, seed=13)
    assert core.result(run, "cpu")["correct"] is False
    assert any(c["value"] > c["limit"] for c in run.checks.values()), run.checks


@pytest.mark.parametrize("fault", sorted(M1_FAULTS))
def test_a_broken_attention_backward_is_not_correct(fault, monkeypatch):
    # the fault reaches a few leaves, which the median leaf does not show
    M1_FAULTS[fault](monkeypatch.setattr)
    run = rehearse(CELL, seed=15)
    assert core.result(run, "cpu")["correct"] is False
    check = run.checks["attn_grad_gap"]
    assert check["value"] > check["limit"], run.checks


def test_a_traced_rehearsal_reads_no_device_metric():
    run = rehearse(CELL, seed=14, trace=1)
    metrics = core.result(run, "cpu")["rehearsal_metrics"]
    assert "mtan_attn_roofline.p1" not in metrics and "mtan_attn_share.p1" not in metrics
    assert "step_ms.p1" in metrics  # the spans' reading


def test_work_counts_at_a_small_shape():
    # B=1, C=2, T=3, R=2, E=4, H=2, G=1, L=1; 2 observed slots an encounter
    s = mtan_work.Shapes(b=1, c=2, t=3, r=2, e=4, h=2, g=1, latent=1, obs_per_encounter=2.0)
    heads, pairs = 2, 2 * 2
    n_bytes, flop, expf = mtan_work.attention_forward_work(s)
    assert n_bytes == 4 * (2 * 4 + 2 * 4 + 2 * heads * 3 + 4 * heads * 2)
    assert (flop, expf) == (pairs * (2 * 4 + 6), pairs)
    n_bytes, flop, expf = mtan_work.attention_backward_work(s)
    assert n_bytes == 4 * (2 * 4 + 2 * 4 + 2 * heads * 3 + 5 * heads * 2 + heads * 3 * 4
                           + heads * 3 + 2 * 4)
    assert (flop, expf) == (pairs * (6 * 4 + 8), pairs)
    # the forward: encoder, decoder, classifier, gates and softmaxes
    # (padded slots, the other 4 of C * T = 6, count nothing)
    observed = 2.0
    gru = lambda rows, inp, hid, dirs: dirs * 2 * rows * 6 * hid * (inp + hid)  # noqa: E731
    encoder = (2 * observed * 16 + 2 * 2 * 16 + observed * 2 * (8 + 4) + 2 * 2 * 4 * 2
               + gru(1, 2, 2, 2) + 2 * 2 * (4 * 50 + 50 * 2))
    decoder = gru(1, 1, 1, 2) + 2 * 2 * 16 + observed * 2 * (16 + 8 + 4 + 4 + 100 + 100)
    classifier = gru(1, 1, 2, 1) + 2 * (2 * 300 + 300 * 300 + 300 * 2)
    gates = 2 * 2 * 12 * 2 + 2 * 2 * 12 * 1 + 1 * 2 * 12 * 2
    forward = encoder + decoder + classifier + gates + 5 * observed * 2 + 5 * observed * 2
    assert mtan_work.model_flops(s, train=False) == pytest.approx(forward)
    assert mtan_work.model_flops(s) == pytest.approx(3 * forward)
