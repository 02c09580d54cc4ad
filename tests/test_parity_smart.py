"""Parity: SMART (two-scan + prefix matmul) vs the f64 golden oracle.

The critical property: the dataflow decomposition (Phase A/B/C in
models/smart.py) must reproduce the reference's sequential
switch-and-recompute loop exactly — including the switch round itself.
"""

import math

import numpy as np
import pytest

from online_convex_optimization import simulate_SMART, simulate_SMART_like
from online_convex_optimization.data.sequences import (
    flip_sequence,
    make_noisy_iid_stream,
    make_random_iid_stream,
    sample_g_instance,
    switching_two_leaders_sequence,
)
from online_convex_optimization.models.smart import simulate_smart, simulate_smart_batch
from online_convex_optimization.testing.golden import golden_simulate_smart

ETA0 = math.sqrt(2)
TOL = 1e-6


def _cases(T=200):
    cases = {}
    cases["flip"] = flip_sequence(T)[:2]
    cases["switching"] = switching_two_leaders_sequence(T)[:2]
    cases["iid"] = make_random_iid_stream(d=5, run_seed=2025)(T, rep=0)[:2]
    cases["massart"] = make_noisy_iid_stream(p=0.10, d=5, run_seed=4050)(T, rep=2)[:2]
    cases["g_instance"] = sample_g_instance(0, T, 5)
    return cases


@pytest.mark.parametrize("family", ["flip", "switching", "iid", "massart", "g_instance"])
def test_smart_sqrt2T_matches_golden(family):
    z, y = _cases()[family]
    T = z.shape[0]
    want = golden_simulate_smart(z, y, math.sqrt(2 * T), ETA0)
    got = simulate_SMART(z, y)
    assert got == pytest.approx(want, abs=TOL)


# NOTE: thresh == 0.5 is deliberately excluded here and below: after round 0
# SMART's lead is exactly 0.5 +- 1 ulp, so the >= test at 0.5 is decided by
# floating-point association order — the golden recompute and the identity-
# based prefix statistic (models/smart.py docstring) legitimately disagree
# there.  Same policy as tests/test_native.py; real runs use sqrt(2T) or
# empirical g >> 0.5.
@pytest.mark.parametrize("thresh", [0.0, 0.75, 2.0, 10.0, 1e9])
def test_smart_threshold_sweep_matches_golden(thresh):
    """Low thresholds force early switches; 1e9 never switches."""
    z, y = _cases(T=150)["massart"]
    want, want_switch = golden_simulate_smart(z, y, thresh, ETA0, return_switch=True)
    res = simulate_smart(np.asarray(z, np.float64), np.asarray(y, np.float64),
                         thresh, ETA0)
    assert float(res.regret) == pytest.approx(want, abs=TOL)
    assert int(res.switch_t) == want_switch


def test_smart_like_api(T=120):
    z, y = _cases(T)["iid"]
    want = golden_simulate_smart(z, y, 3.0, 0.7)
    got = simulate_SMART_like(z, y, 3.0, 0.7)
    assert got == pytest.approx(want, abs=TOL)


def test_smart_batch_matches_singles():
    rng = np.random.default_rng(3)
    B, T, d = 5, 130, 5
    z = rng.normal(size=(B, T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    thresh = np.array([0.75, 1.0, 2.0, 5.0, math.sqrt(2 * T)])  # 0.5: see note above
    res = simulate_smart_batch(z, y, thresh, ETA0)
    for b in range(B):
        want, want_switch = golden_simulate_smart(
            z[b], y[b], float(thresh[b]), ETA0, return_switch=True)
        assert float(res.regret[b]) == pytest.approx(want, abs=TOL)
        assert int(res.switch_t[b]) == want_switch


def test_smart_padded_lengths():
    rng = np.random.default_rng(17)
    T_max = 160
    lengths = [40, 100, 160]
    z = rng.normal(size=(len(lengths), T_max, 5))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((len(lengths), T_max)) < 0.5, -1.0, 1.0)
    for i, length in enumerate(lengths):
        z[i, length:] = 0.0
    res = simulate_smart_batch(z, y, 2.0, ETA0, np.array(lengths))
    for i, length in enumerate(lengths):
        want = golden_simulate_smart(z[i, :length], y[i, :length], 2.0, ETA0)
        assert float(res.regret[i]) == pytest.approx(want, abs=TOL)


def test_block_size_invariance():
    """Prefix-loss blocking is an implementation detail, not semantics."""
    z, y = _cases(T=150)["g_instance"]
    r64 = simulate_smart(z, y, 1.0, ETA0, block_size=64)
    r150 = simulate_smart(z, y, 1.0, ETA0, block_size=150)
    r7 = simulate_smart(z, y, 1.0, ETA0, block_size=7)
    assert float(r64.regret) == pytest.approx(float(r150.regret), abs=1e-12)
    assert float(r7.regret) == pytest.approx(float(r150.regret), abs=1e-12)
