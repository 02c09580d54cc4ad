"""Native C++ runtime: golden agreement and exact-solver cross-validation.

The C++ kernels use the reference's exact scalar operation order
(sequential dots), so agreement with the Python golden oracle is expected
at ~1e-13 (np.dot pairwise-vs-sequential ulps), far inside the 1e-6 bar.
Tests are skipped if the toolchain cannot build the library.
"""

import math

import numpy as np
import pytest

from online_convex_optimization.data.sequences import sample_g_batch
from online_convex_optimization.testing.golden import (
    golden_simulate_alg,
    golden_simulate_smart,
)
from online_convex_optimization.utils import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")

ETA0 = math.sqrt(2.0)


@pytest.fixture(scope="module")
def batch():
    return sample_g_batch(0, 150, 6)


@pytest.mark.parametrize("flag", [0, 1])
def test_alg_matches_golden(batch, flag):
    z, y = batch
    got = native.simulate_alg_batch(z, y, flag, ETA0)
    for b in range(z.shape[0]):
        want = golden_simulate_alg(z[b], y[b], flag, ETA0)
        assert got[b] == pytest.approx(want, abs=1e-9)


# NOTE: thresh == 0.5 is deliberately excluded: after round 0, SMART's lead
# is exactly 0.5 +- 1 ulp (unit-clipped first row), so the >= test at 0.5
# is decided by the dot-product summation order — numba-sequential (which
# the C++ kernels reproduce) and np.dot (which the Python golden uses)
# legitimately disagree there.  Real runs use sqrt(2T) or empirical g >> 0.5.
@pytest.mark.parametrize("thresh", [0.8, 2.0, 1e9])
def test_smart_matches_golden(batch, thresh):
    z, y = batch
    got, sw = native.simulate_smart_batch(z, y, thresh, ETA0)
    for b in range(z.shape[0]):
        want, want_sw = golden_simulate_smart(z[b], y[b], thresh, ETA0,
                                              return_switch=True)
        assert got[b] == pytest.approx(want, abs=1e-9)
        assert sw[b] == want_sw


def test_alg_matches_jax_scan(batch):
    """Three-way agreement: C++ golden == JAX x64 scan to 1e-6."""
    from online_convex_optimization.models.linear import simulate_linear_batch
    z, y = batch
    got = native.simulate_alg_batch(z, y, 0, ETA0)
    jx = np.asarray(simulate_linear_batch(z, y, 0, ETA0).regret)
    np.testing.assert_allclose(got, jx, atol=1e-9)


def test_exact_prefix_actions_cross_validates_device_admm(batch):
    """C++ warm-started per-prefix ADMM vs the batched device ADMM."""
    from online_convex_optimization.models.exact_ftl import ExactFTL
    z, y = batch
    z1, y1 = z[0][:60], y[0][:60]
    native_actions = native.exact_prefix_actions(z1, y1, norm="l2",
                                                 allow_linear=False)
    device_actions = ExactFTL(d=5, T_max=60, norm="l2", iters=4000,
                              allow_linear=False).prefix_actions(z1, y1)

    def obj(x, p):
        return 0.5 * np.sum(np.abs(z1[:p] @ x - y1[:p]))

    for p in (1, 5, 20, 40, 60):
        o_native = obj(native_actions[p], p)
        o_device = obj(device_actions[p], p)
        assert o_native == pytest.approx(o_device, abs=2e-5), p


def test_exact_prefix_linf_matches_lp(batch):
    from scipy.optimize import linprog
    z, y = batch
    z1, y1 = z[0][:50], y[0][:50]
    acts = native.exact_prefix_actions(z1, y1, norm="linf",
                                       iters_first=20000, iters_warm=6000,
                                       tol=1e-10, allow_linear=False)
    T, d = z1.shape
    c = np.concatenate([np.zeros(d), 0.5 * np.ones(T)])
    A_ub = np.block([[z1, -np.eye(T)], [-z1, -np.eye(T)]])
    b_ub = np.concatenate([y1, -y1])
    lp = linprog(c, A_ub=A_ub, b_ub=b_ub,
                 bounds=[(-1, 1)] * d + [(0, None)] * T, method="highs")
    obj_lp = 0.5 * np.sum(np.abs(z1 @ lp.x[:d] - y1))
    obj_native = 0.5 * np.sum(np.abs(z1 @ acts[-1] - y1))
    assert obj_native == pytest.approx(obj_lp, abs=1e-4)


def test_exact_prefix_l1_matches_lp(batch):
    """HiGHS LP with the l1-ball split reformulation: x = x+ - x-,
    x+, x- >= 0, sum(x+ + x-) <= 1.  Also asserts feasibility of the
    native output (the l1-projection bug produced ||x||_1 >> 1)."""
    from scipy.optimize import linprog
    z, y = batch
    z1, y1 = z[0][:50], y[0][:50]
    acts = native.exact_prefix_actions(z1, y1, norm="l1",
                                       iters_first=20000, iters_warm=6000,
                                       tol=1e-10, allow_linear=False)
    T, d = z1.shape
    # vars = [x+ (d), x- (d), s (T)]
    c = np.concatenate([np.zeros(2 * d), 0.5 * np.ones(T)])
    A_ub = np.block([
        [z1, -z1, -np.eye(T)],
        [-z1, z1, -np.eye(T)],
        [np.ones((1, d)), np.ones((1, d)), np.zeros((1, T))],
    ])
    b_ub = np.concatenate([y1, -y1, [1.0]])
    lp = linprog(c, A_ub=A_ub, b_ub=b_ub,
                 bounds=[(0, None)] * (2 * d) + [(0, None)] * T,
                 method="highs")
    x_lp = lp.x[:d] - lp.x[d:2 * d]
    obj_lp = 0.5 * np.sum(np.abs(z1 @ x_lp - y1))
    for p in (10, 50):
        assert np.sum(np.abs(acts[p])) <= 1.0 + 1e-8, p
    obj_native = 0.5 * np.sum(np.abs(z1 @ acts[-1] - y1))
    assert obj_native == pytest.approx(obj_lp, abs=1e-4)


def test_certified_prefix_actions_matches_python_twin(batch):
    """Native certified closed form == models/linear_regime (both exact:
    equality to f64 rounding), and declines out-of-contract data."""
    from online_convex_optimization.models.linear_regime import (
        certified_prefix_actions)
    z, y = batch
    # Strictly re-clip in f64 so every prefix certifies a priori.
    z1 = np.array(z[0][:60], np.float64)
    z1 *= (1.0 - 1e-12) / np.maximum(
        1.0, np.linalg.norm(z1, axis=1, keepdims=True))
    y1 = np.asarray(y[0][:60], np.float64)
    nat = native.certified_prefix_actions(z1, y1, norm="l2")
    ref = certified_prefix_actions(z1, y1, "l2")
    assert nat is not None and ref is not None
    np.testing.assert_allclose(nat, ref, atol=1e-13)
    # exact_prefix_actions dispatches to it by default
    via = native.exact_prefix_actions(z1, y1, norm="l2")
    np.testing.assert_allclose(via, nat, atol=0)
    # out of contract: unclipped rows must decline
    rng = np.random.default_rng(3)
    z2 = 3.0 * rng.normal(size=(30, 5))
    y2 = np.sign(z2 @ rng.normal(size=5)); y2[y2 == 0] = 1.0
    assert native.certified_prefix_actions(z2, y2, norm="l2") is None
