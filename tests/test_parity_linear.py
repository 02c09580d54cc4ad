"""Parity: FTL/FTRL scan vs the f64 golden oracle (reference semantics).

The bar (BASELINE.md): iterates + cumulative regret within 1e-6 of the
reference Numba implementation on sequence_generation.py families.  The
golden oracle restates those semantics in f64; with x64 enabled the scan
should agree to ~1e-9 or better.
"""

import math

import numpy as np
import pytest

from online_convex_optimization import simulate_alg
from online_convex_optimization.data.sequences import (
    flip_sequence,
    make_noisy_iid_stream,
    make_random_iid_stream,
    sample_g_instance,
    switching_two_leaders_sequence,
)
from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.testing.golden import golden_simulate_alg

ETA0 = math.sqrt(2)
TOL = 1e-6


def _families(T=200):
    fams = {}
    fams["flip"] = flip_sequence(T)[:2]
    fams["switching"] = switching_two_leaders_sequence(T)[:2]
    iid = make_random_iid_stream(d=5, run_seed=2025)
    fams["iid"] = iid(T, rep=0)[:2]
    noisy = make_noisy_iid_stream(p=0.10, d=5, run_seed=4050)
    fams["massart"] = noisy(T, rep=1)[:2]
    fams["g_instance"] = sample_g_instance(0, T, 3)
    return fams


@pytest.mark.parametrize("alg_flag", [0, 1])
@pytest.mark.parametrize("family", ["flip", "switching", "iid", "massart", "g_instance"])
def test_regret_matches_golden(alg_flag, family):
    z, y = _families()[family]
    want = golden_simulate_alg(z, y, alg_flag, ETA0)
    got = simulate_alg(z, y, alg_flag, ETA0)
    assert got == pytest.approx(want, abs=TOL)


def test_batch_matches_singles():
    """One batched scan == per-sequence results, including mixed alg flags."""
    rng = np.random.default_rng(7)
    B, T, d = 6, 150, 5
    z = rng.normal(size=(B, T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    flags = np.array([0, 1, 0, 1, 0, 1])
    etas = np.array([ETA0, ETA0, 0.5, 0.5, 2.0, 2.0])

    res = simulate_linear_batch(z, y, flags, etas)
    for b in range(B):
        want = golden_simulate_alg(z[b], y[b], int(flags[b]), float(etas[b]))
        assert float(res.regret[b]) == pytest.approx(want, abs=TOL)


def test_padded_lengths_match_unpadded():
    """Padding + masking must not perturb regret sums (SURVEY.md §7)."""
    rng = np.random.default_rng(11)
    T_max = 200
    lengths = [50, 125, 200]
    zs, ys = [], []
    for length in lengths:
        z = rng.normal(size=(T_max, 5))
        z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
        z[length:] = 0.0
        y = np.where(rng.random(T_max) < 0.5, -1.0, 1.0)
        zs.append(z)
        ys.append(y)
    z = np.stack(zs)
    y = np.stack(ys)

    res = simulate_linear_batch(z, y, 0, ETA0, np.array(lengths))
    for i, length in enumerate(lengths):
        want = golden_simulate_alg(z[i, :length], y[i, :length], 0, ETA0)
        assert float(res.regret[i]) == pytest.approx(want, abs=TOL)


def test_tie_subgradient_is_exactly_zero():
    """q == y must leave theta untouched (fast_algorithms.py:27-34)."""
    # First round: theta = 0 => x = 0 => q = 0; craft y_0 = 0 impossible
    # (y in ±1), so instead use a z row of zeros: q = 0 = y? Use direct op.
    import jax.numpy as jnp
    from online_convex_optimization.ops.hinge import hinge_subgradient
    assert float(hinge_subgradient(jnp.float64(1.0), jnp.float64(1.0))) == 0.0
    assert float(hinge_subgradient(jnp.float64(2.0), jnp.float64(1.0))) == 0.5
    assert float(hinge_subgradient(jnp.float64(0.0), jnp.float64(1.0))) == -0.5


def test_ftrl_projection_boundary():
    """Projection triggers strictly when ||x||^2 > 1 (fast_algorithms.py:52-66)."""
    import jax.numpy as jnp
    from online_convex_optimization.ops.actions import ftrl_action
    theta = jnp.array([-1.0, 0.0, 0.0], dtype=jnp.float64)
    # t=1, eta0=1: x = theta * -1 = e1, norm exactly 1 -> untouched.
    x = ftrl_action(theta, 1.0, 1.0)
    np.testing.assert_allclose(np.asarray(x), [1.0, 0.0, 0.0], rtol=0)
    # eta0=2: norm 2 -> scaled back to 1.
    x = ftrl_action(theta, 1.0, 2.0)
    assert float(jnp.linalg.norm(x)) == pytest.approx(1.0, abs=1e-15)
