"""Regret-theory property tests (SURVEY §4: known bounds as oracles).

These are coarse invariants from online-learning theory, not parity
checks: they catch sign/scale regressions that exact-parity tests on
fixed seeds could miss only if the golden oracle broke identically.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from online_convex_optimization.data.sequences import CASES
from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.models.smart import simulate_smart_batch


def _random_batch(B, T, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, 5))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    return jnp.asarray(z), jnp.asarray(y)


@pytest.mark.parametrize("T", [128, 512])
def test_ftrl_regret_obeys_sqrtT_bound(T):
    """FTRL (eta0 = sqrt(2)) regret is O(sqrt(T)): with ||z|| <= 1 the
    subgradient is bounded by 1/2 and the ball diameter is 2, giving
    R_T <= (D^2/(2 eta) + eta G^2) sqrt(T) < 2 sqrt(T).  The empirical
    worst case sits near sqrt(T/pi) (the reference's theory overlay)."""
    z, y = _random_batch(B=64, T=T, seed=T)
    regs = np.asarray(simulate_linear_batch(z, y, 0, math.sqrt(2.0)).regret)
    assert regs.max() <= 2.0 * math.sqrt(T)
    # ... and it is a REGRET (comparator can make it negative only
    # slightly through fp error, not structurally).
    assert regs.min() >= -1e-3


@pytest.mark.parametrize("T", [100, 400])
def test_smart_regret_obeys_switch_bound(T):
    """SMART's design guarantee: regret <= threshold + post-switch FTRL
    regret + O(1).  With threshold sqrt(2T) and the sqrt-T FTRL bound the
    total stays within (2 + sqrt(2) + eps) sqrt(T)."""
    z, y = _random_batch(B=64, T=T, seed=1000 + T)
    B = z.shape[0]
    th = jnp.full((B,), math.sqrt(2.0 * T), jnp.float32)
    et = jnp.full((B,), math.sqrt(2.0), jnp.float32)
    regs = np.asarray(simulate_smart_batch(z, y, th, et).regret)
    assert regs.max() <= (2.0 + math.sqrt(2.0) + 0.5) * math.sqrt(T)


def test_sublinear_regret_on_stochastic_families():
    """On the two stochastic registry families every algorithm except the
    adversarially-breakable FTL keeps regret within the sqrt-T envelope
    (the reference's figures show exactly this separation)."""
    T = 400
    for title in ("Random i.i.d. (separable)", "Massart noise 10%"):
        sampler = CASES[title](run_seed=2025)
        z, y, _ = sampler(T, rep=0)
        zb = jnp.asarray(z)[None]
        yb = jnp.asarray(y)[None]
        ftrl = float(simulate_linear_batch(zb, yb, 0,
                                           math.sqrt(2.0)).regret[0])
        smart = float(simulate_smart_batch(
            zb, yb, jnp.full((1,), math.sqrt(2.0 * T), jnp.float32),
            jnp.full((1,), math.sqrt(2.0), jnp.float32)).regret[0])
        bound = 3.5 * math.sqrt(T)
        assert 0.0 <= ftrl <= bound, title
        assert -1e-3 <= smart <= bound, title


def test_ftl_breaks_on_flip_family_but_ftrl_does_not():
    """The Label-flips family exists to break FTL (linear regret) while
    FTRL stays O(sqrt(T)) — the separation the reference's figures show.
    This pins the ADVERSARIAL behavior, not just parity."""
    sampler = CASES["Label flips"](run_seed=0)
    regs = {}
    for T in (200, 800):
        z, y, _ = sampler(T, rep=0)
        zb, yb = jnp.asarray(z)[None], jnp.asarray(y)[None]
        ftl = float(simulate_linear_batch(zb, yb, 1, math.sqrt(2.0)).regret[0])
        ftrl = float(simulate_linear_batch(zb, yb, 0,
                                           math.sqrt(2.0)).regret[0])
        regs[T] = (ftl, ftrl)
        assert ftrl <= 2.0 * math.sqrt(T)
    # FTL regret grows ~linearly: quadrupling T must far more than double it.
    assert regs[800][0] >= 3.0 * regs[200][0]
    assert regs[800][0] >= 0.2 * 800          # linear-rate floor (measured: T/4)


def test_actions_stay_in_the_ball():
    """Trajectory feasibility: the last played action of every algorithm
    lies in the unit L2 ball."""
    z, y = _random_batch(B=16, T=64, seed=7)
    for flag in (0, 1):
        res = simulate_linear_batch(z, y, flag, 1.7)
        norms = np.linalg.norm(np.asarray(res.x_last), axis=-1)
        assert (norms <= 1.0 + 1e-6).all(), flag
