"""Exact-FTL oracle: cross-validation against independent solvers.

The reference solves these programs with CVXPY/ECOS (exact_ftl.py:119-128).
Neither is in this image, so correctness is established against:
  - scipy HiGHS on the LP reformulation (exact for linf/l1 balls);
  - scipy SLSQP multi-start for the l2 ball (smooth-solver agreement);
  - internal consistency: all-prefix solve vs single full solve.
"""

import numpy as np
import pytest
from scipy.optimize import linprog, minimize

from online_convex_optimization.models.exact_ftl import (
    ExactFTL,
    replay_exact_ftl,
    run_ftl_exact,
    run_ftrl,
    simulate,
)


def _instance(T=60, d=5, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    y = np.sign(z @ u + noise * rng.normal(size=T))
    return z, y


def _obj(z, y, x):
    return 0.5 * np.sum(np.abs(z @ x - y))


def _lp_solve(z, y, norm):
    """Exact LP solution for linf (box) and l1 (cross-polytope) balls."""
    T, d = z.shape
    if norm == "linf":
        c = np.concatenate([np.zeros(d), 0.5 * np.ones(T)])
        A_ub = np.block([[z, -np.eye(T)], [-z, -np.eye(T)]])
        b_ub = np.concatenate([y, -y])
        bounds = [(-1, 1)] * d + [(0, None)] * T
        res = linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")
        return res.x[:d]
    if norm == "l1":
        # x = p - n with p, n >= 0 and sum(p + n) <= 1.
        c = np.concatenate([np.zeros(2 * d), 0.5 * np.ones(T)])
        A_res = np.block([[z, -z, -np.eye(T)], [-z, z, -np.eye(T)]])
        b_res = np.concatenate([y, -y])
        A_l1 = np.concatenate([np.ones(2 * d), np.zeros(T)])[None, :]
        A_ub = np.vstack([A_res, A_l1])
        b_ub = np.concatenate([b_res, [1.0]])
        bounds = [(0, None)] * (2 * d + T)
        res = linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")
        return res.x[:d] - res.x[d:2 * d]
    raise ValueError(norm)


@pytest.mark.parametrize("norm", ["linf", "l1"])
def test_full_solve_matches_highs_lp(norm):
    """Active-set-polished solves match the interior-point-grade HiGHS
    objective to 1e-8 (the reference's ECOS-level accuracy bar)."""
    z, y = _instance()
    solver = ExactFTL(d=5, T_max=60, norm=norm, iters=8000, rho=3.0,
                      allow_linear=False)
    x = solver.solve_full(z, y)
    x_lp = _lp_solve(z, y, norm)
    assert _obj(z, y, x) <= _obj(z, y, x_lp) + 1e-8


def test_full_solve_matches_slsqp_l2():
    z, y = _instance(seed=1)
    solver = ExactFTL(d=5, T_max=60, norm="l2", iters=3000,
                      allow_linear=False)
    x = solver.solve_full(z, y)
    best = None
    rng = np.random.default_rng(2)
    for _ in range(4):
        r = minimize(lambda v: _obj(z, y, v), 0.1 * rng.normal(size=5),
                     constraints=[{"type": "ineq",
                                   "fun": lambda v: 1 - np.dot(v, v)}],
                     method="SLSQP", options={"maxiter": 500, "ftol": 1e-12})
        if best is None or r.fun < best.fun:
            best = r
    # One-sided at 1e-8: the polished solve may legitimately BEAT SLSQP.
    assert _obj(z, y, x) <= best.fun + 1e-8
    assert np.linalg.norm(x) <= 1.0 + 1e-9


@pytest.mark.parametrize("norm", ["linf", "l1"])
def test_all_prefixes_match_highs_lp(norm):
    """Every 5th prefix of the batched+polished trajectory vs HiGHS, 1e-8."""
    z, y = _instance(T=40, seed=8)
    solver = ExactFTL(d=5, T_max=40, norm=norm, iters=6000, rho=3.0,
                      allow_linear=False)
    actions = solver.prefix_actions(z, y)
    for p in range(5, 41, 5):
        obj_p = _obj(z[:p], y[:p], actions[p])
        obj_lp = _obj(z[:p], y[:p], _lp_solve(z[:p], y[:p], norm))
        assert obj_p <= obj_lp + 1e-8, p


def test_prefix_actions_consistent_with_full():
    z, y = _instance(T=40, seed=3)
    solver = ExactFTL(d=5, T_max=40, norm="l2", iters=3000,
                      allow_linear=False)
    actions = solver.prefix_actions(z, y)
    assert actions.shape == (41, 5)
    np.testing.assert_allclose(actions[0], 0.0)
    x_full = solver.solve_full(z, y)
    assert _obj(z, y, actions[-1]) == pytest.approx(_obj(z, y, x_full),
                                                    abs=1e-8)
    # Each prefix action is feasible and (weakly) beats the full-solution
    # restricted to that prefix.
    for p in (1, 10, 25, 40):
        xp = actions[p]
        assert np.linalg.norm(xp) <= 1.0 + 1e-9
        obj_p = 0.5 * np.sum(np.abs(z[:p] @ xp - y[:p]))
        obj_full = 0.5 * np.sum(np.abs(z[:p] @ x_full - y[:p]))
        assert obj_p <= obj_full + 1e-8


def test_replay_and_regret_shapes():
    z, y = _instance(T=30, seed=4)
    res, actions = run_ftl_exact(z, y, iters=1500, return_actions=True)
    # Replaying the same actions reproduces the result.
    res2 = replay_exact_ftl(z, y, actions)
    assert res.cum_loss == pytest.approx(res2.cum_loss, abs=1e-12)
    # FTRL against the shared comparator: both use actions[-1].
    ftrl = run_ftrl(z, y, eta0=np.sqrt(2), comparator_action=actions[-1])
    assert ftrl.comp_loss == pytest.approx(res.comp_loss, abs=1e-9)
    # Exact FTL should never have (much) higher regret than FTRL here.
    assert res.regret <= ftrl.regret + 1e-6


def test_simulate_front_end_dispatch():
    z, y = _instance(T=25, seed=5)
    r1 = simulate(z, y, algo="ftl_exact")
    r2 = simulate(z, y, algo="ftrl", eta0=1.0)
    assert np.isfinite(r1.regret) and np.isfinite(r2.regret)
    with pytest.raises(ValueError):
        simulate(z, y, algo="nope")


def test_incremental_surface_matches_batch():
    """Warm-started append_row / solve_prefix agree with the all-prefix
    batch solve to polished (1e-8) accuracy."""
    z, y = _instance(T=20, seed=7)
    solver = ExactFTL(d=5, T_max=20, norm="l2", iters=2000,
                      allow_linear=False)
    actions = solver.prefix_actions(z, y)
    solver.reset_buffers()
    for t in range(6):
        x_inc = solver.append_row(z[t], float(y[t]))
        obj_inc = 0.5 * np.sum(np.abs(z[:t + 1] @ x_inc - y[:t + 1]))
        obj_bat = 0.5 * np.sum(np.abs(z[:t + 1] @ actions[t + 1] - y[:t + 1]))
        assert obj_inc == pytest.approx(obj_bat, abs=1e-8)
    x_pref = solver.solve_prefix(z[:10], y[:10])
    x_pref2 = solver.solve_prefix_from_full(z, y, 10)
    np.testing.assert_allclose(x_pref, x_pref2, atol=1e-9)
    with pytest.raises(ValueError):
        solver.solve_prefix(z[:5, :3], y[:5])


def test_append_row_warm_start_is_cheap_and_accurate():
    """The warm path (warm_iters << iters) stays 1e-8-accurate over a full
    append loop — the reference's solve-many design (exact_ftl.py:140-149)."""
    z, y = _instance(T=30, seed=9)
    solver = ExactFTL(d=5, T_max=30, norm="l2", iters=2000, warm_iters=80,
                      allow_linear=False)
    batch_actions = ExactFTL(d=5, T_max=30, norm="l2", iters=3000,
                             allow_linear=False).prefix_actions(z, y)
    for t in range(30):
        x_inc = solver.append_row(z[t], float(y[t]))
        assert solver.last_info["iters"] == (2000 if t == 0 else 80)
        obj_inc = _obj(z[:t + 1], y[:t + 1], x_inc)
        obj_bat = _obj(z[:t + 1], y[:t + 1], batch_actions[t + 1])
        assert obj_inc <= obj_bat + 1e-8, t


def test_unconverged_solve_raises_or_sentinels():
    """Residual telemetry: a deliberately starved solve is flagged, not
    silently wrong (VERDICT round-1 'ADMM runs open-loop')."""
    z, y = _instance(T=40, seed=10)
    starved = ExactFTL(d=5, T_max=40, norm="l2", iters=2, fail_tol=1e-6,
                       allow_linear=False)
    with pytest.raises(RuntimeError, match="failed to converge"):
        starved.solve_full(z, y)
    sentinel = ExactFTL(d=5, T_max=40, norm="l2", iters=2, fail_tol=1e-6,
                        on_fail="sentinel", allow_linear=False)
    x = sentinel.solve_full(z, y)
    assert np.isnan(x).all()
    assert not sentinel.last_info["converged"]
    # A healthy solve reports convergence.
    ok = ExactFTL(d=5, T_max=40, norm="l2", iters=3000, allow_linear=False)
    ok.solve_full(z, y)
    assert ok.last_info["converged"]
    assert ok.last_info["residual"] < 1e-3


def test_bad_shapes_raise():
    z, y = _instance(T=20, seed=6)
    solver = ExactFTL(d=5, T_max=10)
    with pytest.raises(ValueError):
        solver.prefix_actions(z, y)  # longer than T_max
    with pytest.raises(ValueError):
        ExactFTL(d=3, T_max=20).prefix_actions(z, y)  # wrong d


def test_admm_state_continuation_equals_longer_run():
    """state0 continuation is EXACTLY a longer run (the iteration is
    Markov in the state) — the warm-escalation paths rely on this."""
    import jax.numpy as jnp

    from online_convex_optimization.models.exact_ftl import (
        _admm_all_prefixes,
        _admm_full,
    )

    z, y = _instance(T=30, seed=12)
    zj, yj = jnp.asarray(z), jnp.asarray(y)
    _, _, st = _admm_all_prefixes(zj, yj, norm="l2", iters=100)
    x_cont, res_cont, _ = _admm_all_prefixes(zj, yj, norm="l2", iters=150,
                                             state0=st)
    x_long, res_long, _ = _admm_all_prefixes(zj, yj, norm="l2", iters=250)
    np.testing.assert_array_equal(np.asarray(x_cont), np.asarray(x_long))
    np.testing.assert_array_equal(np.asarray(res_cont), np.asarray(res_long))

    _, _, st1 = _admm_full(zj, yj, norm="linf", iters=80)
    xc, rc, _ = _admm_full(zj, yj, norm="linf", iters=120, state0=st1)
    xl, rl, _ = _admm_full(zj, yj, norm="linf", iters=200)
    np.testing.assert_array_equal(np.asarray(xc), np.asarray(xl))
    np.testing.assert_array_equal(np.asarray(rc), np.asarray(rl))


def test_admm_banded_matches_full():
    """Dynamic prefix bands solve the same independent row problems: the
    assembled banded solution must match the full-batch solve."""
    import jax.numpy as jnp

    from online_convex_optimization.models.exact_ftl import (
        _admm_all_prefixes)

    z, y = _instance(T=60, seed=15)
    zj, yj = jnp.asarray(z), jnp.asarray(y)
    X_full, res_full, _ = _admm_all_prefixes(zj, yj, norm="l2", iters=400,
                                             tol=0.0)
    X_band = np.empty((60, 5))
    res_band = np.empty(60)
    for lo in (0, 20, 40):
        Xb, rb, _ = _admm_all_prefixes(zj, yj, norm="l2", iters=400,
                                       tol=0.0, band_lo=lo, band_rows=20)
        X_band[lo:lo + 20] = np.asarray(Xb)
        res_band[lo:lo + 20] = np.asarray(rb)
    np.testing.assert_allclose(X_band, np.asarray(X_full), atol=1e-6)
    np.testing.assert_allclose(res_band, np.asarray(res_full), atol=1e-6)
    # Overlapping tail band (the T % band_rows != 0 case): rows re-solved
    # by two bands agree.
    Xo, _, _ = _admm_all_prefixes(zj, yj, norm="l2", iters=400, tol=0.0,
                                  band_lo=35, band_rows=20)
    np.testing.assert_allclose(np.asarray(Xo), np.asarray(X_full)[35:55],
                               atol=1e-6)


def test_prefix_actions_banded_path_T512():
    """T >= 512 routes prefix_actions through the banded solver; the
    trajectory must stay feasible, monotone vs the full solution, and
    consistent with solve_full at the final prefix."""
    z, y = _instance(T=520, seed=16)
    solver = ExactFTL(d=5, T_max=520, norm="l2", iters=1500,
                      allow_linear=False)
    actions = solver.prefix_actions(z, y)
    assert actions.shape == (521, 5)
    x_full = solver.solve_full(z, y)
    assert _obj(z, y, actions[-1]) == pytest.approx(_obj(z, y, x_full),
                                                    abs=1e-8)
    for p in (1, 200, 256, 257, 400, 520):
        assert np.linalg.norm(actions[p]) <= 1.0 + 1e-6
        assert _obj(z[:p], y[:p], actions[p]) <= \
            _obj(z[:p], y[:p], x_full) + 1e-8


def test_append_row_after_certified_streak_not_stale():
    """Round-2 ADVICE: a certified-linear streak advances _length without
    advancing the ADMM warm state; the next general solve must detect the
    stale state and take the FULL iteration budget (the 80-iteration warm
    budget assumes the state is exactly one row behind) — and still match
    a cold batch solve."""
    rng = np.random.default_rng(21)
    T, d = 12, 5
    # Contract rows (unit-ball, +-1 labels) certify; the final row is far
    # out of contract so the certificate fails and the general path runs.
    z = rng.normal(size=(T, d))
    z /= np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1.0) * 1.001
    y = np.sign(rng.normal(size=T))
    y[y == 0] = 1.0
    z[-1] *= 8.0
    solver = ExactFTL(d=d, T_max=T, norm="l2", iters=2000, warm_iters=80,
                      allow_linear=True)
    for t in range(T - 1):
        x = solver.append_row(z[t], float(y[t]))
        assert solver.last_info.get("solver") == "certified-linear", t
    x_last = solver.append_row(z[-1], float(y[-1]))
    # The stale-state detector must have escalated to the full budget...
    assert solver.last_info["iters"] == 2000
    assert solver.last_info["converged"]
    # ...and the result matches a cold full solve to polish accuracy.
    cold = ExactFTL(d=d, T_max=T, norm="l2", iters=4000,
                    allow_linear=False)
    x_cold = cold.solve_full(z, y)
    obj_inc = _obj(z, y, x_last)
    obj_cold = _obj(z, y, x_cold)
    assert obj_inc <= obj_cold + 1e-7
