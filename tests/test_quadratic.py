"""Quadratic-loss track (BASELINE.json config 1): ball-constrained
least-squares FTL from running (A, b, c) sufficient statistics.

No reference analog exists (the reference is hinge-only); correctness is
established against scipy SLSQP multi-start and internal identities.
"""

import numpy as np
import pytest
from scipy.optimize import minimize

import jax.numpy as jnp

from online_convex_optimization.models.quadratic import (
    ball_ls_action,
    quadratic_comparator_loss,
    simulate_quadratic,
    simulate_quadratic_batch,
)


def _instance(T, d=5, seed=0, sigma=0.3):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
    u = rng.normal(size=d)
    u /= np.linalg.norm(u)
    y = z @ u + sigma * rng.normal(size=T)
    return z.astype(np.float64), y.astype(np.float64)


def _obj(z, y, x):
    return 0.5 * float(np.sum((z @ x - y) ** 2))


def _slsqp(z, y, seed=0):
    d = z.shape[1]
    rng = np.random.default_rng(seed)
    best = None
    for trial in range(8):
        x0 = rng.normal(size=d)
        x0 /= max(np.linalg.norm(x0), 1.0) * 1.1
        r = minimize(lambda x: _obj(z, y, x), x0, method="SLSQP",
                     constraints=[{"type": "ineq",
                                   "fun": lambda x: 1.0 - x @ x}],
                     options={"maxiter": 400, "ftol": 1e-14})
        if best is None or r.fun < best.fun:
            best = r
    return best


@pytest.mark.parametrize("t", [1, 2, 3, 4, 8, 40])
def test_ball_ls_action_matches_slsqp(t):
    """All prefix sizes, including singular t < d systems."""
    z, y = _instance(T=40, seed=1)
    zp, yp = z[:t], y[:t]
    A = jnp.asarray(zp.T @ zp)
    b = jnp.asarray(zp.T @ yp)
    x = np.asarray(ball_ls_action(A, b))
    assert np.linalg.norm(x) <= 1.0 + 1e-9
    best = _slsqp(zp, yp, seed=t)
    assert _obj(zp, yp, x) <= best.fun + 1e-8, t


def test_ball_ls_action_null_space_gradient():
    """Singular A with b having a null-space component must go to the
    boundary along that direction (the lam=0 pseudo-inverse is wrong)."""
    d = 4
    A = np.zeros((d, d))
    A[0, 0] = 2.0                     # rank-1; directions 1..3 are free
    b = np.zeros(d)
    b[0] = 0.5
    b[1] = 1.0                        # null-space pull
    x = np.asarray(ball_ls_action(jnp.asarray(A), jnp.asarray(b)))
    assert np.linalg.norm(x) == pytest.approx(1.0, abs=1e-6)
    obj = 0.5 * x @ A @ x - b @ x
    best = _slsqp_quad(A, b)
    assert obj <= best + 1e-8


def _slsqp_quad(A, b, seed=0):
    rng = np.random.default_rng(seed)
    best = np.inf
    for _ in range(8):
        x0 = rng.normal(size=len(b))
        x0 /= max(np.linalg.norm(x0), 1.0) * 1.1
        r = minimize(lambda x: 0.5 * x @ A @ x - b @ x, x0, method="SLSQP",
                     constraints=[{"type": "ineq",
                                   "fun": lambda x: 1.0 - x @ x}],
                     options={"maxiter": 400, "ftol": 1e-14})
        best = min(best, r.fun)
    return best


def test_comparator_stats_equal_replay():
    z, y = _instance(T=60, seed=2)
    A = jnp.asarray(z.T @ z)
    b = jnp.asarray(z.T @ y)
    c = float(np.sum(y * y))
    x = ball_ls_action(A, b)
    from_stats = float(quadratic_comparator_loss(A, b, c, x))
    replay = _obj(z, y, np.asarray(x))
    assert from_stats == pytest.approx(replay, rel=1e-9, abs=1e-9)


def test_batch_matches_single_and_ftl_beats_ftrl_on_easy_data():
    z, y = _instance(T=80, seed=3, sigma=0.05)
    res_b = simulate_quadratic_batch(z[None], y[None], 1, 1.0)
    res_s = simulate_quadratic(z, y, alg="ftl")
    assert float(res_b.regret[0]) == pytest.approx(res_s.regret, abs=1e-9)
    res_ftrl = simulate_quadratic(z, y, alg="ftrl", eta0=1.0)
    # Exact FTL tracks the near-noiseless regression much tighter.
    assert res_s.cum_loss < res_ftrl.cum_loss
    assert res_s.regret >= -1e-6


def test_single_sequence_T1e4_cpu_runnable():
    """BASELINE config 1 shape: one sequence, T = 10^4, CPU."""
    from online_convex_optimization.data.sequences import (
        make_regression_stream)
    sampler = make_regression_stream(sigma=0.1, run_seed=2025)
    z, y, u = sampler(10_000)
    res = simulate_quadratic(z.astype(np.float64), y.astype(np.float64),
                             alg="ftl")
    assert np.isfinite(res.regret)
    # The exact leader converges to ~u: average loss approaches sigma^2/2.
    assert res.cum_loss / 10_000 < 0.02
    assert abs(np.linalg.norm(res.x_last) - min(np.linalg.norm(u), 1.0)) < 0.2


def test_regression_stream_contract():
    from online_convex_optimization.data.sequences import (
        make_regression_stream)
    s = make_regression_stream(sigma=0.2, run_seed=7)
    z, y, u = s(256, rep=3)
    assert np.all(np.linalg.norm(z, axis=1) <= 1.0 + 1e-6)
    za, ya, _ = make_regression_stream(sigma=0.2, run_seed=7)(256, rep=3)
    np.testing.assert_array_equal(z, za)   # PCG64 determinism
    np.testing.assert_array_equal(y, ya)


@pytest.mark.parametrize("t", [1, 3, 8, 40])
def test_ball_ls_f32_matches_f64_solver(t):
    """The XLA trust-region bisection in f32 (the device precision) ==
    the f64 solve on every prefix size (including singular t < d
    systems): objectives always, vectors on full-rank prefixes."""
    z, y = _instance(T=40, seed=5)
    zp, yp = z[:t], y[:t]
    A = zp.T @ zp
    b = zp.T @ yp
    got = np.asarray(ball_ls_action(jnp.asarray(A[None], jnp.float32),
                                    jnp.asarray(b[None], jnp.float32)))[0]
    want = np.asarray(ball_ls_action(jnp.asarray(A[None]),
                                     jnp.asarray(b[None])))[0]
    # Underdetermined prefixes (t < d) have non-unique minimizers, so
    # compare OBJECTIVES; the full-rank case must match vectorwise.
    assert _obj(zp, yp, got) <= _obj(zp, yp, want) + 1e-5
    if t >= 8:
        np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.linalg.norm(got) <= 1.0 + 1e-6
    best = _slsqp(zp, yp, seed=t)
    assert _obj(zp, yp, got) <= best.fun + 1e-4


def test_ball_ls_batch_matches_per_system():
    """The batched solve equals solving each system alone (no cross-talk
    across a ragged multi-system batch)."""
    rng = np.random.default_rng(3)
    N, d = 257, 5
    M = rng.normal(size=(N, d, d)).astype(np.float32)
    A = jnp.asarray(M @ M.transpose(0, 2, 1))
    b = jnp.asarray(rng.normal(size=(N, d)).astype(np.float32))
    got = np.asarray(ball_ls_action(A, b))
    for i in (0, 100, 256):
        one = np.asarray(ball_ls_action(A[i:i + 1], b[i:i + 1]))[0]
        np.testing.assert_allclose(got[i], one, atol=1e-6)
    assert (np.linalg.norm(got, axis=-1) <= 1.0 + 1e-5).all()


def test_quadratic_game_f32_tracks_f64_truth():
    """The f32 XLA quadratic game (the device path) tracks the f64 ground
    truth within the inherent f32 trajectory noise of ill-conditioned
    early prefixes."""
    rng = np.random.default_rng(0)
    B, T, d = 64, 48, 5
    z = rng.normal(size=(B, T, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = (z @ (np.ones(d) / np.sqrt(d))
         + 0.2 * rng.normal(size=(B, T))).astype(np.float32)
    got = np.asarray(simulate_quadratic_batch(z, y, 1, 1.0).regret)
    truth = np.asarray(simulate_quadratic_batch(
        z.astype(np.float64), y.astype(np.float64), 1, 1.0).regret)
    assert np.abs(got - truth).max() < 0.05
    assert abs(got.mean() - truth.mean()) < 2e-3


@pytest.mark.gpu
def test_quadratic_game_on_gpu_matches_f64():
    """The quadratic game on the GPU in f32: RunResult invariants and
    agreement with the f64 truth."""
    rng = np.random.default_rng(2)
    B, T, d = 1024, 128, 5
    z = rng.normal(size=(B, T, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = (z @ (np.ones(d) / np.sqrt(d))
         + 0.1 * rng.normal(size=(B, T))).astype(np.float32)
    res = simulate_quadratic_batch(z, y, 1, 1.0)
    reg = np.asarray(res.regret)
    assert np.isfinite(reg).all()
    np.testing.assert_allclose(
        np.asarray(res.cum_loss),
        reg + np.asarray(res.comp_loss), atol=1e-3)
    assert (np.linalg.norm(np.asarray(res.x_last), axis=-1)
            <= 1.0 + 1e-5).all()
    truth = np.asarray(simulate_quadratic_batch(
        z.astype(np.float64), y.astype(np.float64), 1, 1.0).regret)
    assert np.abs(reg - truth).max() < 0.05


def test_quadratic_study_end_to_end(tmp_path):
    """The quadratic-track experiment surface (VERDICT round-2 task 6):
    study runs end-to-end, writes the JSON artifact + figure, and the
    exact-FTL curve sits below FTRL (fast/log-T regime on the
    well-conditioned regression stream)."""
    from online_convex_optimization.experiments.quadratic_study import (
        QuadraticConfig, run_study)

    cfg = QuadraticConfig(t_min=100, t_max=300, t_step=100, runs=2,
                          replicates=2, out_dir=str(tmp_path), dpi=60)
    results = run_study(cfg)
    import os
    assert os.path.exists(tmp_path / "results_quadratic.json")
    assert os.path.exists(tmp_path / "quadratic_regret.png")
    ftl = results["stats"]["FTL (exact LS)"]["mean"]
    ftrl = results["stats"]["FTRL"]["mean"]
    assert all(np.isfinite(ftl)) and all(np.isfinite(ftrl))
    assert ftl[-1] < ftrl[-1]
