"""Certified closed-form exact FTL (models/linear_regime.py).

The theorem: for y in {+-1}, |q - y| >= 1 - q*y with equality iff
|q| <= 1, so on binary-label data the exact-FTL program is bounded below
by a LINEAR program whose ball argmin is closed-form; the per-prefix
certificate max_{i<=t} |<z_i, x*_t>| <= 1 upgrades the bound to exact
global optimality.  These tests check (a) the certified solutions against
the general ADMM + active-set-polish solver and independent LP/NLP
solvers, (b) that the certificate REJECTS out-of-contract and degenerate
(w = 0) data, and (c) that the experiment surfaces dispatch/fall back
correctly end to end.
"""

import numpy as np
import pytest
from scipy.optimize import linprog, minimize

from online_convex_optimization.models.exact_ftl import ExactFTL
from online_convex_optimization.models.linear_regime import (
    certified_full_solution,
    certified_full_solution_batch,
    certified_prefix_actions,
    certified_prefix_actions_batch,
)


def _contract_instance(T=60, d=5, seed=0, noise=0.3):
    """Binary-label instance with rows clipped to the unit ball (the
    reference's production regime, sequence_generation.py:54-90)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
    y = np.sign(z @ rng.normal(size=d) + noise * rng.normal(size=T))
    y[y == 0] = 1.0
    return z, y


def _small_rows_instance(T=40, d=5, seed=3, scale=0.3):
    """Rows with ||z||_2 <= scale < 1/sqrt(d): every prediction of every
    unit-linf/l1 action stays inside [-1, 1], so the certificate passes
    for all three norms."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, d))
    z *= scale / np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1e-9)
    y = np.sign(z @ rng.normal(size=d) + 0.1 * rng.normal(size=T))
    y[y == 0] = 1.0
    return z, y


def _obj(z, y, x):
    return 0.5 * np.sum(np.abs(z @ x - y))


def _lp_solve(z, y, norm):
    T, d = z.shape
    if norm == "linf":
        c = np.concatenate([np.zeros(d), 0.5 * np.ones(T)])
        A_ub = np.block([[z, -np.eye(T)], [-z, -np.eye(T)]])
        b_ub = np.concatenate([y, -y])
        bounds = [(-1, 1)] * d + [(0, None)] * T
        return linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=bounds,
                       method="highs").x[:d]
    if norm == "l1":
        c = np.concatenate([np.zeros(2 * d), 0.5 * np.ones(T)])
        A_res = np.block([[z, -z, -np.eye(T)], [-z, z, -np.eye(T)]])
        b_res = np.concatenate([y, -y])
        A_l1 = np.concatenate([np.ones(2 * d), np.zeros(T)])[None, :]
        res = linprog(c, A_ub=np.vstack([A_res, A_l1]),
                      b_ub=np.concatenate([b_res, [1.0]]),
                      bounds=[(0, None)] * (2 * d + T), method="highs")
        return res.x[:d] - res.x[d:2 * d]
    raise ValueError(norm)


# ---------------------------------------------------------------------
# Correctness of the certified solutions
# ---------------------------------------------------------------------

def test_certified_prefixes_match_general_solver_l2():
    """Every certified prefix minimizer matches the ADMM + polish
    trajectory (the general path is ~1e-9-polished; the closed form is
    exact, so objectives agree at that level and the unique argmins
    coincide)."""
    z, y = _contract_instance(T=50, seed=1)
    acts_lin = certified_prefix_actions(z, y, "l2")
    assert acts_lin is not None
    acts_gen = ExactFTL(d=5, T_max=50, norm="l2", iters=4000,
                        allow_linear=False).prefix_actions(z, y)
    for p in range(1, 51):
        f_lin = _obj(z[:p], y[:p], acts_lin[p])
        f_gen = _obj(z[:p], y[:p], acts_gen[p])
        assert f_lin <= f_gen + 1e-9, p
        np.testing.assert_allclose(acts_lin[p], acts_gen[p], atol=2e-5)


def test_certified_full_matches_slsqp_l2():
    z, y = _contract_instance(T=60, seed=2)
    x = certified_full_solution(z, y, "l2")
    assert x is not None
    rng = np.random.default_rng(5)
    best = None
    for _ in range(4):
        r = minimize(lambda v: _obj(z, y, v), 0.1 * rng.normal(size=5),
                     constraints=[{"type": "ineq",
                                   "fun": lambda v: 1 - np.dot(v, v)}],
                     method="SLSQP", options={"maxiter": 500, "ftol": 1e-12})
        if best is None or r.fun < best.fun:
            best = r
    assert _obj(z, y, x) <= best.fun + 1e-9
    assert np.linalg.norm(x) <= 1.0 + 1e-12


@pytest.mark.parametrize("norm", ["linf", "l1"])
def test_certified_matches_highs_lp(norm):
    """On small-row data the linf/l1 closed forms certify and must hit the
    HiGHS LP optimum exactly (both are exact: equality to 1e-10)."""
    z, y = _small_rows_instance()
    acts = certified_prefix_actions(z, y, norm)
    assert acts is not None, "small-row data must certify"
    for p in range(5, 41, 5):
        f_c = _obj(z[:p], y[:p], acts[p])
        f_lp = _obj(z[:p], y[:p], _lp_solve(z[:p], y[:p], norm))
        assert f_c <= f_lp + 1e-10, p


@pytest.mark.parametrize("norm", ["linf", "l1"])
def test_nonl2_violation_masks_match_dense_reference(norm):
    """The O(T)-extra-memory l1/linf certificate screens (VERDICT r4
    task 4) must flag EXACTLY the prefixes the old dense (B, T, T)
    prediction matrix flagged, on data mixing certifying and violating
    rows."""
    from online_convex_optimization.models.linear_regime import (
        _CERT_SLACK, _l1_certificate_violations,
        _linf_certificate_violations, _linear_argmin)

    rng = np.random.default_rng(77)
    B, T, d = 3, 60, 5
    z = rng.normal(size=(B, T, d)) * rng.uniform(0.1, 0.9, (B, T, 1))
    # Sprinkle rows with big coordinates / big l1 norms to force
    # violations in both closed forms.
    hot = rng.random((B, T)) < 0.25
    z[hot] *= 3.0
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    w = np.cumsum(y[..., None] * z, axis=-2)
    X, _ = _linear_argmin(w, norm)

    Q = np.matmul(X, z.transpose(0, 2, 1))               # (B, T_t, T_i)
    past = np.tril(np.ones((T, T), bool))
    want = ((np.abs(Q) > 1.0 + _CERT_SLACK) & past).any(axis=-1)
    if norm == "l1":
        got = _l1_certificate_violations(z, w, X)
    else:
        got = _linf_certificate_violations(z, X)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all(), "test data must mix outcomes"


def test_certified_closed_forms_and_identity():
    """x*_t = w_t/||w_t||; comparator loss = 0.5*(t - ||w_t||) — the
    carried-statistics identity the fused kernels use, now certified on
    the exact track."""
    z, y = _contract_instance(T=30, seed=4)
    acts = certified_prefix_actions(z, y, "l2")
    w = np.cumsum(y[:, None] * z, axis=0)
    for t in (1, 10, 30):
        np.testing.assert_allclose(acts[t], w[t - 1] / np.linalg.norm(
            w[t - 1]), atol=1e-12)
        assert _obj(z[:t], y[:t], acts[t]) == pytest.approx(
            0.5 * (t - np.linalg.norm(w[t - 1])), abs=1e-9)


def test_padded_rows_are_inert():
    """Zero-padded (z = 0, y = 0) tail rows keep the trajectory constant
    and do not break the contract check."""
    z, y = _contract_instance(T=20, seed=6)
    zp = np.concatenate([z, np.zeros((10, 5))])
    yp = np.concatenate([y, np.zeros(10)])
    X = certified_prefix_actions_batch(zp[None], yp[None], "l2")
    assert X is not None
    for t in range(20, 30):
        np.testing.assert_array_equal(X[0, t], X[0, 19])


# ---------------------------------------------------------------------
# The certificate must REJECT what it cannot prove
# ---------------------------------------------------------------------

def test_rejects_out_of_contract_rows():
    """Unclipped Gaussian rows (the reference's own smoke-test regime,
    exact_ftl.py:460-475): ||z|| >> 1 makes predictions exceed 1 and the
    closed form is NOT optimal — must return None and fall back."""
    rng = np.random.default_rng(7)
    z = 3.0 * rng.normal(size=(30, 5))
    y = np.sign(z @ rng.normal(size=5))
    y[y == 0] = 1.0
    assert certified_prefix_actions(z, y, "l2") is None
    solver = ExactFTL(d=5, T_max=30, norm="l2", iters=3000)
    solver.prefix_actions(z, y)
    assert solver.last_info.get("solver") != "certified-linear"
    assert solver.last_info["residual"] > 0.0  # general path ran


def test_rejects_non_binary_labels():
    rng = np.random.default_rng(8)
    z = rng.normal(size=(20, 5))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
    y = z @ rng.normal(size=5)  # real-valued regression targets
    assert certified_prefix_actions(z, y, "l2") is None
    assert certified_full_solution(z, y, "l2") is None


def test_rejects_zero_w_prefixes():
    """The deterministic flip family hits w_t = 0 at even t: the linear
    argmin is non-unique there, so the fast path must decline (replayed
    trajectories are selection-dependent; the general solver keeps the
    reference-matching selection)."""
    from online_convex_optimization.data.sequences import flip_sequence
    z, y, _ = flip_sequence(20, dtype=np.float64)
    assert certified_prefix_actions(z, y, "l2") is None


def test_rejects_linf_when_predictions_leave_unit_range():
    """Generic clipped data under linf: ||sign(w)||_2 = sqrt(d) pushes
    predictions beyond 1, so the certificate must fail (ADMM handles it)."""
    z, y = _contract_instance(T=40, seed=9)
    assert certified_prefix_actions(z, y, "linf") is None


# ---------------------------------------------------------------------
# Dispatch through the public surfaces
# ---------------------------------------------------------------------

def test_exact_ftl_dispatches_to_certified():
    z, y = _contract_instance(T=40, seed=10)
    solver = ExactFTL(d=5, T_max=40, norm="l2")
    acts = solver.prefix_actions(z, y)
    assert solver.last_info["solver"] == "certified-linear"
    assert solver.last_info["residual"] == 0.0
    gen = ExactFTL(d=5, T_max=40, norm="l2", iters=4000,
                   allow_linear=False).prefix_actions(z, y)
    for p in (1, 20, 40):
        assert _obj(z[:p], y[:p], acts[p]) <= \
            _obj(z[:p], y[:p], gen[p]) + 1e-9
    x_full = solver.solve_full(z, y)
    assert solver.last_info["solver"] == "certified-linear"
    np.testing.assert_allclose(x_full, acts[-1], atol=1e-12)


def test_append_row_certified_and_fallback_composition():
    """append_row rides the closed form on contract rows and still matches
    the batch trajectory."""
    z, y = _contract_instance(T=15, seed=11)
    solver = ExactFTL(d=5, T_max=15, norm="l2")
    batch = solver.prefix_actions(z, y)
    solver.reset_buffers()
    for t in range(15):
        x = solver.append_row(z[t], float(y[t]))
        assert solver.last_info["solver"] == "certified-linear"
        np.testing.assert_allclose(x, batch[t + 1], atol=1e-10)


def test_evaluate_stream_exact_auto_matches_xla():
    """solver='auto' (certified fast path) reproduces solver='xla'
    (general ADMM + polish) statistics on a random contract family."""
    from online_convex_optimization.data.sequences import CASES
    from online_convex_optimization.experiments.evaluate import (
        evaluate_stream_exact)

    builder = dict(CASES)["Random i.i.d. (separable)"]
    kw = dict(T_grid=[30, 50], runs=2, replicates=2, iters=1200,
              dtype=np.float64, stream_name="lin", progress=False)
    s_a = evaluate_stream_exact(builder, solver="auto", **kw)
    s_x = evaluate_stream_exact(builder, solver="xla", **kw)
    for key in s_x:
        np.testing.assert_allclose(s_a[key][0], s_x[key][0], atol=1e-6)
        np.testing.assert_allclose(s_a[key][1], s_x[key][1], atol=1e-6)


def test_evaluate_stream_exact_linear_requires_certificate():
    """solver='linear' on a w=0 deterministic family must raise; on
    contract data it must succeed without any device solve."""
    from online_convex_optimization.data.sequences import CASES
    from online_convex_optimization.experiments.evaluate import (
        evaluate_stream_exact)

    flip = dict(CASES)["Label flips"]
    with pytest.raises(RuntimeError, match="certificate"):
        evaluate_stream_exact(flip, T_grid=[20], runs=1, replicates=1,
                              solver="linear", dtype=np.float64,
                              progress=False)
    iid = dict(CASES)["Random i.i.d. (separable)"]
    stats = evaluate_stream_exact(iid, T_grid=[20, 40], runs=1,
                                  replicates=2, solver="linear",
                                  dtype=np.float64, progress=False)
    assert np.isfinite(stats["FTL (exact)"][0]).all()


def test_evaluate_stream_exact_auto_falls_back_on_deterministic():
    """auto on the flip family (w=0 prefixes) must take the general path
    and agree with forced-xla exactly."""
    from online_convex_optimization.data.sequences import CASES
    from online_convex_optimization.experiments.evaluate import (
        evaluate_stream_exact)

    flip = dict(CASES)["Label flips"]
    kw = dict(T_grid=[20], runs=1, replicates=1, iters=1200,
              dtype=np.float64, progress=False)
    s_a = evaluate_stream_exact(flip, solver="auto", **kw)
    s_x = evaluate_stream_exact(flip, solver="xla", **kw)
    for key in s_x:
        np.testing.assert_array_equal(s_a[key][0], s_x[key][0])


def test_estimate_g_exact_auto_matches_general(tmp_path):
    from online_convex_optimization.experiments.gt import estimate_g_exact

    g_a = estimate_g_exact([30, 50], runs=4, base_seed=0, iters=1500,
                           solver="auto", progress=False)
    g_x = estimate_g_exact([30, 50], runs=4, base_seed=0, iters=1500,
                           solver="xla", progress=False)
    for T in (30, 50):
        assert g_a[T] == pytest.approx(g_x[T], abs=1e-6)


def test_device_generated_data_is_a_priori_certified():
    """Device generators deflate rows strictly into the unit ball
    (data/device.py::_STRICT), so EXACT f64 row norms are <= 1 and by
    Cauchy-Schwarz every prefix of every sequence passes the optimality
    certificate without checking — the fused kernels' FTL track plays
    certified-exact FTL minimizers."""
    import jax

    from online_convex_optimization.data.device import (
        random_game_batch,
        separable_stream_batch,
    )
    z1, y1 = random_game_batch(jax.random.key(0), 8, 64)
    z2, y2, _ = separable_stream_batch(jax.random.key(1), 8, 64)
    for z, y in ((z1, y1), (z2, y2)):
        zh = np.asarray(z, np.float64)
        assert float(np.linalg.norm(zh, axis=-1).max()) <= 1.0
        assert certified_prefix_actions_batch(
            zh, np.asarray(y, np.float64), "l2") is not None


def test_exact_ftl_equals_plain_ftl_on_contract_data():
    """THE theorem, end to end: on certified data the exact-FTL trajectory
    IS linearized FTL (x*_t = w_t/||w_t||), so the replayed exact-FTL
    regret equals the plain FTL regret (golden f64 oracle)."""
    from online_convex_optimization.models.exact_ftl import run_ftl_exact
    from online_convex_optimization.testing.golden import (
        golden_simulate_alg)

    z, y = _contract_instance(T=80, seed=12)
    res = run_ftl_exact(z, y)
    plain = golden_simulate_alg(z, y, 1, np.sqrt(2.0))
    assert res.regret == pytest.approx(plain, abs=1e-9)
