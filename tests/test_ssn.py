"""Semismooth-Newton exact-FTL solver (models/ssn.py).

Cross-validated three ways: against the batched ADMM (the incumbent
general solver), against SLSQP multistart (independent smooth solver),
and through the ExactFTL surface with the shared active-set polish.
All instances here are OUT of the certified linear regime (unclipped
rows) — on contract data the closed form short-circuits both iterative
solvers (models/linear_regime.py)."""

import numpy as np
import pytest
from scipy.optimize import minimize

from online_convex_optimization.models.exact_ftl import ExactFTL
from online_convex_optimization.models.polish import (
    objective,
    polish_solution,
)
from online_convex_optimization.models.ssn import (
    ssn_all_prefixes,
    ssn_full,
)


def _hard_instance(T=60, d=5, seed=0, scale=2.0):
    """Unclipped rows (||z|| ~ scale * sqrt(d) >> 1): the reference's own
    smoke-test regime (exact_ftl.py:460-475); fails the linear-regime
    certificate, so the iterative solvers genuinely run."""
    rng = np.random.default_rng(seed)
    z = scale * rng.normal(size=(T, d))
    y = np.sign(z @ rng.normal(size=d) + 0.5 * rng.normal(size=T))
    y[y == 0] = 1.0
    return z, y


def _slsqp_best(z, y, tries=5, seed=99):
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(tries):
        r = minimize(lambda v: objective(z, y, v),
                     0.3 * rng.normal(size=z.shape[1]),
                     constraints=[{"type": "ineq",
                                   "fun": lambda v: 1 - np.dot(v, v)}],
                     method="SLSQP", options={"maxiter": 800,
                                              "ftol": 1e-14})
        if best is None or r.fun < best.fun:
            best = r
    return best.fun


def test_ssn_full_matches_slsqp_after_polish():
    z, y = _hard_instance(seed=1)
    import jax.numpy as jnp
    x, res, _ = ssn_full(jnp.asarray(z), jnp.asarray(y), iters=120,
                         tol=1e-5)
    assert float(res) <= 1e-3
    x_pol = polish_solution(z, y, np.asarray(x, np.float64), "l2")
    assert objective(z, y, x_pol) <= _slsqp_best(z, y) + 1e-8
    assert np.linalg.norm(x_pol) <= 1.0 + 1e-9


def test_ssn_prefixes_match_admm_after_polish():
    """Both general solvers + the shared polish land on the same optima
    for every prefix of a hard instance."""
    z, y = _hard_instance(T=40, seed=2)
    ssn = ExactFTL(d=5, T_max=40, norm="l2", method="ssn", iters=200,
                   allow_linear=False)
    admm = ExactFTL(d=5, T_max=40, norm="l2", iters=6000,
                    allow_linear=False)
    a_s = ssn.prefix_actions(z, y)
    a_a = admm.prefix_actions(z, y)
    for p in range(1, 41):
        fs = objective(z[:p], y[:p], a_s[p])
        fa = objective(z[:p], y[:p], a_a[p])
        # Two-sided at the measured degenerate-valley envelope (see
        # docs/BENCHMARKS.md): either path may land on either end of a
        # ~2.4e-6-flat face; the absolute bars vs SLSQP live above.
        assert abs(fs - fa) <= 3e-6, p
        assert np.linalg.norm(a_s[p]) <= 1.0 + 1e-9


def test_ssn_banded_consistency():
    """Band solves agree with the full-batch solve at the shared
    tolerance (rows are independent; band exit points differ)."""
    import jax.numpy as jnp
    z, y = _hard_instance(T=60, seed=3)
    zj, yj = jnp.asarray(z), jnp.asarray(y)
    X_full, r_full, _ = ssn_all_prefixes(zj, yj, iters=200, tol=1e-5)
    assert float(np.max(np.asarray(r_full))) <= 1e-4
    for lo in (0, 20, 40):
        Xb, rb, _ = ssn_all_prefixes(zj, yj, iters=200, tol=1e-5,
                                     band_lo=lo, band_rows=20)
        for k in range(20):
            p = lo + k + 1
            fb = objective(z[:p], y[:p], np.asarray(Xb)[k])
            ff = objective(z[:p], y[:p], np.asarray(X_full)[p - 1])
            assert abs(fb - ff) <= 1e-4, p


def test_ssn_contract_data_sanity():
    """On certified data the SSN must agree with the closed form (it is
    never used there in production, but correctness must not depend on
    the data regime)."""
    import jax.numpy as jnp

    from online_convex_optimization.models.linear_regime import (
        certified_prefix_actions)
    rng = np.random.default_rng(4)
    z = rng.normal(size=(30, 5))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
    y = np.sign(z @ rng.normal(size=5) + 0.3 * rng.normal(size=30))
    y[y == 0] = 1.0
    acts = certified_prefix_actions(z, y, "l2")
    assert acts is not None
    X, res, _ = ssn_all_prefixes(jnp.asarray(z), jnp.asarray(y),
                                 iters=200, tol=1e-5)
    for p in (1, 10, 30):
        f_ssn = objective(z[:p], y[:p], np.asarray(X)[p - 1])
        f_lin = objective(z[:p], y[:p], acts[p])
        assert f_ssn <= f_lin + 1e-4, p


def test_evaluate_stream_exact_ssn_matches_xla():
    """solver='ssn' (semismooth-Newton bands + polish) reproduces the
    ADMM-band statistics on a random contract family."""
    from online_convex_optimization.data.sequences import CASES
    from online_convex_optimization.experiments.evaluate import (
        evaluate_stream_exact)

    builder = dict(CASES)["Random i.i.d. (separable)"]
    kw = dict(T_grid=[30, 50], runs=1, replicates=2, iters=1200,
              dtype=np.float64, stream_name="ssn", progress=False)
    s_s = evaluate_stream_exact(builder, solver="ssn", **kw)
    s_x = evaluate_stream_exact(builder, solver="xla", **kw)
    for key in s_x:
        np.testing.assert_allclose(s_s[key][0], s_x[key][0], atol=3e-6)


@pytest.mark.parametrize("seed", [5, 7, 8, 9])
def test_ssn_fuzz_matches_admm_after_polish(seed):
    """Randomized (scale, T, noise) out-of-contract instances, including
    the measured slow-tail seeds (near-kink residuals take ~1e3 Newton
    steps — the budget below covers them; at 400 they end ~4e-4-converged
    and the polish can lose ~3e-4): post-polish parity with the ADMM."""
    import jax.numpy as jnp

    from online_convex_optimization.models.exact_ftl import (
        _admm_all_prefixes)
    from online_convex_optimization.models.polish import (
        polish_prefix_actions)

    rng = np.random.default_rng(seed)
    T = int(rng.integers(20, 90))
    scale = float(rng.uniform(0.5, 4.0))
    z = scale * rng.normal(size=(T, 5))
    y = np.sign(z @ rng.normal(size=5)
                + rng.uniform(0, 0.8) * rng.normal(size=T))
    y[y == 0] = 1.0
    zj, yj = jnp.asarray(z), jnp.asarray(y)
    Xs, rs, _ = ssn_all_prefixes(zj, yj, iters=2000, tol=1e-5)
    assert float(np.max(np.asarray(rs))) <= 1e-4
    Xa, _, _ = _admm_all_prefixes(zj, yj, norm="l2", iters=20000,
                                  tol=1e-6, check_every=200)
    a_s = polish_prefix_actions(z, y, np.concatenate(
        [np.zeros((1, 5)), np.asarray(Xs, np.float64)]), "l2")
    a_a = polish_prefix_actions(z, y, np.concatenate(
        [np.zeros((1, 5)), np.asarray(Xa, np.float64)]), "l2")
    for p in range(1, T + 1):
        fs = objective(z[:p], y[:p], a_s[p])
        fa = objective(z[:p], y[:p], a_a[p])
        assert abs(fs - fa) <= 3e-6, p


def test_ssn_failure_contract_and_validation():
    """Starved Newton budget surfaces through the same raise/sentinel
    contract as the ADMM; ssn rejects the l1 ball (r5: linf is now
    supported — see test_exact_ftl_ssn_linf_end_to_end)."""
    z, y = _hard_instance(T=40, seed=5)
    starved = ExactFTL(d=5, T_max=40, norm="l2", method="ssn", iters=1,
                       fail_tol=1e-6, allow_linear=False)
    with pytest.raises(RuntimeError, match="failed to converge"):
        starved.solve_full(z, y)
    with pytest.raises(ValueError, match="l2"):  # l1 stays ADMM-only
        ExactFTL(d=5, T_max=40, norm="l1", method="ssn")
    with pytest.raises(ValueError, match="method"):
        ExactFTL(d=5, T_max=40, method="nope")


def test_ssn_f32_certificate_sound_and_covering():
    """The f32 compensated certificate (comp mode in ssn_all_prefixes):
    the reported res must be a RIGOROUS upper bound on the true
    normalized suboptimality (soundness — a feasible dual can only
    weaken, never falsify), and must cover >= 95% of prefixes at the
    production fail_tol 2e-4 on a hard out-of-contract instance.  This
    is the f32-vs-f64 gap that kept the SSN x64-only through round 3
    (docs/BENCHMARKS.md: 16% uncertified at T=1024)."""
    import jax.numpy as jnp
    z, y = _hard_instance(T=96, seed=3)
    zf = jnp.asarray(z, jnp.float32)
    yf = jnp.asarray(y, jnp.float32)
    X32, res32, _ = ssn_all_prefixes(zf, yf, iters=800, tol=1e-5)
    assert X32.dtype == jnp.float32
    # f64 oracle on the f32-SEEN data (same bits the f32 run solves).
    z64 = np.asarray(zf, np.float64)
    y64 = np.asarray(yf, np.float64)
    X64, res64, _ = ssn_all_prefixes(jnp.asarray(z64), jnp.asarray(y64),
                                     iters=2000, tol=1e-7)
    assert float(np.max(np.asarray(res64))) <= 1e-5
    T = len(y)
    m = np.tril(np.ones((T, T)))

    def fvals(X):
        X = np.asarray(X, np.float64)
        return 0.5 * (np.abs(X @ z64.T - y64[None, :]) * m).sum(1)

    fstar, f32v = fvals(X64), fvals(X32)
    sub = (f32v - fstar) / (1.0 + fstar)
    res = np.asarray(res32, np.float64)
    # Soundness: certified gap upper-bounds the true suboptimality.
    assert np.all(sub <= res + 1e-6), (
        f"unsound rows: {np.where(sub > res + 1e-6)[0]}")
    # Coverage at the production fail_tol.
    frac = float((res <= 2e-4).mean())
    assert frac >= 0.95, f"only {frac:.1%} certified at 2e-4"


def test_evaluate_stream_exact_auto_routes_ooc_to_ssn():
    """solver='auto' on OUT-OF-CONTRACT data (rows outside the unit
    ball) escalates general cells to the semismooth-Newton band solver
    and reproduces the solver='ssn' statistics exactly.  (Against 'xla'
    only the post-polish OBJECTIVES are comparable — degenerate flat
    valleys make the replayed regret selection-dependent; that parity is
    covered by the ssn fuzz tests.)  In-contract degenerate cells keep
    the ADMM (bitwise-pinned committed artifacts) — covered by
    test_linear_regime's auto-vs-xla case."""
    import online_convex_optimization.models.ssn as ssn_mod
    from online_convex_optimization.experiments import evaluate as ev

    def builder(run_seed=0):
        def sampler(T, rep=0):
            rng = np.random.default_rng(run_seed + 31 * rep)
            z = 2.0 * rng.normal(size=(T, 5))
            y = np.sign(z @ rng.normal(size=5) + 0.3 * rng.normal(size=T))
            y[y == 0] = 1.0
            return z, y
        return sampler

    calls = {"n": 0}
    orig = ssn_mod.ssn_all_prefixes

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    ev._band_programs.cache_clear()   # drop jitted closures over the orig
    ssn_mod.ssn_all_prefixes = counting
    try:
        kw = dict(T_grid=[24, 40], runs=1, replicates=2, iters=1200,
                  dtype=np.float64, stream_name="ooc-auto", progress=False)
        s_a = ev.evaluate_stream_exact(builder, solver="auto", **kw)
    finally:
        ssn_mod.ssn_all_prefixes = orig
        ev._band_programs.cache_clear()
    assert calls["n"] > 0, "auto did not route the OOC cells through SSN"
    s_s = ev.evaluate_stream_exact(builder, solver="ssn", **kw)
    for key in s_s:
        np.testing.assert_allclose(s_a[key][0], s_s[key][0], rtol=0,
                                   atol=0)


def test_auto_routes_ooc_to_ssn_without_x64():
    """'auto' routes out-of-contract cells to the SSN in the f32 regime
    too (r5): the round-4 'certificate costs 31x' measurement was a
    budget bug (the ADMM's iters=2000 passed as a NEWTON budget —
    evaluate._SSN_NEWTON_BUDGET); at the measured 80-step envelope the
    f32 SSN runs 1.26x the warm ADMM while certifying 98.1% vs 92.0%
    (scripts/ssn_onchip_probe.py, BENCH_DETAILS ssn_f32_*)."""
    import jax

    import online_convex_optimization.models.ssn as ssn_mod
    from online_convex_optimization.experiments import evaluate as ev

    def builder(run_seed=0):
        def sampler(T, rep=0):
            rng = np.random.default_rng(run_seed + 7 * rep)
            z = 2.0 * rng.normal(size=(T, 5))
            y = np.sign(z @ rng.normal(size=5) + 0.3 * rng.normal(size=T))
            y[y == 0] = 1.0
            return z, y
        return sampler

    calls = {"n": 0}
    orig = ssn_mod.ssn_all_prefixes

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    ev._band_programs.cache_clear()
    ssn_mod.ssn_all_prefixes = counting
    prev_x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        audit = {}
        ev.evaluate_stream_exact(
            builder, T_grid=[24], runs=1, replicates=1, iters=1200,
            dtype=np.float32, stream_name="ooc-auto-f32", progress=False,
            solver="auto", audit_out=audit)
    finally:
        jax.config.update("jax_enable_x64", prev_x64)
        ssn_mod.ssn_all_prefixes = orig
        ev._band_programs.cache_clear()
    assert calls["n"] > 0, "auto failed to route OOC cells to f32 SSN"
    assert audit["cells_ssn"] > 0 and audit["cells_admm"] == 0, audit


# ---------------- linf-ball SSN (round 5) ----------------

def _lp_linf(z, y):
    from scipy.optimize import linprog

    T, d = z.shape
    A = np.block([[z, -np.eye(T)], [-z, -np.eye(T)]])
    b = np.concatenate([y, -y])
    c = np.concatenate([np.zeros(d), 0.5 * np.ones(T)])
    res = linprog(c, A_ub=A, b_ub=b, bounds=[(-1, 1)] * d + [(0, None)] * T,
                  method="highs")
    return res.x[:d], res.fun


def test_box_newton_step_matches_reference_qp():
    """The linf model subproblem solver (projected Newton + arc ladder +
    exact CD pass) reaches the reference box-QP optimum across a
    conditioning fuzz; inexactness only slows the outer loop, but the
    solver must be reliably NEAR-exact for the Newton model to bite."""
    import jax.numpy as jnp
    from scipy.optimize import minimize

    from online_convex_optimization.models.ssn import _box_newton_step

    rng = np.random.default_rng(11)
    d, N = 5, 64
    Hs, bs = [], []
    for _ in range(N):
        A = rng.normal(size=(d, d)) * (10.0 ** rng.uniform(-2, 1))
        Hs.append(A @ A.T + 10.0 ** rng.uniform(-6, 0) * np.eye(d))
        bs.append(rng.normal(size=d) * (10.0 ** rng.uniform(-1, 1)))
    v = np.asarray(_box_newton_step(jnp.asarray(np.stack(Hs)),
                                    jnp.asarray(np.stack(bs)), d,
                                    jnp.float64)[0])
    assert np.abs(v).max() <= 1.0 + 1e-12
    bad = 0
    for i in range(N):
        f = lambda x: 0.5 * x @ Hs[i] @ x + bs[i] @ x
        ref = minimize(f, np.zeros(d), jac=lambda x: Hs[i] @ x + bs[i],
                       bounds=[(-1, 1)] * d, method="L-BFGS-B",
                       options={"ftol": 1e-15, "gtol": 1e-12,
                                "maxiter": 500})
        if (f(v[i]) - ref.fun) / (1.0 + abs(ref.fun)) > 1e-6:
            bad += 1
    assert bad <= 2, f"{bad}/{N} box QPs solved poorly"


def test_ssn_linf_matches_lp_objectives():
    """linf-ball SSN prefix solves hit the HiGHS LP optima; the duality
    gap residual is RIGOROUS (never below the true suboptimality)."""
    import jax
    import jax.numpy as jnp

    if not jax.config.jax_enable_x64:
        pytest.skip("linf SSN is x64-only")
    from online_convex_optimization.models.ssn import ssn_all_prefixes

    rng = np.random.default_rng(3)
    T, d = 40, 5
    z = 2.0 * rng.normal(size=(T, d))
    y = np.sign(z @ rng.normal(size=d) + 0.5 * rng.normal(size=T))
    y[y == 0] = 1.0
    X, res, _ = ssn_all_prefixes(jnp.asarray(z), jnp.asarray(y),
                                 iters=300, tol=1e-6, norm="linf")
    X = np.asarray(X)
    res = np.asarray(res)
    for t in range(1, T + 1):
        assert np.abs(X[t - 1]).max() <= 1.0 + 1e-10
        f_ssn = 0.5 * np.abs(z[:t] @ X[t - 1] - y[:t]).sum()
        _, f_lp = _lp_linf(z[:t], y[:t])
        # Primal quality: certified rows must be within their gap of f*.
        true_sub = (f_ssn - f_lp) / (1.0 + f_ssn)
        assert res[t - 1] >= true_sub - 1e-9, (t, res[t - 1], true_sub)
        if res[t - 1] <= 2e-4:
            assert f_ssn <= f_lp + 2e-4 * (1.0 + f_lp) + 1e-9, t
    assert (res <= 2e-4).mean() >= 0.9
    assert np.median(res) <= 1e-6


def test_exact_ftl_ssn_linf_end_to_end():
    """ExactFTL(method='ssn', norm='linf') produces LP-grade prefix
    objectives through the full prefix_actions + polish pipeline."""
    import jax

    if not jax.config.jax_enable_x64:
        pytest.skip("linf SSN is x64-only")
    from online_convex_optimization.models.exact_ftl import ExactFTL

    rng = np.random.default_rng(5)
    T, d = 28, 5
    z = 1.5 * rng.normal(size=(T, d))
    y = np.sign(z @ rng.normal(size=d))
    y[y == 0] = 1.0
    # fail_tol at the measured linf certification envelope (~96% of
    # prefixes certify at 2e-4; the tail's rigorous gaps reach ~5e-3 —
    # the PRIMAL there is still LP-grade, as asserted below).
    m = ExactFTL(d=d, T_max=T, norm="linf", method="ssn", fail_tol=3e-2)
    acts = m.prefix_actions(z, y)
    good = 0
    for t in range(1, T + 1):
        f_m = 0.5 * np.abs(z[:t] @ acts[t] - y[:t]).sum()
        _, f_lp = _lp_linf(z[:t], y[:t])
        assert f_m <= f_lp + 3e-2 * (1 + f_lp), (t, f_m, f_lp)
        good += f_m <= f_lp + 1e-6 + 1e-6 * f_lp
    assert good >= 0.9 * T, good


def test_ssn_l1_norm_raises():
    import jax.numpy as jnp

    from online_convex_optimization.models.ssn import ssn_all_prefixes

    with pytest.raises(NotImplementedError):
        ssn_all_prefixes(jnp.zeros((4, 5)), jnp.zeros(4), norm="l1")
