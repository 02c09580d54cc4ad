"""Canonical selection on degenerate exact-FTL optima (models/canonical.py).

The contract: canonical action = min-l2-norm point of the optimal face,
verified by an exact subgradient-feasibility LP — solver-independent by
construction (VERDICT round-2 task 2; docs/DESIGN.md)."""

import numpy as np
import pytest

from online_convex_optimization.data.sequences import CASES
from online_convex_optimization.models.canonical import (
    canonical_prefix_actions,
    canonicalize,
)
from online_convex_optimization.models.exact_ftl import ExactFTL
from online_convex_optimization.models.polish import objective


def test_slab_flat_canonicalizes_to_zero():
    """Two identical rows with opposite labels: f = max(|z.x|, 1) is flat
    on the slab |z.x| <= 1; min-norm point = 0."""
    z = np.array([[0.8, 0.0, 0.0, 0.0, 0.0]] * 2)
    y = np.array([1.0, -1.0])
    x_far = np.array([0.0, 0.9, 0.0, 0.0, 0.0])   # also optimal (slab)
    assert objective(z, y, x_far) == objective(z, y, np.zeros(5))
    np.testing.assert_allclose(canonicalize(z, y, x_far), np.zeros(5))


def test_interpolation_face_canonicalizes_to_lstsq():
    """Interpolable prefix with a rank-deficient row set: the optimal
    face is an affine flat; canonical point = min-norm interpolant."""
    rng = np.random.default_rng(0)
    z = 0.4 * rng.normal(size=(3, 5))
    u = rng.normal(size=5)
    y = z @ (0.25 * u / np.linalg.norm(u))       # consistent, rank 3 < 5
    x_min, *_ = np.linalg.lstsq(z, y, rcond=None)
    assert np.linalg.norm(x_min) < 0.5           # interpolants in-ball
    # Another exact interpolant, larger norm (move along the null space).
    from scipy.linalg import null_space
    x_other = x_min + 0.3 * null_space(z)[:, 0]
    assert np.linalg.norm(x_other) <= 1.0
    assert objective(z, y, x_other) < 1e-12
    got = canonicalize(z, y, x_other)
    np.testing.assert_allclose(got, x_min, atol=1e-9)


def test_unique_optimum_is_identity():
    rng = np.random.default_rng(2)
    z = 2.0 * rng.normal(size=(30, 5))
    y = np.sign(rng.normal(size=30))
    m = ExactFTL(d=5, T_max=30, norm="l2", iters=3000, allow_linear=False)
    x = m.solve_full(z, y)
    got = canonicalize(z, y, x)
    # Never degrades; on generic data usually the identity.
    assert objective(z, y, got) <= objective(z, y, x) + 1e-9
    assert np.linalg.norm(got) <= np.linalg.norm(x) + 1e-12


@pytest.mark.parametrize("title", ["Label flips", "Switching leaders"])
def test_deterministic_families_solver_independent(title):
    """Both solver paths (ADMM and SSN) canonicalize to the SAME point on
    the w=0 flats, which also matches the direct LP-verified closed-form
    trajectory."""
    sampler = CASES[title](run_seed=2025)
    z, y = sampler(24, rep=0)[:2]
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    direct = canonical_prefix_actions(z, y)
    assert direct is not None
    for method in ("admm", "ssn"):
        m = ExactFTL(d=5, T_max=24, norm="l2", iters=3000, method=method)
        acts = m.prefix_actions(z, y)
        for t in range(1, 25):
            canon = canonicalize(z[:t], y[:t], acts[t])
            np.testing.assert_allclose(canon, direct[t], atol=1e-7,
                                       err_msg=f"{method} t={t}")
            # Canonical action is exactly optimal.
            assert (objective(z[:t], y[:t], direct[t])
                    <= objective(z[:t], y[:t], acts[t]) + 1e-9)


def _lp_exact(z, y, norm):
    """Direct HiGHS solve of min 0.5*sum s, s >= +-(Zx - y), ||x|| <= 1
    for the linf/l1 balls (LP-exact oracles for the canonical tests)."""
    from scipy.optimize import linprog

    T, d = z.shape
    if norm == "linf":
        # vars: x (d, in [-1,1]), s (T)
        A = np.block([[z, -np.eye(T)], [-z, -np.eye(T)]])
        b = np.concatenate([y, -y])
        c = np.concatenate([np.zeros(d), 0.5 * np.ones(T)])
        bounds = [(-1, 1)] * d + [(0, None)] * T
        res = linprog(c, A_ub=A, b_ub=b, bounds=bounds, method="highs")
        return res.x[:d], res.fun
    # l1: x = p - q, p,q >= 0, sum(p+q) <= 1
    A_res = np.block([[z, -z, -np.eye(T)], [-z, z, -np.eye(T)]])
    b_res = np.concatenate([y, -y])
    A_ball = np.concatenate([np.ones(2 * d), np.zeros(T)])[None, :]
    c = np.concatenate([np.zeros(2 * d), 0.5 * np.ones(T)])
    bounds = [(0, None)] * (2 * d + T)
    res = linprog(c, A_ub=np.vstack([A_res, A_ball]),
                  b_ub=np.concatenate([b_res, [1.0]]), bounds=bounds,
                  method="highs")
    return res.x[:d] - res.x[d:2 * d], res.fun


@pytest.mark.parametrize("norm", ["linf", "l1"])
@pytest.mark.parametrize("title", ["Label flips", "Switching leaders"])
def test_canonical_nonl2_matches_lp(norm, title):
    """The non-l2 canonical ladder (VERDICT r4 task 4): on the w=0
    deterministic families the l1/linf canonical trajectory exists, is
    LP-verified optimal per prefix, and is idempotent under
    canonicalize."""
    sampler = CASES[title](run_seed=2025)
    z, y = sampler(12, rep=0)[:2]
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    acts = canonical_prefix_actions(z, y, norm=norm)
    assert acts is not None
    for t in range(1, 13):
        _, f_lp = _lp_exact(z[:t], y[:t], norm)
        f_c = objective(z[:t], y[:t], acts[t])
        assert f_c <= f_lp + 1e-9, (norm, t, f_c, f_lp)
        again = canonicalize(z[:t], y[:t], acts[t], norm=norm)
        np.testing.assert_allclose(again, acts[t], atol=1e-12)


def test_canonical_prefix_actions_rejects_unstructured():
    rng = np.random.default_rng(5)
    z = rng.normal(size=(30, 5))
    y = np.sign(rng.normal(size=30))
    assert canonical_prefix_actions(z, y) is None   # > 6 distinct groups


def test_evaluate_selection_canonical_dedups_deterministic(tmp_path):
    """selection='canonical' routes the deterministic families through
    the host-side canonical path (audit: cells_canonical) — no device
    solver — and produces finite stats."""
    from online_convex_optimization.experiments.evaluate import (
        evaluate_stream_exact)

    audit = {}
    stats = evaluate_stream_exact(
        CASES["Label flips"], T_grid=[20, 40], runs=1, replicates=1,
        iters=800, dtype=np.float64, progress=False, selection="canonical",
        audit_out=audit, stream_name="canon")
    assert audit["cells_canonical"] == 2
    assert audit["cells_admm"] == 0
    for k, (m, c) in stats.items():
        assert np.isfinite(m).all()
