"""Batched prefix polish == scalar per-prefix polish.

The batched path (models/polish.py::polish_prefix_actions) replaces the
per-prefix Python loop with masked-Gram BLAS + batched eigh pseudo-
inverses; every candidate is still verified exactly (feasibility + true
f64 objective), so it may only improve on the scalar loop.  These tests
pin the agreement per prefix on randomized instances for all three norms
and the never-loses contract against the raw (unpolished) input.
"""

import numpy as np
import pytest

from online_convex_optimization.models.polish import (
    _polish_prefix_actions_loop,
    objective,
    polish_prefix_actions,
)


def _instance(T, d, seed, noise=0.3):
    r = np.random.default_rng(seed)
    z = r.normal(size=(T, d))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=1, keepdims=True))
    u = r.normal(size=d)
    u /= np.linalg.norm(u)
    y = np.sign(z @ u + noise * r.normal(size=T))
    return z, y


def _noisy_trajectory(z, y, norm, seed, scale=1e-5):
    """A near-optimal trajectory with ADMM-like noise: run the scalar
    polish from zero, then perturb — mimics what the device solve feeds."""
    T, d = z.shape
    base = _polish_prefix_actions_loop(z, y, np.zeros((T + 1, d)), norm)
    r = np.random.default_rng(seed)
    acts = base.copy()
    acts[1:] += scale * r.normal(size=(T, d))
    if norm == "l2":
        nrm = np.linalg.norm(acts[1:], axis=1, keepdims=True)
        acts[1:] /= np.maximum(nrm, 1.0)
    elif norm == "linf":
        acts[1:] = np.clip(acts[1:], -1.0, 1.0)
    else:
        l1 = np.abs(acts[1:]).sum(axis=1, keepdims=True)
        acts[1:] /= np.maximum(l1, 1.0)
    return acts


@pytest.mark.parametrize("norm", ["l2", "linf", "l1"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_matches_scalar_loop(norm, seed):
    z, y = _instance(60, 5, seed)
    acts = _noisy_trajectory(z, y, norm, seed + 100)
    a_loop = _polish_prefix_actions_loop(z, y, acts, norm)
    a_batch = polish_prefix_actions(z, y, acts, norm)
    for p in range(1, 61):
        fl = objective(z[:p], y[:p], a_loop[p])
        fb = objective(z[:p], y[:p], a_batch[p])
        assert fb <= fl + 1e-10, (p, fb - fl)
        assert fl <= fb + 1e-10, (p, fl - fb)


@pytest.mark.parametrize("norm", ["l2", "linf", "l1"])
def test_batch_never_loses_and_feasible(norm):
    z, y = _instance(50, 5, 7)
    r = np.random.default_rng(8)
    acts = np.zeros((51, 5))
    acts[1:] = 0.4 * r.normal(size=(50, 5))  # arbitrary (poor) start
    if norm == "l2":
        acts[1:] /= np.maximum(
            np.linalg.norm(acts[1:], axis=1, keepdims=True), 1.0)
    elif norm == "linf":
        acts[1:] = np.clip(acts[1:], -1.0, 1.0)
    else:
        acts[1:] /= np.maximum(np.abs(acts[1:]).sum(axis=1, keepdims=True),
                               1.0)
    a = polish_prefix_actions(z, y, acts, norm)
    np.testing.assert_array_equal(a[0], 0.0)
    for p in range(1, 51):
        assert objective(z[:p], y[:p], a[p]) <= \
            objective(z[:p], y[:p], acts[p]) + 1e-12
        if norm == "l2":
            assert np.linalg.norm(a[p]) <= 1.0 + 1e-9
        elif norm == "linf":
            assert np.abs(a[p]).max() <= 1.0 + 1e-9
        else:
            assert np.abs(a[p]).sum() <= 1.0 + 1e-9


def test_lengths_subset_only_touches_listed_rows():
    z, y = _instance(30, 5, 11)
    acts = _noisy_trajectory(z, y, "l2", 12)
    lengths = np.array([3, 7, 20])
    a = polish_prefix_actions(z, y, acts, "l2", lengths=lengths)
    for p in range(31):
        if p in (3, 7, 20):
            assert objective(z[:p], y[:p], a[p]) <= \
                objective(z[:p], y[:p], acts[p]) + 1e-12
        else:
            np.testing.assert_array_equal(a[p], acts[p])


def test_empty_lengths_is_identity():
    z, y = _instance(10, 5, 13)
    acts = np.ones((11, 5)) * 0.1
    a = polish_prefix_actions(z, y, acts, "l2", lengths=np.array([], int))
    np.testing.assert_array_equal(a, acts)


def test_unknown_norm_raises():
    z, y = _instance(5, 5, 14)
    with pytest.raises(ValueError):
        polish_prefix_actions(z, y, np.zeros((6, 5)), "l3")
