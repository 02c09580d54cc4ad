"""Golden f64 oracle: a from-scratch restatement of the reference semantics.

BASELINE.md sets the parity bar as "iterates + cumulative regret within 1e-6
of the reference's Numba implementation (fast_algorithms.py)".  Numba is not
available in this image, so this module restates those semantics — per-step
math order included — in plain float64 NumPy, to serve as the oracle the
JAX implementations are tested against.  A faster C++ twin lives in
``native/`` (loaded via utils.native) and is cross-checked against this one.

Semantics sources (all /root/reference/fast_algorithms.py):
  - loss / tie-exact subgradient                     : lines 19-34
  - FTL action (norm_sq == 0 guard)                  : lines 37-49
  - FTRL action (project iff norm_sq > 1)            : lines 52-66
  - FTL/FTRL simulation + final-FTL comparator       : lines 88-115
  - single-switch SMART with prefix recompute        : lines 118-164

Everything here is deliberately simple and slow — it is a test oracle, not
a compute path.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from online_convex_optimization.data.sequences import sample_g_instance


def _ftl(theta: np.ndarray) -> np.ndarray:
    n_sq = float(theta @ theta)
    if n_sq == 0.0:
        return np.zeros_like(theta)
    return (-1.0 / math.sqrt(n_sq)) * theta


def _ftrl(theta: np.ndarray, t: int, eta0: float) -> np.ndarray:
    x = (-(eta0 / math.sqrt(max(1, t)))) * theta
    n_sq = float(x @ x)
    if n_sq > 1.0:
        x *= 1.0 / math.sqrt(n_sq)
    return x


def _grad(q: float, y: float) -> float:
    diff = q - y
    if diff > 0.0:
        return 0.5
    if diff < 0.0:
        return -0.5
    return 0.0


def _hinge(q: float, y: float) -> float:
    return 0.5 * abs(q - y)


def golden_simulate_alg(z: np.ndarray, y: np.ndarray, alg_flag: int,
                        eta0: float) -> float:
    """Regret of FTRL (flag 0) / FTL (flag 1) vs the final-FTL comparator."""
    z = np.ascontiguousarray(z, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    T, d = z.shape
    theta = np.zeros(d)
    cum_loss = 0.0
    for t in range(T):
        x = _ftrl(theta, t + 1, eta0) if alg_flag == 0 else _ftl(theta)
        q = float(z[t] @ x)
        y_t = float(y[t])
        cum_loss += _hinge(q, y_t)
        theta += _grad(q, y_t) * z[t]
    x_c = _ftl(theta)
    comp_loss = float(np.sum(0.5 * np.abs(z @ x_c - y)))
    return cum_loss - comp_loss


def golden_simulate_smart(z: np.ndarray, y: np.ndarray, theta_thresh: float,
                          eta0: float, *, return_switch: bool = False):
    """Single-switch SMART regret; optionally also the switch round."""
    z = np.ascontiguousarray(z, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    T, d = z.shape
    theta_ftl = np.zeros(d)
    theta_ftrl = np.zeros(d)
    switched = False
    switch_t = T
    ftl_loss = 0.0
    total_loss = 0.0
    for t in range(T):
        z_t = z[t]
        y_t = float(y[t])

        x = _ftl(theta_ftl)
        pred_ftl = float(z_t @ x)
        theta_ftl += _grad(pred_ftl, y_t) * z_t
        loss_ftl = _hinge(pred_ftl, y_t)
        ftl_loss += loss_ftl

        if switched:
            x = _ftrl(theta_ftrl, t + 1, eta0)
            pred = float(z_t @ x)
            total_loss += _hinge(pred, y_t)
            theta_ftrl += _grad(pred, y_t) * z_t
        else:
            total_loss += loss_ftl
            s = _ftl(theta_ftl)
            s_loss = float(np.sum(0.5 * np.abs(z[: t + 1] @ s - y[: t + 1])))
            if ftl_loss - s_loss >= theta_thresh:
                switched = True
                switch_t = t

    s = _ftl(theta_ftl)
    comp_loss = float(np.sum(0.5 * np.abs(z @ s - y)))
    regret = total_loss - comp_loss
    if return_switch:
        return regret, switch_t
    return regret


def golden_empirical_thresholds(T_grid, *, runs: int = 5, base_seed: int = 0,
                                dtype=np.float64) -> Dict[int, float]:
    """max FTRL regret over ``runs`` random instances per T
    (fast_algorithms.py:211-247)."""
    g: Dict[int, float] = {}
    for T_val in np.asarray(T_grid):
        T = int(T_val)
        max_regret = 0.0
        for r in range(runs):
            z, y = sample_g_instance(base_seed, T, r, dtype=dtype)
            reg = golden_simulate_alg(z, y, alg_flag=0, eta0=math.sqrt(2))
            if reg > max_regret:
                max_regret = reg
        g[T] = max_regret
    return g
