"""Reference-compatible functional API (drop-in surface).

Function names, signatures, and defaults mirror the reference's public
layer-3 interface so a user of ``revvu/online_convex_optimization`` can
switch imports unchanged:

  - ``simulate_alg(z, y, alg_flag, eta0) -> float``
                                  : algorithms.py:28-54 / fast_algorithms.py:171-177
  - ``simulate_SMART_like(z, y, theta_thresh, eta0) -> float``
                                  : algorithms.py:65-120 / fast_algorithms.py:184-195
  - ``simulate_SMART(z, y, *, eta0=sqrt(2))``         : algorithms.py:123-125
  - ``simulate_empirical_g_SMART(z, y, theta_emp, *, eta0=sqrt(2))``
                                  : algorithms.py:127-128
  - ``empirical_worst_case_thresholds(T_grid, *, runs=5, base_seed=0)``
                                  : algorithms.py:135-171

Under the hood everything routes through the batched ``lax.scan`` paths —
``empirical_worst_case_thresholds`` in particular runs all ``runs``
instances of a horizon as ONE device batch instead of a Python loop.

Precision: computation runs in float64 when JAX x64 mode is enabled
(matching the reference's Numba-f64 parity target) and float32 otherwise.
"""

from __future__ import annotations

import math
from typing import Dict

import jax
import numpy as np

from online_convex_optimization.data.sequences import sample_g_batch
from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.models.smart import simulate_smart_batch


def _working_dtype():
    return np.float64 if jax.config.jax_enable_x64 else np.float32


def _as_batch(z: np.ndarray, y: np.ndarray):
    dtype = _working_dtype()
    z = np.asarray(z, dtype=dtype)
    y = np.asarray(y, dtype=dtype)
    if z.ndim == 2:
        return z[None], y[None], True
    return z, y, False


def simulate_alg(z, y, alg_flag: int, eta0: float):
    """Regret of FTRL (``alg_flag == 0``) / FTL (``alg_flag == 1``).

    Accepts a single ``(T, d)`` sequence (returns a float, like the
    reference) or a ``(B, T, d)`` batch (returns a ``(B,)`` array).
    """
    zb, yb, single = _as_batch(z, y)
    res = simulate_linear_batch(zb, yb, int(alg_flag), float(eta0))
    reg = np.asarray(res.regret)
    return float(reg[0]) if single else reg


def simulate_SMART_like(z, y, theta_thresh: float, eta0: float):
    """Single-switch SMART: FTL until its regret lead exceeds
    ``theta_thresh``, then an independent FTRL track."""
    zb, yb, single = _as_batch(z, y)
    res = simulate_smart_batch(zb, yb, float(theta_thresh), float(eta0))
    reg = np.asarray(res.regret)
    return float(reg[0]) if single else reg


def simulate_SMART(z, y, *, eta0: float = math.sqrt(2)):
    """SMART with the theoretical threshold ``sqrt(2T)``
    (algorithms.py:123-125)."""
    T = np.asarray(z).shape[-2]
    return simulate_SMART_like(z, y, theta_thresh=math.sqrt(2 * T), eta0=eta0)


def simulate_empirical_g_SMART(z, y, theta_emp: float, *,
                               eta0: float = math.sqrt(2)):
    """SMART with an empirically estimated threshold g(T)
    (algorithms.py:127-128)."""
    return simulate_SMART_like(z, y, theta_thresh=theta_emp, eta0=eta0)


def empirical_worst_case_thresholds(
    T_grid,
    *,
    runs: int = 5,
    base_seed: int = 0,
    eta0: float = math.sqrt(2),
    d: int = 5,
    progress: bool = False,
) -> Dict[int, float]:
    """Empirical worst-case FTRL regret g(T) per horizon.

    For each T: sample ``runs`` i.i.d. instances with the reference's exact
    seed schedule, run FTRL on all of them as one device batch, and take the
    max regret (algorithms.py:135-171 — there, a sequential Python loop).
    """
    iterator = np.asarray(T_grid)
    if progress:
        try:
            from tqdm import tqdm
            iterator = tqdm(iterator, desc="Estimating g(T) on random sequences")
        except ImportError:
            pass

    dtype = _working_dtype()
    g_emp: Dict[int, float] = {}
    for T_val in iterator:
        T = int(T_val)
        z, y = sample_g_batch(base_seed, T, runs, d=d, dtype=dtype)
        res = simulate_linear_batch(z, y, 0, float(eta0))
        # The reference folds max(0, .) in via max_regret's 0.0 init
        # (algorithms.py:151,166-169).
        g_emp[T] = float(max(0.0, np.max(np.asarray(res.regret))))
    return g_emp
