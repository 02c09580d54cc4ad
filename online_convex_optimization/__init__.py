"""Online convex optimization framework (JAX; GPU kernels via Pallas).

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``revvu/online_convex_optimization`` (online linear binary classification
under the normalized hinge loss): FTL, FTRL, single-switch SMART,
empirical-g SMART, and an exact follow-the-leader oracle, evaluated for
cumulative regret across adversarial and stochastic sequence families.

Architecture (see SURVEY.md for the reference layer map):

- ``ops``      : fused step math (hinge loss, tie-exact subgradient, FTL /
                 FTRL actions, ball projections) + Pallas/Triton GPU
                 kernels.
- ``models``   : ``lax.scan`` algorithm simulators (FTRL/FTL/SMART/exact-FTL)
                 with a reference-compatible functional API, plus the
                 quadratic-loss exact-leader track and kernel-speed
                 streaming for horizons beyond device memory.
- ``data``     : sequence families + stream builders.  Host NumPy path uses
                 the reference's exact PCG64 seed schedules for bitwise input
                 parity; a ``jax.random`` device path serves pure-throughput
                 benchmarks.
- ``parallel`` : device mesh / shard_map scenario sweeps with psum/pmax
                 reductions.
- ``experiments``: config tree, empirical g(T) estimation, per-case regret
                 evaluation, figures, structured results, checkpointing.
- ``utils``    : stats (SEM/CI sufficient statistics), profiling, native
                 C++ library loader.
- ``testing``  : f64 golden reimplementation of the reference semantics
                 (the parity oracle; the reference's Numba path is the
                 numerical target per BASELINE.md).
"""

from online_convex_optimization.models.api import (
    simulate_alg,
    simulate_SMART,
    simulate_SMART_like,
    simulate_empirical_g_SMART,
    empirical_worst_case_thresholds,
)
from online_convex_optimization.models.base import RunResult

__version__ = "0.1.0"

__all__ = [
    "simulate_alg",
    "simulate_SMART",
    "simulate_SMART_like",
    "simulate_empirical_g_SMART",
    "empirical_worst_case_thresholds",
    "RunResult",
    "__version__",
]
