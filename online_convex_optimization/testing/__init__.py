"""Parity oracles: f64 reimplementations of the reference semantics."""

from online_convex_optimization.testing.golden import (
    golden_simulate_alg,
    golden_simulate_smart,
    golden_empirical_thresholds,
)

__all__ = [
    "golden_simulate_alg",
    "golden_simulate_smart",
    "golden_empirical_thresholds",
]
