"""Algorithm simulators (reference layer 3 equivalents) as lax.scan programs."""

from online_convex_optimization.models.base import RunResult
from online_convex_optimization.models.linear import (
    simulate_linear,
    simulate_linear_batch,
    ALG_FTRL,
    ALG_FTL,
)
from online_convex_optimization.models.quadratic import (
    simulate_quadratic,
    simulate_quadratic_batch,
)
from online_convex_optimization.models.linear_regime import (
    certified_full_solution,
    certified_prefix_actions,
)
from online_convex_optimization.models.smart import (
    simulate_smart,
    simulate_smart_batch,
)

__all__ = [
    "RunResult",
    "certified_full_solution",
    "certified_prefix_actions",
    "simulate_linear",
    "simulate_linear_batch",
    "simulate_quadratic",
    "simulate_quadratic_batch",
    "simulate_smart",
    "simulate_smart_batch",
    "ALG_FTRL",
    "ALG_FTL",
]
