"""Sequence generation (reference layer 1 equivalents).

Host-NumPy builders reproduce the reference's PCG64 seed schedules exactly
(bitwise-identical inputs are a precondition for the 1e-6 regret-parity
bar, SURVEY.md §7); the ``device`` module provides a ``jax.random`` path for
pure-throughput benchmarks.
"""

from online_convex_optimization.data.rng import rng_stream
from online_convex_optimization.data.sequences import (
    CASES,
    RUNS_BY_TITLE,
    REPLICATES_BY_TITLE,
    flip_sequence,
    switching_two_leaders_sequence,
    make_random_iid_stream,
    make_noisy_iid_stream,
    make_flip_stream,
    make_switching_two_leaders_stream,
    sample_g_instance,
    sample_g_batch,
    stack_replicates,
)

__all__ = [
    "rng_stream",
    "CASES",
    "RUNS_BY_TITLE",
    "REPLICATES_BY_TITLE",
    "flip_sequence",
    "switching_two_leaders_sequence",
    "make_random_iid_stream",
    "make_noisy_iid_stream",
    "make_flip_stream",
    "make_switching_two_leaders_stream",
    "sample_g_instance",
    "sample_g_batch",
    "stack_replicates",
]
