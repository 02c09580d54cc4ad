"""Numerical-safety utilities (SURVEY.md §5 "race detection / sanitizers"
and "failure detection" equivalents for a functional JAX stack).

The reference's only failure handling is raising on a failed CVXPY solve
(exact_ftl.py:125-126), which would kill a whole vmapped batch here.  The
JAX-native replacements:

  - ``checked``: checkify-wrap a jitted function so NaN/OOB inside scan
    bodies surface as errors with locations instead of silent garbage;
  - ``finite_or_sentinel``: per-element failure containment for sweeps —
    a diverged scenario becomes a sentinel the aggregation can drop,
    instead of an exception (max/mean reductions then use nan-aware ops);
  - ``debug_nans``: scoped jax_debug_nans toggle for interactive hunts.
"""

from __future__ import annotations

import contextlib
from functools import wraps

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def checked(fn, *, errors=checkify.float_checks):
    """Wrap ``fn`` with checkify; returns (err, out) raising on err."""

    @wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = checkify.checkify(fn, errors=errors)(*args, **kwargs)
        err.throw()
        return out

    return wrapper


def finite_or_sentinel(x: jnp.ndarray, sentinel: float = jnp.nan) -> jnp.ndarray:
    """Replace non-finite entries so one diverged scenario cannot poison a
    sweep reduction (use nanmax/nanmean downstream)."""
    return jnp.where(jnp.isfinite(x), x, sentinel)


def drop_nonfinite_stats(regrets: jnp.ndarray):
    """(n_valid, max, mean) over the finite entries of a regret vector."""
    finite = jnp.isfinite(regrets)
    n = jnp.sum(finite)
    safe = jnp.where(finite, regrets, 0.0)
    total = jnp.sum(safe)
    mx = jnp.max(jnp.where(finite, regrets, -jnp.inf))
    return n, mx, total / jnp.maximum(n, 1)


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
