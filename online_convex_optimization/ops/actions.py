"""Action rules and norm-ball projections.

Parity targets in the reference (/root/reference):
  - FTL action  ``x = -theta / ||theta||_2`` (zero vector when theta == 0)
                                      : fast_algorithms.py:37-49
  - FTRL action ``x = -(eta0/sqrt(max(1,t))) * theta`` then scale to the
    unit L2 ball iff ``||x||^2 > 1``  : fast_algorithms.py:52-66
  - ball norms for the exact oracle (l2 SOCP / l1 & linf LP constraints)
                                      : exact_ftl.py:96-100

All functions operate on the trailing axis so they vmap/broadcast over
arbitrary leading batch axes without change — the batched accelerator path and the
single-sequence parity path share one implementation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _sqrt_exact(x: jnp.ndarray) -> jnp.ndarray:
    """``sqrt`` wrapped in an optimization barrier.

    XLA's algebraic simplifier rewrites ``a / sqrt(b)`` into ``a * rsqrt(b)``,
    which differs from the reference's C-double ``a / sqrt(b)`` by 1 ulp.
    Those ulps flip tie subgradients (``q == y`` exactly) on the adversarial
    ``z = e1`` families, so trajectory parity requires a genuine division.
    The barrier hides the sqrt from the pattern-matcher; the cost is one
    fusion boundary on a tiny intermediate.
    """
    return jax.lax.optimization_barrier(jnp.sqrt(x))


def ftl_action(theta: jnp.ndarray) -> jnp.ndarray:
    """Linearized follow-the-leader action: argmin of <theta, x> on the unit
    L2 ball, i.e. ``-theta/||theta||`` with the zero vector at ``theta == 0``.

    Mirrors fast_algorithms.py:37-49 (``scale = -1/sqrt(norm_sq)``).
    """
    norm_sq = jnp.sum(theta * theta, axis=-1, keepdims=True)
    scale = jnp.where(
        norm_sq > 0.0,
        -1.0 / _sqrt_exact(jnp.where(norm_sq > 0.0, norm_sq, 1.0)),
        0.0,
    )
    return scale * theta


def ftrl_action(theta: jnp.ndarray, t: jnp.ndarray, eta0) -> jnp.ndarray:
    """FTRL action with step size ``eta0/sqrt(max(1, t))`` projected onto the
    unit L2 ball.

    ``t`` is the 1-based round index (scalar or batched, broadcastable
    against ``theta``'s leading axes).  Mirrors fast_algorithms.py:52-66:
    the projection triggers strictly when ``||x||^2 > 1`` and rescales by
    ``1/sqrt(norm_sq)``.
    """
    t = jnp.asarray(t, dtype=theta.dtype)
    scale = -(eta0 / _sqrt_exact(jnp.maximum(1.0, t)))
    x = scale[..., None] * theta if scale.ndim == theta.ndim - 1 else scale * theta
    norm_sq = jnp.sum(x * x, axis=-1, keepdims=True)
    factor = jnp.where(
        norm_sq > 1.0,
        1.0 / _sqrt_exact(jnp.where(norm_sq > 0.0, norm_sq, 1.0)),
        1.0,
    )
    return x * factor


def project_l2_ball(x: jnp.ndarray, radius: float = 1.0) -> jnp.ndarray:
    """Euclidean projection onto ``{x : ||x||_2 <= radius}``."""
    norm_sq = jnp.sum(x * x, axis=-1, keepdims=True)
    r_sq = radius * radius
    factor = jnp.where(
        norm_sq > r_sq,
        radius / _sqrt_exact(jnp.where(norm_sq > 0.0, norm_sq, 1.0)),
        1.0,
    )
    return x * factor


def project_linf_ball(x: jnp.ndarray, radius: float = 1.0) -> jnp.ndarray:
    """Projection onto ``{x : ||x||_inf <= radius}`` (coordinate clamp)."""
    return jnp.clip(x, -radius, radius)


def project_l1_ball(x: jnp.ndarray, radius: float = 1.0) -> jnp.ndarray:
    """Euclidean projection onto ``{x : ||x||_1 <= radius}``.

    Sort-based simplex projection (Duchi et al. 2008), expressed with static
    shapes so it jits and vmaps: soft-threshold by the largest multiplier
    that keeps the L1 mass at ``radius``.
    """
    abs_x = jnp.abs(x)
    inside = jnp.sum(abs_x, axis=-1, keepdims=True) <= radius
    # Descending sort + running prefix means give the threshold candidates.
    u = jnp.sort(abs_x, axis=-1)[..., ::-1]
    css = jnp.cumsum(u, axis=-1) - radius
    d = x.shape[-1]
    idx = jnp.arange(1, d + 1, dtype=x.dtype)
    cond = u - css / idx > 0.0
    # rho = largest index where cond holds (cond is a prefix property).
    rho = jnp.sum(cond.astype(jnp.int32), axis=-1, keepdims=True)
    rho = jnp.maximum(rho, 1)
    theta = jnp.take_along_axis(css, rho - 1, axis=-1) / rho.astype(x.dtype)
    shrunk = jnp.sign(x) * jnp.maximum(abs_x - theta, 0.0)
    return jnp.where(inside, x, shrunk)
