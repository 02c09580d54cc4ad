"""Quadratic-loss online game (BASELINE.json config 1: "Single-sequence
FTL on generated quadratic losses", CPU-runnable at T=10^4).

The reference studies only the normalized hinge; BASELINE.json's config
list and north star add a quadratic track whose exact FTL is the
textbook case for the running-sufficient-statistics recast ("prefix sums
of gradients/Hessian terms so no inner solve re-runs history"):

    loss_t(x) = 0.5 * (<z_t, x> - y_t)^2,       ||x||_2 <= 1.

The prefix objective is the quadratic  0.5 x^T A_t x - b_t^T x + c_t/2
with A_t = sum z_i z_i^T, b_t = sum y_i z_i, c_t = sum y_i^2 — all O(d^2)
running statistics carried in a ``lax.scan``.  The exact FTL action is
the ball-constrained least-squares (trust-region) solution:

    x_t = argmin_{||x|| <= 1}  0.5 x^T A x - b^T x
        = V (beta / (Lambda + lam*)),   A = V diag(Lambda) V^T,
          beta = V^T b,

with lam* = 0 when the unconstrained solution is inside the ball, else
the unique lam > 0 with ||x(lam)|| = 1 — found by bisection on
n(lam) = sum beta_i^2/(Lambda_i + lam)^2, which is strictly decreasing,
bracketed by [0, ||beta||] (at lam = ||beta||, n <= 1 identically).
Singular prefixes (t < d) are handled by the same bisection: a null-space
component of b forces lam* > 0; a fully consistent singular system takes
the min-norm solution.

The comparator loss needs NO replay: for any action x,
sum_i 0.5 (<z_i, x> - y_i)^2 = 0.5 (x^T A x - 2 b^T x + c) from the same
carried statistics.

Reference analog: none (cited for the inventory: the hinge FTL is
algorithms.py:13-15; this module is new capability from BASELINE.json).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from online_convex_optimization.models.base import RunResult

_HI = jax.lax.Precision.HIGHEST


def _ridge_chol_solve(A: jnp.ndarray, b: jnp.ndarray, lam: jnp.ndarray):
    """x = (A + lam I)^{-1} b via a d-UNROLLED Cholesky: d is small and
    static, so the factorization + two substitutions become ~d^3/3
    elementwise ops over the batch — no batched tiny ``eigh`` or linalg
    custom call per system."""
    d = A.shape[-1]
    L = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            s = A[..., i, j] + (lam if i == j else 0.0)
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = jnp.sqrt(s)        # SPD for lam > 0
            else:
                L[i][j] = s / L[j][j]
    v = []
    for i in range(d):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * v[k]
        v.append(s / L[i][i])
    x = [None] * d
    for i in reversed(range(d)):
        s = v[i]
        for k in range(i + 1, d):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def ball_ls_action(A: jnp.ndarray, b: jnp.ndarray, *, iters: int = 60):
    """argmin_{||x||<=1} 0.5 x^T A x - b^T x for PSD A ((..., d, d)) and
    b ((..., d)); batched, jit/scan-safe (fixed ``iters`` bisection on
    the trust-region multiplier, each step one unrolled ridge solve)."""
    d = A.shape[-1]
    dtype = A.dtype
    # Ridge floor: keeps every evaluated system SPD.  Relative to the
    # problem scale; biases the unconstrained solution by O(eps).
    eps_rel = 1e-12 if dtype == jnp.float64 else 1e-6
    tr = jnp.einsum("...ii->...", A)
    eps = eps_rel * (1.0 + tr / d)

    def norm2(lam):
        x = _ridge_chol_solve(A, b, lam + eps)
        return jnp.sum(x * x, axis=-1), x

    # At lam = ||b||: ||x|| <= ||b||/lam = 1, so [0, ||b||] brackets lam*.
    hi0 = jnp.sqrt(jnp.sum(b * b, axis=-1))
    lo = jnp.zeros_like(hi0)

    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        n2, _ = norm2(mid)
        outside = n2 > 1.0
        return jnp.where(outside, mid, lo), jnp.where(outside, hi, mid)

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi0))
    # hi converges to max(0, lam*) for BOTH cases: interior solutions
    # drive hi -> 0+ (x(hi) -> the unconstrained solution), and singular
    # prefixes with a null-space gradient component blow up n(0+) so the
    # bisection finds the boundary multiplier — no special-casing.
    _, x = norm2(hi)
    # Exact feasibility: rescale the boundary case onto the sphere.
    nx = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True))
    return x / jnp.maximum(nx, 1.0)


def quadratic_comparator_loss(A, b, c, x):
    """sum_i 0.5 (<z_i,x> - y_i)^2 from the carried statistics (no replay)."""
    xa = jnp.einsum("...ij,...j->...i", A, x, precision=_HI)
    return 0.5 * (jnp.sum(x * xa, axis=-1)
                  - 2.0 * jnp.sum(b * x, axis=-1) + c)


@partial(jax.jit, static_argnames=())
def _simulate_quadratic_batch(z, y, alg_flag, eta0):
    """Batched quadratic-loss game.  alg_flag/eta0: (B,) arrays;
    alg_flag 0 = FTRL (projected gradient leader), 1 = exact FTL
    (ball-constrained least squares on the running statistics).

    Shape of the computation: unlike the hinge game, the exact-FTL trajectory here
    is NOT sequential — action t depends only on the prefix statistics
    (A_{t-1}, b_{t-1}), which are cumulative sums.  So ALL T prefix
    actions come from ONE batched trust-region solve over (B, T) tiny
    systems (the all-prefix pattern of models/exact_ftl.py), and only the
    FTRL track (whose gradients depend on its own actions) runs as a
    scan — with no linear algebra inside it.  Transient memory is
    O(B T d^2) for the cumulative Gram stack.
    """
    B, T, d = z.shape
    dtype = z.dtype
    is_ftrl = (alg_flag == 0)

    # ---- exact-FTL track: one batched all-prefix solve ----
    outers = z[:, :, :, None] * z[:, :, None, :]         # (B, T, d, d)
    A_cum = jnp.cumsum(outers, axis=1)
    b_cum = jnp.cumsum(y[:, :, None] * z, axis=1)
    A_pre = jnp.concatenate([jnp.zeros((B, 1, d, d), dtype),
                             A_cum[:, :-1]], axis=1)
    b_pre = jnp.concatenate([jnp.zeros((B, 1, d), dtype),
                             b_cum[:, :-1]], axis=1)
    x_ftl = ball_ls_action(A_pre, b_pre)                 # (B, T, d)
    q_ftl = jnp.sum(z * x_ftl, axis=-1)
    cum_ftl = 0.5 * jnp.sum((q_ftl - y) ** 2, axis=-1)
    A_full, b_full = A_cum[:, -1], b_cum[:, -1]
    x_ftl_last = x_ftl[:, -1]

    # ---- FTRL track: sequential, but O(d) per step ----
    def step(carry, inp):
        theta, cum, t = carry
        z_t, y_t = inp
        scale = -(eta0 / jnp.sqrt(jnp.maximum(t, 1.0)))
        xf = scale[:, None] * theta
        nx = jnp.sqrt(jnp.sum(xf * xf, axis=-1, keepdims=True))
        x = xf / jnp.maximum(nx, 1.0)
        q = jnp.sum(z_t * x, axis=-1)
        r = q - y_t
        cum = cum + 0.5 * r * r
        theta = theta + r[:, None] * z_t             # grad of 0.5(q-y)^2
        return (theta, cum, t + 1.0), x

    carry0 = (jnp.zeros((B, d), dtype), jnp.zeros((B,), dtype),
              jnp.ones((), dtype))
    (_, cum_ftrl, _), xs = jax.lax.scan(
        step, carry0, (jnp.swapaxes(z, 0, 1), jnp.swapaxes(y, 0, 1)))

    c = jnp.sum(y * y, axis=-1)
    x_c = ball_ls_action(A_full, b_full)                 # exact comparator
    comp = quadratic_comparator_loss(A_full, b_full, c, x_c)
    cum = jnp.where(is_ftrl, cum_ftrl, cum_ftl)
    x_last = jnp.where(is_ftrl[:, None], xs[-1], x_ftl_last)
    return cum, comp, x_c, x_last


def simulate_quadratic_batch(z, y, alg_flag, eta0) -> RunResult:
    """Batched quadratic-loss regret evaluation; RunResult of (B,) arrays.

    Comparator = exact full-sequence ball-constrained least-squares
    minimizer, scored from the carried (A, b, c) statistics — no replay.
    """
    z = jnp.asarray(z)
    y = jnp.asarray(y)
    B = z.shape[0]
    alg_flag = jnp.broadcast_to(jnp.asarray(alg_flag), (B,))
    eta0 = jnp.broadcast_to(jnp.asarray(eta0, z.dtype), (B,))
    cum, comp, x_c, x_last = _simulate_quadratic_batch(z, y, alg_flag, eta0)
    return RunResult(cum_loss=cum, regret=cum - comp, comp_loss=comp,
                     x_last=x_last)


def simulate_quadratic(z, y, *, alg: str = "ftl",
                       eta0: float = 1.0) -> RunResult:
    """Single-sequence front-end (BASELINE config 1 shape: one sequence,
    T = 10^4, CPU-runnable).  ``alg``: "ftl" (exact) or "ftrl"."""
    if alg not in ("ftl", "ftrl"):
        raise ValueError("alg must be 'ftl' or 'ftrl'")
    flag = 1 if alg == "ftl" else 0
    res = simulate_quadratic_batch(jnp.asarray(z)[None], jnp.asarray(y)[None],
                                   flag, eta0)
    return RunResult(cum_loss=float(res.cum_loss[0]),
                     regret=float(res.regret[0]),
                     comp_loss=float(res.comp_loss[0]),
                     x_last=np.asarray(res.x_last[0]))
