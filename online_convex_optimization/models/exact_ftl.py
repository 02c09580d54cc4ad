"""Exact follow-the-leader oracle, recast for an accelerator.

Reference (/root/reference/exact_ftl.py): exact FTL solves, per prefix
length p, the nonsmooth convex program

    minimize_{||x||_p <= 1}   0.5 * sum_{i < p} | <z_i, x> - y_i |

via a build-once/solve-many CVXPY problem (SOCP for l2, LP for l1/linf;
exact_ftl.py:62-193), re-solved T times with warm starts to produce the
prefix-action trajectory (exact_ftl.py:280-303) that ``replay_exact_ftl``
then scores (exact_ftl.py:306-333).

Accelerator redesign: there is no CVXPY on device, and T sequential
interior-point solves are the reference's dominant hot loop (SURVEY.md
§3.3).  Here ALL T prefix problems are solved SIMULTANEOUSLY by one batched
consensus ADMM in which every iteration is two (T x T)(T x d) matmuls
plus tiny batched Cholesky solves:

    split:  s = Z x - y   (residual copy, prox = soft-threshold)
            w = x         (ball copy,     prox = norm-ball projection)
    x-step: (Z^T M_p Z + I) x = Z^T M_p (y + s - u) + (w - v)
            with M_p the prefix mask; the d x d normal matrices for all
            prefixes are a cumulative sum of outer products, factorized
            once (batched Cholesky) and reused across iterations.

The d x d cumulative Gram factorization is exactly the "running sufficient
statistics" recast called for by BASELINE.json: no prefix ever re-reads
history — the Gram cumsum carries it.

Accuracy: ADMM with over-relaxation identifies the active set at ~1e-5;
the host-side active-set polish (models/polish.py) then solves the exact
optimal-face system, reaching ~1e-9..1e-12 objective accuracy — matching
the reference's interior-point solves (exact_ftl.py:119-128).  Every ADMM
entry point reports convergence residuals; hard failures raise (reference
parity, exact_ftl.py:125-126) or yield NaN sentinels in batched use
(utils/debug.drop_nonfinite_stats-compatible).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Literal, Optional, Tuple

import jax
import jax.numpy as jnp

# Matmul precision: XLA's DEFAULT f32 matmul may round its operands (TF32
# on the GPU's tensor cores), which is catastrophic for the parity/exact
# paths (the ADMM converges to a rounded-matmul fixed point, comparator
# losses drift by O(sqrt(T)*2^-10)).  Every contraction pins HIGHEST.
_HI = jax.lax.Precision.HIGHEST

import numpy as np

from online_convex_optimization.models.base import RunResult
from online_convex_optimization.models.linear import simulate_linear
from online_convex_optimization.models.linear_regime import (
    certified_full_solution,
    certified_prefix_actions,
)
from online_convex_optimization.models.polish import (
    polish_prefix_actions,
    polish_solution,
)
from online_convex_optimization.ops.actions import (
    project_l1_ball,
    project_l2_ball,
    project_linf_ball,
)
from online_convex_optimization.ops.hinge import normalized_hinge

Norm = Literal["l2", "linf", "l1"]

_PROJECT = {
    "l2": project_l2_ball,
    "linf": project_linf_ball,
    "l1": project_l1_ball,
}


def _soft_threshold(v: jnp.ndarray, kappa) -> jnp.ndarray:
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - kappa, 0.0)


@partial(jax.jit, static_argnames=("norm", "iters", "check_every", "tol",
                                   "band_rows"))
def _admm_all_prefixes(
    z: jnp.ndarray,
    y: jnp.ndarray,
    *,
    norm: Norm = "l2",
    iters: int = 600,
    rho: float = 1.0,
    alpha: float = 1.7,
    tol: float = 0.0,
    check_every: int = 100,
    state0=None,
    band_lo=None,
    band_rows: Optional[int] = None,
) -> jnp.ndarray:
    """Solve the exact-FTL program for every prefix length 1..T at once.

    Args:
      z: (T, d); y: (T,).
      tol: when > 0, residual-based early stopping — the iteration loop
        exits once EVERY prefix's residual is <= tol (checked every
        ``check_every`` iterations at the cost of one extra (T,T) matmul
        per check); ``iters`` remains the hard cap.
      state0: optional ADMM state to CONTINUE from (the third return
        value of a previous call on the same data) — the iteration is
        Markov in the state, so continuing is exactly a longer run.
        Escalation paths use this to add budget to a hard solve without
        redoing the spent iterations.
      band_lo / band_rows: optional prefix banding — solve only the
        ``band_rows`` (STATIC, fixes the compiled shape) prefix lengths
        starting at ``band_lo`` (DYNAMIC, so one compiled program serves
        every band).  Prefix problems are independent, so banding changes
        nothing mathematically, but each band's while_loop exits when
        ITS slowest prefix converges instead of the global one: short
        prefixes stop iterating hundreds of iterations earlier
        (measured 1.6x on the T=1000 iid cell).
    Returns:
      (X, res, state): X (rows, d) where X[k] minimizes the length-
      (band_lo+k+1) prefix objective (rows = band_rows; all T without
      banding); res (rows,) residuals; state for continuation.
    """
    T, d = z.shape
    dtype = z.dtype
    project = _PROJECT[norm]
    if band_rows is None:
        rows, lo = T, jnp.zeros((), jnp.int32)
    else:
        rows, lo = band_rows, jnp.asarray(band_lo, jnp.int32)

    # Prefix masks and cumulative Gram matrices (running sufficient stats).
    mask = (jnp.arange(T)[None, :] <=
            (lo + jnp.arange(rows))[:, None]).astype(dtype)  # (rows, T)
    outers = z[:, :, None] * z[:, None, :]                 # (T, d, d)
    gram = jax.lax.dynamic_slice_in_dim(
        jnp.cumsum(outers, axis=0), lo, rows, axis=0)      # (rows, d, d)
    A = gram + jnp.eye(d, dtype=dtype)[None]
    chol = jax.vmap(jnp.linalg.cholesky)(A)                # (rows, d, d)

    kappa = 0.5 / rho

    def solve_x(rhs):
        # Batched (T, d) solve via the precomputed Cholesky factors.
        return jax.vmap(jax.scipy.linalg.cho_solve, in_axes=((0, None), 0))(
            (chol, True), rhs)

    def body(_, state):
        X, S, U, W, V = state
        # x-step
        rhs = jnp.einsum("pt,td->pd", mask * (y[None, :] + S - U), z,
                         precision=_HI) + (W - V)
        X = solve_x(rhs)
        Q = jnp.matmul(X, z.T, precision=_HI)  # (T, T): Q[p-1, i] = <x_p, z_i>
        R = mask * (Q - y[None, :])                        # masked residuals
        # over-relaxation on the residual consensus
        R_hat = alpha * R + (1.0 - alpha) * S
        S = _soft_threshold(R_hat + U, kappa) * mask
        U = (U + R_hat - S) * mask
        # ball consensus
        X_hat = alpha * X + (1.0 - alpha) * W
        W = project(X_hat + V)
        V = V + X_hat - W
        return (X, S, U, W, V)

    def residuals(state):
        # Per prefix: primal residual (masked split consensus) and
        # ball-copy consensus, both inf-norms.
        X, S, U, W, V = state
        R = mask * (jnp.matmul(X, z.T, precision=_HI) - y[None, :])
        pri = jnp.max(jnp.abs(R - S), axis=1)
        cons = jnp.max(jnp.abs(X - W), axis=1)
        return jnp.maximum(pri, cons)                      # (T,)

    if state0 is None:
        zeros_T = jnp.zeros((rows, T), dtype=dtype)
        zeros_d = jnp.zeros((rows, d), dtype=dtype)
        state = (zeros_d, zeros_T, zeros_T, zeros_d, zeros_d)
    else:
        state = state0
    if tol > 0.0:
        n_blocks = -(-iters // check_every)

        def w_cond(carry):
            _, blk, worst = carry
            return jnp.logical_and(blk < n_blocks, worst > tol)

        def w_body(carry):
            st, blk, _ = carry
            st = jax.lax.fori_loop(0, check_every, body, st)
            return st, blk + 1, jnp.max(residuals(st))

        state, _, _ = jax.lax.while_loop(
            w_cond, w_body, (state, jnp.zeros((), jnp.int32),
                             jnp.asarray(jnp.inf, dtype)))
    else:
        state = jax.lax.fori_loop(0, iters, body, state)
    res = residuals(state)
    # Return the feasible copy (inside the ball by construction).
    return state[3], res, state


@partial(jax.jit, static_argnames=("norm", "iters"))
def _admm_masked_warm(z, y, m, state, *, norm: Norm = "l2", iters: int = 80,
                      rho: float = 1.0, alpha: float = 1.7):
    """Warm-startable single solve over the masked prefix ``m`` (0/1,
    (T_max,)) — the device twin of the native runtime's iters_first /
    iters_warm split (native/oco_native.cpp) and of the reference's
    warm-started repeated solves (exact_ftl.py:121-123, 140-149).

    ``state`` = (x (d,), s (T_max,), u (T_max,), w (d,), v (d,)) carried
    across appends; one compile serves every prefix length because the
    shapes are T_max-padded and the prefix enters only through ``m``.
    Returns (state, residual) with residual the max of the masked primal
    and consensus inf-norms.
    """
    T_max, d = z.shape
    dtype = z.dtype
    project = _PROJECT[norm]
    zm = m[:, None] * z
    A = jnp.matmul(zm.T, z, precision=_HI) + jnp.eye(d, dtype=dtype)
    chol = jnp.linalg.cholesky(A)
    kappa = 0.5 / rho

    def body(_, st):
        x, s, u, w, v = st
        rhs = jnp.matmul(zm.T, y + s - u, precision=_HI) + (w - v)
        x = jax.scipy.linalg.cho_solve((chol, True), rhs)
        r = m * (jnp.matmul(z, x, precision=_HI) - y)
        r_hat = alpha * r + (1.0 - alpha) * s
        s = _soft_threshold(r_hat + u, kappa) * m
        u = (u + r_hat - s) * m
        x_hat = alpha * x + (1.0 - alpha) * w
        w = project((x_hat + v)[None, :])[0]
        v = v + x_hat - w
        return (x, s, u, w, v)

    state = jax.lax.fori_loop(0, iters, body, state)
    x, s, u, w, v = state
    r = m * (jnp.matmul(z, x, precision=_HI) - y)
    res = jnp.maximum(jnp.max(jnp.abs(r - s)), jnp.max(jnp.abs(x - w)))
    return state, res


@partial(jax.jit, static_argnames=("norm", "iters", "check_every", "tol"))
def _admm_full(z, y, *, norm: Norm = "l2", iters: int = 600,
               rho: float = 1.0, alpha: float = 1.7, tol: float = 0.0,
               check_every: int = 100, state0=None) -> jnp.ndarray:
    """Single full-sequence solve (comparator oracle): cheaper state (one
    prefix), same splitting; ``tol`` > 0 enables residual-based early
    stopping with ``iters`` as the hard cap.
    ``state0`` continues a previous solve (see _admm_all_prefixes).
    Returns (x, residual, state)."""
    T, d = z.shape
    dtype = z.dtype
    project = _PROJECT[norm]
    A = jnp.matmul(z.T, z, precision=_HI) + jnp.eye(d, dtype=dtype)
    chol = jnp.linalg.cholesky(A)
    kappa = 0.5 / rho

    def body(_, state):
        x, s, u, w, v = state
        rhs = jnp.matmul(z.T, y + s - u, precision=_HI) + (w - v)
        x = jax.scipy.linalg.cho_solve((chol, True), rhs)
        r = jnp.matmul(z, x, precision=_HI) - y
        r_hat = alpha * r + (1.0 - alpha) * s
        s = _soft_threshold(r_hat + u, kappa)
        u = u + r_hat - s
        x_hat = alpha * x + (1.0 - alpha) * w
        w = project((x_hat + v)[None, :])[0]
        v = v + x_hat - w
        return (x, s, u, w, v)

    def residual(state):
        x, s, u, w, v = state
        r = jnp.matmul(z, x, precision=_HI) - y
        return jnp.maximum(jnp.max(jnp.abs(r - s)), jnp.max(jnp.abs(x - w)))

    if state0 is None:
        state = (jnp.zeros((d,), dtype), jnp.zeros((T,), dtype),
                 jnp.zeros((T,), dtype), jnp.zeros((d,), dtype),
                 jnp.zeros((d,), dtype))
    else:
        state = state0
    if tol > 0.0:
        n_blocks = -(-iters // check_every)

        def w_cond(carry):
            _, blk, worst = carry
            return jnp.logical_and(blk < n_blocks, worst > tol)

        def w_body(carry):
            st, blk, _ = carry
            st = jax.lax.fori_loop(0, check_every, body, st)
            return st, blk + 1, residual(st)

        state, _, _ = jax.lax.while_loop(
            w_cond, w_body, (state, jnp.zeros((), jnp.int32),
                             jnp.asarray(jnp.inf, dtype)))
    else:
        state = jax.lax.fori_loop(0, iters, body, state)
    return state[3], residual(state), state


@dataclasses.dataclass
class ExactFTL:
    """Build-once/solve-many exact-FTL oracle (ExactFTLNoClip equivalent,
    exact_ftl.py:62-193) — but "solve many" means "all prefixes in one
    batched device program".

    The reference's incremental surface (``reset_buffers`` / ``append_row``
    / ``solve_prefix`` / ``solve_prefix_from_full``, exact_ftl.py:130-193)
    is provided for drop-in compatibility, with ``append_row`` warm-started
    from the previous prefix's ADMM state (``warm_iters`` refinement
    iterations, mirroring the reference's warm_start=True re-solves and the
    native runtime's iters_first/iters_warm split); batch appenders should
    still prefer ``prefix_actions`` which solves every prefix at once.

    Accuracy/failure contract: solutions are active-set-polished to
    ~1e-9 objective accuracy (``polish=True``; models/polish.py); ADMM
    residuals above ``fail_tol`` raise RuntimeError like the reference's
    failed-solve path (exact_ftl.py:125-126) — or become NaN sentinels
    with ``on_fail='sentinel'`` for vmapped/batched use.  ``last_info``
    holds the residual telemetry of the most recent solve.
    """

    d: int
    T_max: int
    norm: Norm = "l2"
    iters: int = 600
    rho: float = 1.0
    alpha: float = 1.7
    warm_iters: int = 80
    polish: bool = True
    fail_tol: float = 1e-3
    on_fail: str = "raise"  # or "sentinel"
    stop_tol: float = 1e-5  # residual-based early exit; iters stays the cap
    allow_linear: bool = True  # try the CERTIFIED closed form first
    #   (models/linear_regime.py): on binary-label contract data the exact
    #   program is linear and the minimizer is w_t/||w_t|| (l2) — checked
    #   per prefix by the optimality certificate, never assumed.  Set
    #   False to force the general ADMM path (solver validation tests do).
    method: str = "admm"  # general-path solver: "admm" (all norms) or
    #   "ssn" (l2/linf) — Huber-continuation semismooth Newton
    #   (models/ssn.py), ~20-60 Newton steps where the ADMM takes
    #   1.8-2.2k iterations on hard out-of-contract instances.  Both feed
    #   the same active-set polish; ``iters`` caps Newton steps for ssn
    #   (the while_loop exits at stop_tol long before the ADMM-scale cap).

    def __post_init__(self):
        if self.method not in ("admm", "ssn"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.method == "ssn" and self.norm not in ("l2", "linf"):
            # l1 stays ADMM-only by design: on contract data the l1
            # closed-form certificate covers every cell a priori
            # (models/linear_regime.py), so the general-solver demand is
            # minimal and the box-subproblem machinery does not apply to
            # the l1 ball's face geometry.
            raise ValueError("method='ssn' supports norm in {'l2','linf'}")
        self._z_buf = np.zeros((self.T_max, self.d))
        self._y_buf = np.zeros(self.T_max)
        self._length = 0
        self._state = None  # warm-start ADMM state for append_row
        self._state_length = 0  # prefix length the state was solved at —
        #   certified early returns advance _length WITHOUT advancing the
        #   state, so a later general solve must detect the stale state
        #   and take the full iteration budget (round-2 ADVICE).
        self.last_info: dict = {}

    def _band_solve(self, z, y, lo, rows, state0=None, iters=None):
        """General-path all-prefix band solve via the configured method."""
        iters = self.iters if iters is None else iters
        if self.method == "ssn":
            # Newton-step cap: slow-tail instances (near-kink residuals)
            # need ~1e3 steps (measured); the while_loop exits early on
            # easy rows, so a generous cap costs nothing.
            iters = max(iters, 2000)
            from online_convex_optimization.models.ssn import (
                ssn_all_prefixes)
            # f64 on the default device: 100% certified, no certificate
            # overhead.  x64 is forced regardless of the ambient flag;
            # the input VALUES are preserved.
            with jax.enable_x64():
                return ssn_all_prefixes(
                    jnp.asarray(np.asarray(z, np.float64)),
                    jnp.asarray(np.asarray(y, np.float64)),
                    iters=iters, tol=max(self.stop_tol, 1e-6),
                    state0=state0, band_lo=lo, band_rows=rows,
                    norm=self.norm)
        return _admm_all_prefixes(
            z, y, norm=self.norm, iters=iters, rho=self.rho,
            alpha=self.alpha, tol=self.stop_tol, state0=state0,
            band_lo=lo, band_rows=rows)

    def _full_solve(self, z, y, state0=None, iters=None):
        """General-path full-sequence solve via the configured method."""
        iters = self.iters if iters is None else iters
        if self.method == "ssn":
            iters = max(iters, 2000)  # see _band_solve: slow-tail cover
            from online_convex_optimization.models.ssn import ssn_full
            with jax.enable_x64():  # see _band_solve
                return ssn_full(
                    jnp.asarray(np.asarray(z, np.float64)),
                    jnp.asarray(np.asarray(y, np.float64)),
                    iters=iters, tol=max(self.stop_tol, 1e-6),
                    state0=state0, norm=self.norm)
        return _admm_full(z, y, norm=self.norm, iters=iters, rho=self.rho,
                          alpha=self.alpha, tol=self.stop_tol,
                          state0=state0)

    def reset_buffers(self) -> None:
        """Clear cached rows for a new sequence (exact_ftl.py:130-138)."""
        self._z_buf[:] = 0.0
        self._y_buf[:] = 0.0
        self._length = 0
        self._state = None
        self._state_length = 0

    def _zero_state(self):
        return (jnp.zeros((self.d,)), jnp.zeros((self.T_max,)),
                jnp.zeros((self.T_max,)), jnp.zeros((self.d,)),
                jnp.zeros((self.d,)))

    def _handle_failure(self, res: float, where: str):
        # <=-negation so a NaN residual counts as a failure.
        self.last_info["converged"] = res <= self.fail_tol
        if not (res <= self.fail_tol):
            if self.on_fail == "raise":
                raise RuntimeError(
                    f"exact-FTL ADMM failed to converge in {where}: "
                    f"residual {res:.3e} > fail_tol {self.fail_tol:.1e}")
            return False
        return True

    def append_row(self, z_row: np.ndarray, y_val: float) -> np.ndarray:
        """Append one example and return the new prefix minimizer
        (exact_ftl.py:140-149), warm-started from the previous prefix."""
        if self._length >= self.T_max:
            raise ValueError("sequence longer than T_max")
        self._z_buf[self._length] = z_row
        self._y_buf[self._length] = y_val
        self._length += 1
        if self.allow_linear:
            x_lin = certified_full_solution(
                self._z_buf[:self._length], self._y_buf[:self._length],
                self.norm)
            if x_lin is not None:
                self.last_info = {"residual": 0.0, "iters": 0,
                                  "length": self._length, "converged": True,
                                  "solver": "certified-linear"}
                return x_lin
        if self._state is None:
            self._state = self._zero_state()
        m = np.zeros(self.T_max)
        m[:self._length] = 1.0
        # The 80-iteration warm budget assumes the state is ONE row
        # behind.  After a certified-linear streak the state is several
        # rows (or a whole sequence) stale — warm-continuing it with the
        # short budget silently under-converges, so take the full budget
        # whenever the state is not exactly one row behind.
        fresh = self._state_length == self._length - 1
        iters = (self.warm_iters if fresh and self._length > 1
                 else self.iters)
        state, res = _admm_masked_warm(
            jnp.asarray(self._z_buf), jnp.asarray(self._y_buf),
            jnp.asarray(m), self._state, norm=self.norm, iters=iters,
            rho=self.rho, alpha=self.alpha)
        res_f = float(res)
        if res_f > self.fail_tol and iters < self.iters:
            # Escalate a hard prefix to a full-length refinement once.
            state, res = _admm_masked_warm(
                jnp.asarray(self._z_buf), jnp.asarray(self._y_buf),
                jnp.asarray(m), state, norm=self.norm, iters=self.iters,
                rho=self.rho, alpha=self.alpha)
            res_f = float(res)
        self._state = state
        self._state_length = self._length
        self.last_info = {"residual": res_f, "iters": iters,
                          "length": self._length}
        x = np.asarray(state[3], np.float64)
        if not self._handle_failure(res_f, "append_row"):
            return np.full(self.d, np.nan)
        if self.polish:
            x = polish_solution(self._z_buf[:self._length],
                                self._y_buf[:self._length], x, self.norm)
        return x

    def solve_prefix_from_full(self, z_full, y_full, length: int) -> np.ndarray:
        """Minimizer over the first ``length`` rows (exact_ftl.py:171-181)."""
        if length < 0 or length > self.T_max:
            raise ValueError("length must be between 0 and T_max inclusive")
        z = np.asarray(z_full)[:length]
        y = np.asarray(y_full)[:length]
        self._z_buf[:length] = z
        self._y_buf[:length] = y
        self._length = length
        if length == 0:
            return np.zeros(self.d)
        return self.solve_full(z, y)

    def solve_prefix(self, z_prefix, y_prefix) -> np.ndarray:
        """Solve for explicitly supplied prefix arrays (exact_ftl.py:183-193)."""
        z = np.asarray(z_prefix)
        t, d = z.shape
        if d != self.d:
            raise ValueError(f"Expected {self.d}-dimensional data, got {d}")
        if t > self.T_max:
            raise ValueError("prefix longer than T_max")
        return self.solve_prefix_from_full(z, y_prefix, t)

    def prefix_actions(self, z: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Exact FTL actions for every prefix 0..T; row 0 is the zero vector
        (exact_ftl.py:294-297).  Active-set-polished; residual-checked."""
        # Keep the caller's full-precision host copy for the polish: the
        # device solve may run f32, but the active-set systems must be
        # built from the ORIGINAL data or the "exact" optimum is the
        # optimum of an f32-rounded problem (~1e-7 objective error).
        z_host = np.asarray(z, np.float64)
        y_host = np.asarray(y, np.float64)
        T, d = z_host.shape
        if d != self.d:
            raise ValueError(f"expected d={self.d}, got {d}")
        if T > self.T_max:
            raise ValueError("sequence longer than T_max")
        if self.allow_linear:
            acts = certified_prefix_actions(z_host, y_host, self.norm)
            if acts is not None:
                self.last_info = {"residual": 0.0, "n_unconverged": 0,
                                  "converged": True,
                                  "solver": "certified-linear"}
                return acts
        z = jnp.asarray(z)
        y = jnp.asarray(y)
        # Banding (T >= 512): independent prefix rows solve in 256-row
        # bands, each exiting its while_loop at ITS OWN convergence
        # (one compiled program — band_lo is dynamic).  Hard bands
        # warm-continue with 2x more budget before failing.
        if T >= 512:
            rows = 256
            los = sorted({min(b * rows, T - rows)
                          for b in range(-(-T // rows))})
        else:
            rows, los = None, [None]
        X = np.empty((T, d))
        res = np.empty(T)
        for lo in los:
            Xb, rb, st = self._band_solve(z, y, lo, rows)
            rb_host = np.asarray(rb)
            # NaN-safe direction: a NaN residual must count as unconverged.
            if rb_host.size and not float(rb_host.max()) <= self.fail_tol:
                Xb, rb, st = self._band_solve(z, y, lo, rows, state0=st,
                                              iters=2 * self.iters)
            nb = Xb.shape[0]
            start = 0 if lo is None else lo
            X[start:start + nb] = np.asarray(Xb, np.float64)
            res[start:start + nb] = np.asarray(rb)
        res_np = res
        worst = float(res_np.max()) if res_np.size else 0.0
        self.last_info = {"residual": worst,
                          "n_unconverged": int((res_np > self.fail_tol).sum())}
        X_np = X
        ok = self._handle_failure(worst, "prefix_actions")
        if not ok:  # sentinel mode: NaN out only the unconverged prefixes
            X_np[res_np > self.fail_tol] = np.nan
        actions = np.concatenate([np.zeros((1, d)), X_np])
        if self.polish:
            good = np.flatnonzero(~np.isnan(X_np).any(axis=1)) + 1
            actions = polish_prefix_actions(z_host, y_host,
                                            actions, self.norm, lengths=good)
        return actions

    def solve_full(self, z: np.ndarray, y: np.ndarray) -> np.ndarray:
        """Minimizer over the whole sequence (the exact comparator)."""
        if self.allow_linear:
            x_lin = certified_full_solution(np.asarray(z, np.float64),
                                            np.asarray(y, np.float64),
                                            self.norm)
            if x_lin is not None:
                self.last_info = {"residual": 0.0, "converged": True,
                                  "solver": "certified-linear"}
                return x_lin
        x, res, state = self._full_solve(jnp.asarray(z), jnp.asarray(y))
        res_f = float(res)
        if res_f > self.fail_tol:
            x, res, state = self._full_solve(
                jnp.asarray(z), jnp.asarray(y), state0=state,
                iters=2 * self.iters)
            res_f = float(res)
        self.last_info = {"residual": res_f}
        x = np.asarray(x, np.float64)
        if not self._handle_failure(res_f, "solve_full"):
            return np.full(self.d, np.nan)
        if self.polish:
            x = polish_solution(np.asarray(z), np.asarray(y), x, self.norm)
        return x


# ------------------------------------------------------------------
# Reference-compatible front-ends (exact_ftl.py:280-453)
# ------------------------------------------------------------------

def compute_prefix_actions(solver: ExactFTL, z, y) -> np.ndarray:
    return solver.prefix_actions(z, y)


def replay_exact_ftl(z, y, actions) -> RunResult:
    """Score a precomputed action trajectory (exact_ftl.py:306-333)."""
    z = jnp.asarray(z)
    y = jnp.asarray(y)
    actions = jnp.asarray(actions, dtype=z.dtype)
    T, d = z.shape
    if actions.shape != (T + 1, d):
        raise ValueError("actions must have shape (T+1, d)")
    q = jnp.sum(z * actions[:T], axis=-1)
    cum_loss = jnp.sum(normalized_hinge(q, y))
    q_c = jnp.matmul(z, actions[T], precision=_HI)
    comp_loss = jnp.sum(normalized_hinge(q_c, y))
    return RunResult(cum_loss=float(cum_loss),
                     regret=float(cum_loss - comp_loss),
                     comp_loss=float(comp_loss),
                     x_last=np.asarray(actions[T]))


def run_ftl_exact(z, y, *, norm: Norm = "l2", solver: Optional[ExactFTL] = None,
                  prefix_actions: Optional[np.ndarray] = None,
                  return_actions: bool = False, iters: int = 600):
    """Exact-FTL run (exact_ftl.py:423-453)."""
    z = np.asarray(z)
    y = np.asarray(y)
    T, d = z.shape
    if solver is None:
        solver = ExactFTL(d=d, T_max=T, norm=norm, iters=iters)
    actions = prefix_actions if prefix_actions is not None \
        else solver.prefix_actions(z, y)
    result = replay_exact_ftl(z, y, actions)
    if return_actions:
        return result, actions
    return result


def run_ftrl(z, y, *, eta0: float = 1.0, norm: Norm = "l2",
             comparator_action: Optional[np.ndarray] = None,
             comparator_solver: Optional[ExactFTL] = None,
             iters: int = 600) -> RunResult:
    """FTRL with the exact comparator (exact_ftl.py:230-277, 399-420).

    The online loop is the scan from models.linear; only the comparator
    differs from ``simulate_alg`` (exact minimizer, not final FTL action).
    """
    z_arr = jnp.asarray(z)
    y_arr = jnp.asarray(y)
    T, d = z_arr.shape
    base = simulate_linear(z_arr, y_arr, 0, eta0)
    if comparator_action is None:
        solver = comparator_solver
        if solver is None:
            solver = ExactFTL(d=d, T_max=T, norm=norm, iters=iters)
        comp_vec = solver.solve_full(z_arr, y_arr)
    else:
        comp_vec = np.asarray(comparator_action)
    q_c = jnp.matmul(z_arr, jnp.asarray(comp_vec, dtype=z_arr.dtype),
                     precision=_HI)
    comp_loss = float(jnp.sum(normalized_hinge(q_c, y_arr)))
    cum_loss = float(base.cum_loss)
    return RunResult(cum_loss=cum_loss, regret=cum_loss - comp_loss,
                     comp_loss=comp_loss, x_last=np.asarray(base.x_last))


def simulate(z, y, *, algo: Literal["ftrl", "ftl_exact"] = "ftl_exact",
             eta0: float = 1.0, norm: Norm = "l2",
             ftl_solver: Optional[ExactFTL] = None,
             comparator_solver: Optional[ExactFTL] = None,
             prefix_actions: Optional[np.ndarray] = None,
             comparator_action: Optional[np.ndarray] = None) -> RunResult:
    """Unified front-end dispatching on ``algo`` (exact_ftl.py:336-392)."""
    if algo == "ftl_exact":
        return run_ftl_exact(z, y, norm=norm, solver=ftl_solver,
                             prefix_actions=prefix_actions)
    if algo == "ftrl":
        return run_ftrl(z, y, eta0=eta0, norm=norm,
                        comparator_action=comparator_action,
                        comparator_solver=comparator_solver)
    raise ValueError("algo must be either 'ftrl' or 'ftl_exact'")
