"""Single-switch SMART (FTL -> FTRL) as dataflow instead of branching.

Reference semantics being reproduced (/root/reference, algorithms.py:65-120
and fast_algorithms.py:118-164):

  round t (0-based):
    1. FTL track *always* updates: play/evaluate the pre-update FTL action,
       then ``theta_ftl += 0.5*sign(pred - y_t) * z_t``; accumulate
       ``ftl_loss``  (fast_algorithms.py:140-146).
    2. If already switched: play an independent FTRL track (accumulator
       started from zero at the switch, but with the *global* round index
       ``t+1``)  (fast_algorithms.py:148-154).
    3. Else: count the FTL loss, form ``s`` = post-update FTL action, and
       test ``ftl_loss - prefix_loss(s, rounds 0..t) >= theta_thresh``;
       on success, switch starting the *next* round
       (fast_algorithms.py:156-160).
  Epilogue: comparator = final FTL action over the full sequence
       (fast_algorithms.py:162-164).

Accelerator redesign (SURVEY.md §7 "hard parts"): the reference recomputes the
prefix comparator loss from scratch every pre-switch round — O(T² d) of
*sequential* scalar work.  Here the data-dependent switch becomes pure
dataflow in three phases, each batched over B sequences:

  Phase A  one O(T d) ``lax.scan`` for the (switch-independent) FTL track,
           emitting the per-round FTL losses AND the prefix comparator
           losses ``L_t`` via the hinge identity (below).
  Phase B  the switch round is ``tau = argmin{t : cumsum(ftl_loss)_t - L_t
           >= theta_thresh}`` — pure elementwise math on Phase A outputs.
  Phase C  one O(T d) scan for the FTRL track, gated elementwise on
           ``t > tau`` — no control flow, fully vmappable.

The prefix-loss identity: the framework's data contract (reference
sequence_generation.py:64-66) clips every row to the unit ball and labels
are ±1 (0 for padding), and every action lives in the unit L2 ball, so
``|<s, z_i>| <= 1`` by Cauchy-Schwarz and the normalized hinge satisfies
``|q - y| = 1 - q*y`` EXACTLY (reals).  Hence

    L_t = 0.5 * sum_{i<=t} (1 - <s_t, z_i> y_i)
        = 0.5 * (cnt_t - <s_t, w_t>),   w_t = sum_{i<=t} y_i z_i,

with ``w_t`` an O(d) running statistic carried in the Phase-A scan: the
reference's O(T² d) hot loop (algorithms.py:109-112) collapses to O(T d)
with NO O(T²) intermediate (the earlier blocked-matmul phase B and its
multi-GB transient are gone).  Padding rows (z = 0, y = 0) are inert in
``w``, ``cnt``, and every loss term.

The decomposition is exact (not an approximation): Phase A is independent of
the switch by construction, and the first crossing of the threshold is
sticky in the reference, so recomputing the condition for all t and taking
the first true index reproduces the reference's trajectory bit-for-bit up to
floating-point summation order.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Optional

import jax
import jax.numpy as jnp

# Matmul precision: XLA's DEFAULT f32 matmul may run in TF32 on the GPU,
# which is catastrophic for the parity/exact paths (comparator losses
# drift by O(sqrt(T)*2^-10)).  Every contraction here pins HIGHEST.
_HI = jax.lax.Precision.HIGHEST


from online_convex_optimization.ops.actions import ftl_action, ftrl_action
from online_convex_optimization.ops.hinge import hinge_subgradient, normalized_hinge


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SmartRunResult:
    """Batched SMART outcome; ``switch_t`` is the 0-based round after which
    FTRL takes over (== T when no switch happened)."""

    cum_loss: Any
    regret: Any
    comp_loss: Any
    x_last: Any
    switch_t: Any


def _ftl_track(z_tm, y_tm, v_tm, B, d, dtype):
    """Phase A: scan the always-on FTL track (fast_algorithms.py:140-146),
    carrying the hinge-identity statistics (w, cnt).

    Returns (theta_final, L, ftl_losses): L the (T, B) prefix comparator
    losses of the post-update action (== the reference's per-round prefix
    recompute, fast_algorithms.py:79-85 via 157-158, by the identity in the
    module docstring) and ftl_losses the (T, B) per-round losses.
    """

    def step(carry, inp):
        theta, w, cnt = carry
        z_t, y_t, v = inp
        x_pre = ftl_action(theta)
        pred = jnp.sum(z_t * x_pre, axis=-1)
        g = hinge_subgradient(pred, y_t)
        theta = theta + (v * g)[:, None] * z_t
        loss = v * normalized_hinge(pred, y_t)
        w = w + (v * y_t)[:, None] * z_t          # running sum of y_i z_i
        cnt = cnt + v                             # valid-round count
        s_post = ftl_action(theta)
        L_t = 0.5 * (cnt - jnp.sum(s_post * w, axis=-1))
        return (theta, w, cnt), (L_t, loss)

    carry0 = (jnp.zeros((B, d), dtype=dtype), jnp.zeros((B, d), dtype=dtype),
              jnp.zeros((B,), dtype=dtype))
    (theta, _, _), (L, losses) = jax.lax.scan(step, carry0,
                                              (z_tm, y_tm, v_tm))
    return theta, L, losses


def _ftrl_track(z_tm, y_tm, v_tm, tau, eta0, B, d, dtype):
    """Phase C: FTRL track gated on ``t > tau`` (fast_algorithms.py:148-154).

    The accumulator stays exactly zero until the first active round, so the
    track matches the reference's fresh-at-switch FTRL with global round
    index t+1.
    """
    T = z_tm.shape[0]
    ts = jnp.arange(1, T + 1, dtype=dtype)

    def step(carry, inp):
        theta, x_prev = carry
        z_t, y_t, t, v = inp
        active = ((t - 1.0) > tau.astype(dtype)).astype(dtype) * v  # t is 1-based
        x = ftrl_action(theta, jnp.full((B,), t, dtype=dtype), eta0)
        pred = jnp.sum(z_t * x, axis=-1)
        loss = active * normalized_hinge(pred, y_t)
        g = hinge_subgradient(pred, y_t)
        theta = theta + (active * g)[:, None] * z_t
        x_keep = jnp.where((active > 0)[:, None], x, x_prev)
        return (theta, x_keep), loss

    init = (jnp.zeros((B, d), dtype=dtype), jnp.zeros((B, d), dtype=dtype))
    (theta, x_last), losses = jax.lax.scan(step, init, (z_tm, y_tm, ts, v_tm))
    return theta, x_last, losses


@partial(jax.jit, static_argnames=("block_size",))
def simulate_smart_batch(
    z: jnp.ndarray,
    y: jnp.ndarray,
    theta_thresh: jnp.ndarray,
    eta0: jnp.ndarray,
    length: Optional[jnp.ndarray] = None,
    *,
    block_size: int = 128,
) -> SmartRunResult:
    """Batched single-switch SMART over ``(B, T, d)`` padded sequences.

    ``theta_thresh`` / ``eta0`` broadcast to ``(B,)`` so threshold and
    step-size grids ride the same compiled program.  ``block_size`` is
    retained for API compatibility but unused: the hinge-identity Phase B
    (module docstring) removed the blocked O(T²) prefix matmul entirely.
    """
    del block_size  # obsolete: no O(T^2) intermediate to block anymore
    B, T, d = z.shape
    dtype = z.dtype
    theta_thresh = jnp.broadcast_to(jnp.asarray(theta_thresh, dtype=dtype), (B,))
    eta0 = jnp.broadcast_to(jnp.asarray(eta0, dtype=dtype), (B,))
    if length is None:
        valid = jnp.ones((B, T), dtype=dtype)
    else:
        length = jnp.broadcast_to(jnp.asarray(length), (B,))
        valid = (jnp.arange(T)[None, :] < length[:, None]).astype(dtype)

    z_tm = jnp.swapaxes(z, 0, 1)  # (T, B, d)
    y_tm = jnp.swapaxes(y, 0, 1)  # (T, B)
    v_tm = jnp.swapaxes(valid, 0, 1)

    # Phase A — always-on FTL track, emitting identity-based prefix losses.
    theta_ftl, L_tm, ftl_losses_tm = _ftl_track(z_tm, y_tm, v_tm, B, d, dtype)

    # Phase B — the switch round from the Phase-A statistics.
    F_tm = jnp.cumsum(ftl_losses_tm, axis=0)  # running ftl_loss
    cond = (F_tm - L_tm >= theta_thresh[None, :]) & (v_tm > 0)
    t_grid = jnp.arange(T)[:, None]
    tau = jnp.min(jnp.where(cond, t_grid, T), axis=0)  # (B,) first crossing, T if none

    # Phase C — gated FTRL track.
    _, x_ftrl_last, ftrl_losses_tm = _ftrl_track(
        z_tm, y_tm, v_tm, tau, eta0, B, d, dtype)

    pre_mask = (t_grid <= tau[None, :]).astype(dtype) * v_tm
    total_loss = jnp.sum(pre_mask * ftl_losses_tm + ftrl_losses_tm, axis=0)

    # Epilogue — comparator from the final FTL accumulator.
    s_final = ftl_action(theta_ftl)
    q_all = jnp.einsum("btd,bd->bt", z, s_final, precision=_HI)
    comp_loss = jnp.sum(normalized_hinge(q_all, y) * valid, axis=-1)

    never_switched = tau >= T
    x_last = jnp.where(never_switched[:, None], s_final, x_ftrl_last)
    return SmartRunResult(
        cum_loss=total_loss,
        regret=total_loss - comp_loss,
        comp_loss=comp_loss,
        x_last=x_last,
        switch_t=tau,
    )


def simulate_smart(
    z: jnp.ndarray,
    y: jnp.ndarray,
    theta_thresh,
    eta0,
    length=None,
    *,
    block_size: int = 128,
) -> SmartRunResult:
    """Single-sequence convenience wrapper (B = 1) around the batched path."""
    res = simulate_smart_batch(
        z[None], y[None],
        jnp.asarray(theta_thresh)[None],
        jnp.asarray(eta0)[None],
        None if length is None else jnp.asarray(length)[None],
        block_size=block_size,
    )
    return jax.tree_util.tree_map(lambda a: a[0], res)
