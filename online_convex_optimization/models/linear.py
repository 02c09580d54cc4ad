"""FTL / FTRL online simulation as a single compiled ``lax.scan``.

Reference semantics being reproduced (see /root/reference):
  - per-step loop: pick action, predict ``q = <z_t, x>``, accumulate the
    normalized hinge loss, update the leader accumulator
    ``theta += 0.5*sign(q - y_t) * z_t``        : fast_algorithms.py:88-112
  - epilogue: comparator = *final* FTL action, comparator loss
    ``0.5 * sum |z @ x - y|``                   : fast_algorithms.py:113-115
  - ``alg_flag``: 0 = FTRL, 1 = FTL             : fast_algorithms.py:100-103

Accelerator redesign notes:
  - The timestep loop is a ``lax.scan`` with carry ``(theta, cum_loss)``
    (SURVEY.md §3.4: the carry is exactly this pair).
  - ``alg_flag`` is data, not Python control flow: both candidate actions
    are formed and selected with ``jnp.where`` so one compiled scan serves
    FTRL and FTL and remains vmappable over an algorithm axis.
  - Heterogeneous horizons batch via padding + a ``length`` mask: padded
    steps contribute zero loss and zero gradient, so regret sums are
    untouched (SURVEY.md §7 "padded/bucketed T").
  - ``simulate_linear_batch`` vmaps over (sequences, hyperparameters); this
    is where the scan's throughput comes from — thousands of games advance
    in lockstep, one elementwise op over the batch per step.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

# Matmul precision: XLA's DEFAULT f32 matmul may run in TF32 on the GPU,
# which is catastrophic for the parity/exact paths (comparator losses
# drift by O(sqrt(T)*2^-10)).  Every contraction here pins HIGHEST.
_HI = jax.lax.Precision.HIGHEST


from online_convex_optimization.models.base import RunResult
from online_convex_optimization.ops.actions import ftl_action, ftrl_action
from online_convex_optimization.ops.hinge import hinge_subgradient, normalized_hinge

ALG_FTRL = 0
ALG_FTL = 1


def _masked_comparator_loss(z: jnp.ndarray, y: jnp.ndarray, x: jnp.ndarray,
                            valid: jnp.ndarray) -> jnp.ndarray:
    """``0.5 * sum_t |<z_t, x> - y_t|`` over valid steps.

    Mirrors fast_algorithms.py:69-76 (full-sequence comparator loss).
    """
    q = jnp.matmul(z, x, precision=_HI)
    return jnp.sum(normalized_hinge(q, y) * valid)


def simulate_linear(
    z: jnp.ndarray,
    y: jnp.ndarray,
    alg_flag: jnp.ndarray,
    eta0: jnp.ndarray,
    length: Optional[jnp.ndarray] = None,
) -> RunResult:
    """Simulate FTRL (``alg_flag == 0``) or FTL (``alg_flag == 1``) on one
    padded sequence and return regret vs. the final-FTL-action comparator.

    Args:
      z: ``(T, d)`` feature rows (rows with index >= ``length`` are padding).
      y: ``(T,)`` labels in {-1, +1}.
      alg_flag: scalar int, 0 = FTRL / 1 = FTL (may be traced; vmappable).
      eta0: scalar step-size scale for FTRL.
      length: optional scalar valid horizon; defaults to ``T``.

    Returns:
      ``RunResult`` with scalar ``cum_loss``/``regret``/``comp_loss`` and the
      last played action ``x_last``.
    """
    T, d = z.shape
    dtype = z.dtype
    eta0 = jnp.asarray(eta0, dtype=dtype)
    if length is None:
        valid = jnp.ones((T,), dtype=dtype)
    else:
        valid = (jnp.arange(T) < length).astype(dtype)

    ts = jnp.arange(1, T + 1, dtype=dtype)  # 1-based round index for FTRL

    def step(carry, inp):
        theta, cum_loss, x_prev = carry
        z_t, y_t, t, v = inp
        x_ftrl = ftrl_action(theta, t, eta0)
        x_ftl = ftl_action(theta)
        x = jnp.where(alg_flag == ALG_FTRL, x_ftrl, x_ftl)
        q = jnp.sum(z_t * x)
        loss = normalized_hinge(q, y_t)
        g = hinge_subgradient(q, y_t)
        theta = theta + (v * g) * z_t
        cum_loss = cum_loss + v * loss
        # x_last = last action actually PLAYED (valid rounds only), matching
        # the reference RunResult semantics under padding.
        x_keep = jnp.where(v > 0, x, x_prev)
        return (theta, cum_loss, x_keep), None

    init = (jnp.zeros((d,), dtype=dtype), jnp.zeros((), dtype=dtype),
            jnp.zeros((d,), dtype=dtype))
    (theta, cum_loss, x_last), _ = jax.lax.scan(step, init, (z, y, ts, valid))

    x_comp = ftl_action(theta)
    comp_loss = _masked_comparator_loss(z, y, x_comp, valid)
    return RunResult(cum_loss=cum_loss, regret=cum_loss - comp_loss,
                     comp_loss=comp_loss, x_last=x_last)


@partial(jax.jit, static_argnames=("unroll",))
def simulate_linear_batch(
    z: jnp.ndarray,
    y: jnp.ndarray,
    alg_flag: jnp.ndarray,
    eta0: jnp.ndarray,
    length: Optional[jnp.ndarray] = None,
    *,
    unroll: int = 1,
) -> RunResult:
    """Batched scan over ``B`` sequences at once — the XLA throughput path
    (and the reference the GPU kernels are tested against).

    Args:
      z: ``(B, T, d)``; y: ``(B, T)``; alg_flag: ``(B,)`` or scalar;
      eta0: ``(B,)`` or scalar; length: optional ``(B,)``.

    One fused scan advances all ``B`` states per step (carry ``theta`` is
    ``(B, d)``), so per-step work is elementwise math over the batch + a
    trailing-axis reduction; no per-sequence Python or scan overhead.
    """
    B, T, d = z.shape
    dtype = z.dtype
    alg_flag = jnp.broadcast_to(jnp.asarray(alg_flag), (B,))
    eta0 = jnp.broadcast_to(jnp.asarray(eta0, dtype=dtype), (B,))
    if length is None:
        valid = jnp.ones((B, T), dtype=dtype)
    else:
        length = jnp.broadcast_to(jnp.asarray(length), (B,))
        valid = (jnp.arange(T)[None, :] < length[:, None]).astype(dtype)

    ts = jnp.arange(1, T + 1, dtype=dtype)
    # Time-major layout so scan slices are contiguous: (T, B, d) / (T, B).
    z_tm = jnp.swapaxes(z, 0, 1)
    y_tm = jnp.swapaxes(y, 0, 1)
    v_tm = jnp.swapaxes(valid, 0, 1)
    is_ftrl = (alg_flag == ALG_FTRL)[:, None]

    def step(carry, inp):
        theta, cum_loss, x_prev = carry
        z_t, y_t, t, v = inp
        x_ftrl = ftrl_action(theta, jnp.full((B,), t, dtype=dtype), eta0)
        x_ftl = ftl_action(theta)
        x = jnp.where(is_ftrl, x_ftrl, x_ftl)
        q = jnp.sum(z_t * x, axis=-1)
        loss = normalized_hinge(q, y_t)
        g = hinge_subgradient(q, y_t)
        theta = theta + (v * g)[:, None] * z_t
        cum_loss = cum_loss + v * loss
        # Keep the last action actually played per sequence (padded rounds
        # must not overwrite it — reference RunResult.x_last semantics).
        x_keep = jnp.where((v > 0)[:, None], x, x_prev)
        return (theta, cum_loss, x_keep), None

    init = (jnp.zeros((B, d), dtype=dtype), jnp.zeros((B,), dtype=dtype),
            jnp.zeros((B, d), dtype=dtype))
    (theta, cum_loss, x_last), _ = jax.lax.scan(
        step, init, (z_tm, y_tm, ts, v_tm), unroll=unroll)

    x_comp = ftl_action(theta)
    q_all = jnp.einsum("btd,bd->bt", z, x_comp, precision=_HI)
    comp_loss = jnp.sum(normalized_hinge(q_all, y) * valid, axis=-1)
    return RunResult(cum_loss=cum_loss, regret=cum_loss - comp_loss,
                     comp_loss=comp_loss, x_last=x_last)
