"""Single-pass SMART kernel for the GPU (Pallas through Triton).

Reference semantics (fast_algorithms.py:118-164): an always-on FTL track,
a pre-switch threshold test against the FTL lead over the prefix
comparator, and a fresh-at-switch FTRL track with the global round index.
The reference recomputes the prefix comparator loss every round — O(T^2 d)
sequential work (fast_algorithms.py:157-158).

This kernel runs the whole algorithm — both tracks, the switch test and
the final comparator — in one pass over (z, y) at O(T d), using the hinge
identity (ops/pallas_game.py): with ||z_t|| <= 1, y in {-1, 0 (pad), +1}
and every action in the unit L2 ball,

    0.5 * sum_{i<=t} |<s, z_i> - y_i|  ==  0.5 * (cnt_t - <s, w_t>),

so the prefix comparator loss of any candidate action is an O(d) dot
against carried statistics, and the final comparator needs no replay.

Layout and conventions follow ops/pallas_game.py: one program owns
``block`` sequences and loops over the horizon; the 3d + 6 state floats of
a sequence stay in registers; theta accumulators are doubled and losses
un-halved.  The (threshold, eta) settings are the grid's second axis, so a
threshold sweep re-reads the same z block instead of duplicating it.

The switch is pure dataflow: ``a`` (active FTRL) is a 0/1 mask set the
round after the threshold test first passes, matching the reference's
"switch starting next round" semantics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from online_convex_optimization.ops.pallas_game import (
    _dot_norm,
    _ftl_eff,
    _ftrl_consts,
    _load_round,
    _time_loop,
    compiler_params,
    default_block,
    pack_per_seq,
    pack_sequences,
    pick_block,
    unpack_result,
)

# Launch defaults measured on an H100 (PERF.md): the SMART step carries
# 3d + 6 floats, and 8 warps over 512 sequences measured fastest.
_NUM_WARPS = 8
_UNROLL = 4


def _smart_round(z_t, y_t, sh, s2v, th2, state):
    """One SMART round.  sh / s2v: this round's FTRL constants with eta
    folded in; th2 = 2 * threshold.  state = (th, w, thr, cnt, F, total,
    a, na, nth)."""
    th, w, thr, cnt, F, total, a, na, nth = state
    d = len(th)

    # FTL track: play the pre-update action, update theta2.
    dotF = z_t[0] * th[0]
    for j in range(1, d):
        dotF = dotF + z_t[j] * th[j]
    diffF = _ftl_eff(nth) * dotF - y_t          # nth: pre-update ||theta2||^2
    sF = jnp.sign(diffF)
    lossF = diffF * sF                          # == |q - y| (un-halved)
    F = F + lossF
    th = [th[j] + sF * z_t[j] for j in range(d)]

    # Identity statistics.
    w = [w[j] + y_t * z_t[j] for j in range(d)]
    cnt = cnt + y_t * y_t

    # Switch test on the post-update action s_t.
    nth = th[0] * th[0]
    dotw = th[0] * w[0]
    for j in range(1, d):
        nth = nth + th[j] * th[j]
        dotw = dotw + th[j] * w[j]
    lead2 = F - cnt + _ftl_eff(nth) * dotw      # == 2 * (ftl_loss - s_loss)
    hit = (1.0 - a) * (lead2 >= th2).astype(jnp.float32)
    na = na + (1.0 - a)                         # pre-switch round counter

    # FTRL track, gated on a (switched in an earlier round).
    dotR, nthR = _dot_norm(z_t, thr)
    clip = jax.lax.rsqrt(jnp.maximum(s2v * nthR, 1.0))
    diffR = (sh * clip) * dotR - y_t
    sR = jnp.sign(diffR)
    total = total + lossF + a * (diffR * sR - lossF)
    gR = a * sR
    thr = [thr[j] + gR * z_t[j] for j in range(d)]
    a = a + hit                                 # switch applies next round
    return th, w, thr, cnt, F, total, a, na, nth


def _smart_kernel(th2_ref, eta_ref, z_ref, y_ref, reg_ref, tau_ref, *,
                  T: int, d: int, unroll: int):
    """SMART over T rounds for ``block`` sequences.

    Refs: th2 = 2*threshold (block,); eta (block,); z (T, d, block);
    y (T, block).  Outputs: regret (block,); tau = switch round, T if none.
    """
    th2 = th2_ref[...]
    eta = eta_ref[...]
    eta2 = eta * eta
    zero = jnp.zeros_like(eta)

    def one(t, state):
        z_t, y_t = _load_round(z_ref, y_ref, t, d)
        sh, s2v = _ftrl_consts(0.0, t, eta, eta2)
        return _smart_round(z_t, y_t, sh, s2v, th2, state)

    state = ([zero] * d, [zero] * d, [zero] * d) + (zero,) * 6
    th, w, thr, cnt, F, total, a, na, nth = _time_loop(T, unroll, one, state)
    # Comparator = final FTL action scored by the identity: no replay.
    dotw = th[0] * w[0]
    for j in range(1, d):
        dotw = dotw + th[j] * w[j]
    comp2 = cnt - _ftl_eff(nth) * dotw          # un-halved comparator loss
    reg_ref[...] = 0.5 * (total - comp2)
    tau_ref[...] = na - a                       # T if never switched


def _smart_call(z_pack, y_pack, th2_GB, eta_GB, *, block, unroll,
                interpret):
    T, d, Bp = z_pack.shape
    G = th2_GB.shape[0]
    blk = pick_block(Bp, block or default_block(d))
    row = pl.BlockSpec((None, blk), lambda i, g: (g, i))
    kernel = functools.partial(_smart_kernel, T=T, d=d, unroll=unroll)
    return pl.pallas_call(
        kernel,
        grid=(Bp // blk, G),
        in_specs=[
            row, row,
            pl.BlockSpec((T, d, blk), lambda i, g: (0, 0, i)),
            pl.BlockSpec((T, blk), lambda i, g: (0, i)),
        ],
        out_specs=[row, row],
        out_shape=[jax.ShapeDtypeStruct((G, Bp), jnp.float32)] * 2,
        compiler_params=compiler_params(_NUM_WARPS),
        interpret=interpret,
        name="oco_smart",
    )(th2_GB, eta_GB, z_pack, y_pack)


_STATIC = ("block", "unroll", "interpret")


@functools.partial(jax.jit, static_argnames=_STATIC)
def smart_regrets_packed(z_pack, y_pack, thresh, eta, *, block: int = 0,
                         unroll: int = _UNROLL, interpret: bool = False):
    """SMART regrets on packed sequences.

    Args:
      z_pack: (T, d, Bp) f32/bf16, rows in the unit L2 ball;
      y_pack: (T, Bp) in {-1, 0 (padding), +1};
      thresh, eta: scalars or (Bp,) per-sequence switch thresholds and
        FTRL step sizes.
    Returns: (regret (Bp,) f32, switch_t (Bp,) f32 — T when never switched).
    """
    Bp = z_pack.shape[2]
    th2 = 2.0 * jnp.broadcast_to(jnp.asarray(thresh, jnp.float32), (1, Bp))
    et = jnp.broadcast_to(jnp.asarray(eta, jnp.float32), (1, Bp))
    reg, tau = _smart_call(z_pack, y_pack, th2, et, block=block,
                           unroll=unroll, interpret=interpret)
    return reg[0], tau[0]


@functools.partial(jax.jit, static_argnames=_STATIC)
def smart_sweep_packed(z_pack, y_pack, thresh_grid, eta0, *,
                       block: int = 0, unroll: int = _UNROLL,
                       interpret: bool = False):
    """SMART regrets for every (threshold, sequence) pair: the thresholds
    are the grid's second axis over the same z blocks.

    Args: z_pack (T, d, Bp); y_pack (T, Bp); thresh_grid (G,); eta0 scalar.
    Returns: (regret (G, Bp), switch_t (G, Bp) f32 — T if never).
    """
    Bp = z_pack.shape[2]
    ths = jnp.asarray(thresh_grid, jnp.float32)
    G = ths.shape[0]
    th2 = jnp.broadcast_to(2.0 * ths[:, None], (G, Bp))
    et = jnp.broadcast_to(jnp.asarray(eta0, jnp.float32), (G, Bp))
    return _smart_call(z_pack, y_pack, th2, et, block=block,
                       unroll=unroll, interpret=interpret)


def simulate_smart_pallas(z, y, theta_thresh, eta0, *, dtype=jnp.float32,
                          interpret: bool = False):
    """Batched SMART through the kernel ((B, T, d) API).

    ``theta_thresh`` / ``eta0``: scalars or (B,) arrays.  Returns
    (regret (B,), switch_t (B,) int32 — T when never switched), matching
    ``models.smart.simulate_smart_batch``.
    """
    z_pack, y_pack, B = pack_sequences(z, y, dtype)
    th = jnp.broadcast_to(jnp.asarray(theta_thresh, jnp.float32), (B,))
    et = jnp.broadcast_to(jnp.asarray(eta0, jnp.float32), (B,))
    regret, tau = smart_regrets_packed(z_pack, y_pack, pack_per_seq(th),
                                       pack_per_seq(et), interpret=interpret)
    return (unpack_result(regret, B),
            unpack_result(tau, B).astype(jnp.int32))
