"""Regret kernels for the GPU: Pallas through Triton.

One program owns ``block`` sequences (a power of two) and plays the whole
horizon with a loop inside the program.  The learner state stays in
registers, one sequence per thread lane, and nothing is carried between
programs.  Inputs use a flat time-major layout, coalesced along the
sequence axis:

  z (T, d, Bp)    y (T, Bp)    eta (E, Bp)

where ``Bp`` is the sequence count padded to a multiple of ``BLOCK`` with
inert zero rows (z = 0, y = 0 give q = 0 and a zero subgradient).

The comparator (the final FTL action scored over the whole sequence,
fast_algorithms.py:113-115) needs no second pass over the data.  With
||z_t|| <= 1 and y in {-1, 0, +1} every unit-ball action has |q| <= 1, so

    0.5 * sum_t |<x, z_t> - y_t| == 0.5 * (cnt - <x, w>),
    w = sum_t y_t z_t,  cnt = sum_t y_t^2,

and carrying (w, cnt) beside the learner makes the comparator an O(d)
epilogue (``stream_result``).  Every data builder in this framework keeps
that contract; ``pack_sequences(validate=True)`` checks external data.

Step algebra (shared by every entry point): the accumulator is
theta2 = 2*theta (updates add sign(diff)*z), losses accumulate un-halved,
and the FTRL projection folds into the prediction,

    q = clip * scale * <z_t, theta>,  scale = -eta/sqrt(t),
    clip = rsqrt(max(scale^2 * ||theta||^2, 1)),

with the round index t computed in the kernel from the carried offset
``t0`` (so one kernel serves one-shot games and streamed chunks).

One kernel body (``_game_kernel``) serves all entry points:
  - ``play_packed_stream``: advance a carry (theta2, w, [cum, cnt]);
  - ``regrets_fused``: one advance from a zero carry + ``stream_result``;
  - ``eta_sweep_packed``: the eta grid is a second grid axis, so every
    setting re-reads the same z block and no data is duplicated.

This is the f32/bf16 throughput path; parity semantics live in the x64
scan (models/linear.py), which is also the reference these kernels are
tested against.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

BLOCK = 128            # the padding unit of Bp (a power of two)

# Launch defaults, measured on an H100 (PERF.md): 512 sequences per
# program with 4 warps (4 sequences per thread, independent dependency
# chains to overlap) and 8 rounds per loop iteration at d <= 8.  Wider
# features hold more state per sequence, so the block and the unroll
# shrink with d (``default_block``, ``default_unroll``; the compile time
# grows with d x unroll).  No software pipelining (num_stages=1): the
# loads of the unrolled rounds do not depend on the state, so they issue
# early anyway, and more stages measured no faster.
_NUM_WARPS = 4
_NUM_STAGES = 1

# Fill the card: shrink the block until there are at least this many
# programs (2 per SM of an H100's 132) or it reaches BLOCK.
_MIN_PROGRAMS = 264

# Feature widths the register-state kernel serves.  Its state is 2d + 2
# floats per sequence (3d + 6 for SMART).  Measured on an H100 at
# T=1024: 13x the scan at d=16, 9x at d=64; at d=128 the Triton compile
# did not finish in 6 minutes.  Past this bound the XLA scan takes over
# (``kernel_envelope``).
_D_KERNEL_MAX = 64


def use_kernels() -> bool:
    """The one backend decision: the compiled kernels run on the GPU, and
    everything else takes the XLA scan.  (Tests reach the kernels on the
    CPU by passing ``interpret=True`` explicitly.)"""
    return jax.default_backend() == "gpu"


def compiler_params(num_warps: int):
    return pl_triton.CompilerParams(num_warps=num_warps,
                                    num_stages=_NUM_STAGES)


# ------------------------------------------------------------------
# Shared in-kernel building blocks
# ------------------------------------------------------------------

def _ftl_eff(nth):
    """FTL action multiplier: x = eff * theta = -theta/||theta||, zero-safe."""
    return jnp.where(nth > 0.0, -jax.lax.rsqrt(jnp.maximum(nth, 1e-30)), 0.0)


def _ftrl_consts(t0, t, eta, eta2):
    """(scaleh, s2) of round t (0-based within the launch, global index
    t0 + t + 1): scaleh = -eta/(2 sqrt(t)), s2 = eta^2/(4 t), so
    diff = scaleh * rsqrt(max(s2 * ||theta2||^2, 1)) * <z, theta2> - y."""
    isq = jax.lax.rsqrt(t0 + jnp.asarray(t + 1).astype(jnp.float32))
    return eta * (-0.5 * isq), eta2 * (0.25 * isq * isq)


def _load_round(z_ref, y_ref, t, d):
    z_t = [z_ref[t, j, :].astype(jnp.float32) for j in range(d)]
    return z_t, y_ref[t, :].astype(jnp.float32)


def _dot_norm(z_t, th):
    dot = z_t[0] * th[0]
    nth = th[0] * th[0]
    for j in range(1, len(th)):
        dot = dot + z_t[j] * th[j]
        nth = nth + th[j] * th[j]
    return dot, nth


def _time_loop(T, unroll, one, state):
    """Run ``one(t, state)`` for t = 0..T-1: an unrolled loop plus a static
    remainder, so T needs no relation to the unroll factor."""
    unroll = max(1, min(unroll, T))

    def body(i, st):
        for u in range(unroll):
            st = one(i * unroll + u, st)
        return st

    n_main = T // unroll
    state = jax.lax.fori_loop(0, n_main, body, state)
    for t in range(n_main * unroll, T):
        state = one(t, state)
    return state


def _game_kernel(t0_ref, eta_ref, z_ref, y_ref, th_in, w_in, sc_in,
                 th_out, w_out, sc_out, *, T: int, d: int, alg_flag: int,
                 unroll: int):
    """Advance (theta2, w, cum, cnt) of ``block`` sequences over T rounds.

    Refs: t0 (1,) f32 rounds already played; eta (block,); z (T, d, block);
    y (T, block); carries th/w (d, block), sc (2, block) = [cum, cnt].
    """
    eta = eta_ref[...]
    eta2 = eta * eta
    t0 = t0_ref[0]

    def one(t, st):
        th, w, cum, cnt = st
        z_t, y_t = _load_round(z_ref, y_ref, t, d)
        dot, nth = _dot_norm(z_t, th)
        if alg_flag == 0:
            scaleh, s2 = _ftrl_consts(t0, t, eta, eta2)
            clip = jax.lax.rsqrt(jnp.maximum(s2 * nth, 1.0))
            diff = (scaleh * clip) * dot - y_t
        else:
            diff = _ftl_eff(nth) * dot - y_t
        s = jnp.sign(diff)
        cum = cum + diff * s                    # == |q - y| (un-halved)
        th = [th[j] + s * z_t[j] for j in range(d)]
        w = [w[j] + y_t * z_t[j] for j in range(d)]
        cnt = cnt + y_t * y_t
        return th, w, cum, cnt

    state = ([th_in[j, :] for j in range(d)], [w_in[j, :] for j in range(d)],
             sc_in[0, :], sc_in[1, :])
    th, w, cum, cnt = _time_loop(T, unroll, one, state)
    for j in range(d):
        th_out[j, :] = th[j]
        w_out[j, :] = w[j]
    sc_out[0, :] = cum
    sc_out[1, :] = cnt


def default_block(d: int) -> int:
    """Preferred sequences per program at feature width d."""
    return 512 if d <= 8 else 256 if d <= 16 else BLOCK


def default_unroll(d: int) -> int:
    """Rounds per loop iteration at feature width d."""
    return 8 if d <= 8 else 4


def pick_block(Bp: int, block: int) -> int:
    """Largest power of two <= ``block`` dividing the padded batch, shrunk
    toward BLOCK while the grid would leave SMs idle."""
    blk = block
    while Bp % blk or (blk > BLOCK and Bp // blk < _MIN_PROGRAMS):
        blk //= 2
    if blk < 16:
        raise ValueError(f"padded batch {Bp} is not a multiple of 16")
    return blk


def _advance(z_pack, y_pack, eta_EB, t0, carry, *, alg_flag, block, unroll,
             interpret):
    """The one launch: grid (sequence blocks, eta settings); the E axis
    re-reads the same z block, the carry has a leading E axis."""
    T, d, Bp = z_pack.shape
    E = eta_EB.shape[0]
    th_in, w_in, sc_in = carry
    assert y_pack.shape == (T, Bp), (y_pack.shape, (T, Bp))
    assert th_in.shape == (E, d, Bp), (th_in.shape, (E, d, Bp))
    assert sc_in.shape == (E, 2, Bp), (sc_in.shape, (E, 2, Bp))
    blk = pick_block(Bp, block or default_block(d))
    t0_arr = jnp.reshape(jnp.asarray(t0, jnp.float32), (1,))
    state_spec = pl.BlockSpec((None, d, blk), lambda i, e: (e, 0, i))
    sc_spec = pl.BlockSpec((None, 2, blk), lambda i, e: (e, 0, i))
    kernel = functools.partial(_game_kernel, T=T, d=d, alg_flag=alg_flag,
                               unroll=unroll or default_unroll(d))
    return pl.pallas_call(
        kernel,
        grid=(Bp // blk, E),
        in_specs=[
            pl.BlockSpec((1,), lambda i, e: (0,)),
            pl.BlockSpec((None, blk), lambda i, e: (e, i)),
            pl.BlockSpec((T, d, blk), lambda i, e: (0, 0, i)),
            pl.BlockSpec((T, blk), lambda i, e: (0, i)),
            state_spec, state_spec, sc_spec,
        ],
        out_specs=[state_spec, state_spec, sc_spec],
        out_shape=[
            jax.ShapeDtypeStruct((E, d, Bp), jnp.float32),
            jax.ShapeDtypeStruct((E, d, Bp), jnp.float32),
            jax.ShapeDtypeStruct((E, 2, Bp), jnp.float32),
        ],
        compiler_params=compiler_params(_NUM_WARPS),
        interpret=interpret,
        name="oco_game",
    )(t0_arr, eta_EB, z_pack, y_pack, th_in, w_in, sc_in)


_KERNEL_STATIC = ("alg_flag", "block", "unroll", "interpret")


def zero_stream_carry(Bp: int, d: int, E: int | None = None):
    """Fresh carry (theta2, w, [cum, cnt]) for ``Bp`` padded sequences; with
    ``E`` each array gets a leading eta-setting axis."""
    lead = () if E is None else (E,)
    return (jnp.zeros(lead + (d, Bp), jnp.float32),
            jnp.zeros(lead + (d, Bp), jnp.float32),
            jnp.zeros(lead + (2, Bp), jnp.float32))


@functools.partial(jax.jit, static_argnames=_KERNEL_STATIC)
def play_packed_stream(z_pack, y_pack, eta, t0, carry, *, alg_flag: int = 0,
                       block: int = 0, unroll: int = 0,
                       interpret: bool = False):
    """Advance the streamed game over one packed time chunk.

    Args:
      z_pack: (T_chunk, d, Bp) f32/bf16; y_pack: (T_chunk, Bp) f32/bf16/int8.
      eta: scalar or (Bp,) FTRL step size (ignored for alg_flag=1).
      t0: rounds already played (traced scalar OK); row k is global round
        t0 + k + 1.  The index is carried in f32, exact up to 2^24 rounds.
      carry: (theta2 (d, Bp), w (d, Bp), sc (2, Bp) = [cum, cnt]) from
        ``zero_stream_carry`` or a previous call.
    Returns: the advanced carry (same structure).
    """
    eta_1B = jnp.broadcast_to(jnp.asarray(eta, jnp.float32),
                              (1, z_pack.shape[2]))
    th, w, sc = _advance(
        z_pack, y_pack, eta_1B, t0,
        tuple(c[None] for c in carry), alg_flag=alg_flag, block=block,
        unroll=unroll, interpret=interpret)
    return th[0], w[0], sc[0]


@functools.partial(jax.jit, static_argnames=_KERNEL_STATIC)
def play_packed_stream_many(z_stack, y_stack, eta, t0, carry, *,
                            alg_flag: int = 0, block: int = 0,
                            unroll: int = 0, interpret: bool = False):
    """Advance the streamed game over N stacked chunks
    ((N, T_chunk, d, Bp) / (N, T_chunk, Bp)) in one jitted program: a
    ``lax.scan`` chains the carry through the N kernel launches."""
    CT = z_stack.shape[1]
    kw = dict(alg_flag=alg_flag, block=block, unroll=unroll,
              interpret=interpret)

    def body(state, zy):
        c, t = state
        c = play_packed_stream(zy[0], zy[1], eta, t, c, **kw)
        return (c, t + CT), None

    (carry, _), _ = jax.lax.scan(
        body, (carry, jnp.asarray(t0, jnp.float32)), (z_stack, y_stack))
    return carry


@jax.jit
def stream_result(carry):
    """Regret + decomposition from a carry via the hinge identity — no
    replay pass.  Works on any leading axes.  Returns (regret, cum_loss,
    comp_loss), halved back to reference scale."""
    theta2, w, sc = carry
    nth = jnp.sum(theta2 * theta2, axis=-2)
    dotw = jnp.sum(theta2 * w, axis=-2)
    comp2 = sc[..., 1, :] - _ftl_eff(nth) * dotw
    cum = 0.5 * sc[..., 0, :]
    comp = 0.5 * comp2
    return cum - comp, cum, comp


@functools.partial(jax.jit, static_argnames=_KERNEL_STATIC)
def regrets_fused(z_pack, y_pack, eta, *, alg_flag: int = 0,
                  block: int = 0, unroll: int = 0, interpret: bool = False):
    """Regret of every packed sequence in one pass over (z, y): one stream
    advance from a zero carry, then the O(d) identity comparator.

    Args:
      z_pack: (T, d, Bp) f32/bf16; y_pack: (T, Bp) f32/bf16/int8.
      eta: scalar FTRL step size, or (Bp,) per sequence.  Ignored for FTL.
    Returns: (Bp,) f32 regrets.
    """
    T, d, Bp = z_pack.shape
    carry = play_packed_stream(
        z_pack, y_pack, eta, 0.0, zero_stream_carry(Bp, d),
        alg_flag=alg_flag, block=block, unroll=unroll, interpret=interpret)
    return stream_result(carry)[0]


@functools.partial(jax.jit, static_argnames=_KERNEL_STATIC)
def eta_sweep_packed(z_pack, y_pack, eta_grid, *, alg_flag: int = 0,
                     block: int = 0, unroll: int = 0,
                     interpret: bool = False):
    """FTRL regrets for every (eta setting, sequence) pair: the grid's
    second axis walks the settings over the same z blocks.

    Args: z_pack (T, d, Bp); y_pack (T, Bp); eta_grid (E,).
    Returns: (E, Bp) regrets.
    """
    T, d, Bp = z_pack.shape
    etas = jnp.asarray(eta_grid, jnp.float32)
    E = etas.shape[0]
    eta_EB = jnp.broadcast_to(etas[:, None], (E, Bp))
    carry = _advance(z_pack, y_pack, eta_EB, 0.0, zero_stream_carry(Bp, d, E),
                     alg_flag=alg_flag, block=block, unroll=unroll,
                     interpret=interpret)
    return stream_result(carry)[0]


# ------------------------------------------------------------------
# Packing: (B, T, d) <-> the kernels' (T, d, Bp) layout
# ------------------------------------------------------------------

def _check_contract(z, y):
    """The identity comparator's data contract: ||z_t||_2 <= 1 per row and
    y in {-1, 0, +1}.  Costs a device sync."""
    max_norm = float(jnp.max(jnp.sum(jnp.square(z.astype(jnp.float32)),
                                     axis=-1)))
    if max_norm > 1.0 + 1e-5:
        raise ValueError(
            f"rows must lie in the unit L2 ball (max ||z||^2 = "
            f"{max_norm:.6f}); clip rows like the data builders do")
    yf = y.astype(jnp.float32)
    if float(jnp.max(jnp.abs(yf * yf * yf - yf))) > 1e-6:
        raise ValueError("labels must be in {-1, 0, +1}")


def padded_size(B: int) -> int:
    return B + (-B) % BLOCK


def pack_sequences(z, y, dtype=jnp.float32, *, validate: bool = False,
                   y_dtype=None):
    """(B, T, d) / (B, T) -> ((T, d, Bp), (T, Bp), B).

    ``dtype`` is the storage of z (f32, or bf16 for half the bytes; the
    kernels compute in f32).  ``y_dtype`` (default ``dtype``) stores the
    labels on their own: ``jnp.int8`` is value-exact and the smallest.
    ``validate=True`` enforces the identity contract (``_check_contract``).
    """
    z = jnp.asarray(z)
    y = jnp.asarray(y)
    B = z.shape[0]
    if validate:
        _check_contract(z, y)
    pad = padded_size(B) - B
    z_pack = jnp.pad(jnp.transpose(z.astype(dtype), (1, 2, 0)),
                     ((0, 0), (0, 0), (0, pad)))
    y_pack = jnp.pad(y.astype(y_dtype or dtype).T, ((0, 0), (0, pad)))
    return z_pack, y_pack, B


def pack_time_major(z_chunk, y_chunk, dtype=jnp.float32, *,
                    validate: bool = False, y_dtype=None):
    """Time-major (CT, B, d) / (CT, B) chunk -> ((CT, d, Bp), (CT, Bp)),
    sequence order as ``pack_sequences``."""
    z = jnp.asarray(z_chunk)
    y = jnp.asarray(y_chunk)
    if validate:
        _check_contract(z, y)
    pad = padded_size(z.shape[1]) - z.shape[1]
    z_pack = jnp.pad(jnp.transpose(z.astype(dtype), (0, 2, 1)),
                     ((0, 0), (0, 0), (0, pad)))
    y_pack = jnp.pad(y.astype(y_dtype or dtype), ((0, 0), (0, pad)))
    return z_pack, y_pack


def pack_per_seq(vals) -> jnp.ndarray:
    """(B,) per-sequence values (e.g. an eta grid) -> (Bp,) f32."""
    v = jnp.asarray(vals, jnp.float32)
    return jnp.pad(v, (0, padded_size(v.shape[0]) - v.shape[0]))


def unpack_result(res, B: int) -> jnp.ndarray:
    """(..., Bp) kernel output -> (..., B) in the original sequence order."""
    return res[..., :B]


# ------------------------------------------------------------------
# Dispatch: kernel or scan
# ------------------------------------------------------------------

def kernel_envelope(d: int):
    """None if the register-state kernel serves width ``d``; otherwise the
    reason the XLA scan takes the shape."""
    if d > _D_KERNEL_MAX:
        return (f"d={d} past the register-state kernel's bound "
                f"(d<={_D_KERNEL_MAX}); the scan serves wider features")
    return None


def simulate_linear_auto(z, y, alg_flag: int, eta0, *,
                         interpret: bool = False):
    """(B,) regrets: the kernel on the GPU (or explicitly interpreted)
    inside its envelope, the XLA scan otherwise — the same values either
    way up to f32 rounding (the scan is the kernel's reference)."""
    z = jnp.asarray(z)
    y = jnp.asarray(y)
    B, T, d = z.shape
    if (interpret or use_kernels()) and kernel_envelope(d) is None:
        z_pack, y_pack, B = pack_sequences(z, y, jnp.float32)
        eta = jnp.asarray(eta0, jnp.float32)
        if eta.ndim == 1:
            assert alg_flag == 0, "per-sequence eta is FTRL-only"
            eta = pack_per_seq(eta)
        reg = regrets_fused(z_pack, y_pack, eta, alg_flag=alg_flag,
                            interpret=interpret)
        return unpack_result(reg, B)
    from online_convex_optimization.models.linear import (
        simulate_linear_batch)
    return simulate_linear_batch(z, y, alg_flag, eta0).regret
