"""Streaming (chunked-time) simulation for horizons beyond device memory.

SURVEY.md §5: the sound "sequence parallelism" for an online game is
chunked sequential hand-off over time — the carry (theta, cum_loss) is
O(B·d), so only the active (z, y) chunk needs to be resident.  This module
scans chunks produced by a host generator (or any iterable), giving
T = 10^6+ per sequence at constant device memory, with results identical
to the one-shot scan.

The same mechanism is the checkpoint/resume story for very long runs: the
carry is a tiny pytree; ``carry_state``/``resume`` serialize it between
chunk feeds.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Iterable, Iterator, Optional, Tuple

import jax
import jax.numpy as jnp

import numpy as np

from online_convex_optimization.models.base import RunResult
from online_convex_optimization.ops.actions import ftl_action, ftrl_action
from online_convex_optimization.ops import pallas_game as pg
from online_convex_optimization.ops.hinge import hinge_subgradient, normalized_hinge

# XLA's DEFAULT f32 matmul precision may round operands (TF32 on the GPU),
# which the parity paths cannot afford: every contraction pins HIGHEST.
_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GameState:
    """Carry of the streamed game.  ``t`` is the global 1-based round index
    of the next step; comparator sufficient stats are NOT carried — the
    final-FTL comparator needs a replay pass (see ``StreamingGame.comparator``).
    """

    theta: Any
    cum_loss: Any
    t: Any


@partial(jax.jit, donate_argnums=(0,))
def _advance(state: GameState, z_chunk, y_chunk, alg_flag, eta0) -> GameState:
    """Play one (CT, B, d) time chunk from ``state``."""
    CT = z_chunk.shape[0]
    B = z_chunk.shape[1]
    dtype = z_chunk.dtype
    is_ftrl = (alg_flag == 0)[:, None] if jnp.ndim(alg_flag) else alg_flag == 0
    ts = state.t + jnp.arange(CT, dtype=dtype)

    def step(carry, inp):
        theta, cum = carry
        z_t, y_t, t = inp
        x_ftrl = ftrl_action(theta, jnp.full((B,), t, dtype=dtype), eta0)
        x_ftl = ftl_action(theta)
        x = jnp.where(is_ftrl, x_ftrl, x_ftl)
        q = jnp.sum(z_t * x, axis=-1)
        loss = normalized_hinge(q, y_t)
        g = hinge_subgradient(q, y_t)
        return (theta + g[:, None] * z_t, cum + loss), None

    (theta, cum), _ = jax.lax.scan(step, (state.theta, state.cum_loss),
                                   (z_chunk, y_chunk, ts))
    return GameState(theta=theta, cum_loss=cum, t=state.t + CT)


class StreamingGame:
    """Feed arbitrary-length sequences through the game chunk by chunk.

    Usage:
        game = StreamingGame(B, d, alg_flag=0, eta0=2**0.5)
        for z_chunk, y_chunk in feed:     # (CT, B, d), (CT, B) time-major
            game.feed(z_chunk, y_chunk)
        result = game.result(comparator_feed)   # replay pass for comp loss
    """

    def __init__(self, B: int, d: int, *, alg_flag=0, eta0=1.0,
                 dtype=jnp.float32):
        self.alg_flag = jnp.asarray(alg_flag)
        self.eta0 = jnp.asarray(eta0, dtype)
        self.state = GameState(
            theta=jnp.zeros((B, d), dtype),
            cum_loss=jnp.zeros((B,), dtype),
            t=jnp.ones((), dtype))

    def feed(self, z_chunk, y_chunk) -> None:
        self.state = _advance(self.state, jnp.asarray(z_chunk),
                              jnp.asarray(y_chunk), self.alg_flag, self.eta0)

    def comparator_action(self) -> jnp.ndarray:
        return ftl_action(self.state.theta)

    def result(self, replay_feed: Iterable[Tuple[Any, Any]]) -> RunResult:
        """Finish: replay the sequence against the final FTL action.

        ``replay_feed`` re-yields the same (z_chunk, y_chunk) stream (the
        comparator needs one more pass over the data, matching
        fast_algorithms.py:113-115 semantics).
        """
        x_c = self.comparator_action()
        comp = jnp.zeros_like(self.state.cum_loss)
        for z_chunk, y_chunk in replay_feed:
            q = jnp.einsum("tbd,bd->tb", jnp.asarray(z_chunk), x_c,
                           precision=_HI)
            comp = comp + jnp.sum(normalized_hinge(q, jnp.asarray(y_chunk)),
                                  axis=0)
        cum = self.state.cum_loss
        return RunResult(cum_loss=cum, regret=cum - comp, comp_loss=comp,
                         x_last=x_c)

    # ---- checkpoint/resume ----
    def carry_state(self) -> dict:
        return {
            "theta": np.asarray(self.state.theta),
            "cum_loss": np.asarray(self.state.cum_loss),
            "t": np.asarray(self.state.t),
        }

    def resume(self, saved: dict) -> None:
        dtype = self.state.theta.dtype
        self.state = GameState(
            theta=jnp.asarray(saved["theta"], dtype),
            cum_loss=jnp.asarray(saved["cum_loss"], dtype),
            t=jnp.asarray(saved["t"], dtype))


class StreamingKernelGame:
    """Kernel-speed streaming: chunks advance through the carry-in/carry-out
    GPU game kernel (ops/pallas_game.py::play_packed_stream) instead of
    the XLA scan, and the hinge-identity statistics carried alongside make
    the final comparator an O(d) epilogue — no replay pass over the data
    (``StreamingGame.result`` needs one; the reference replays too,
    fast_algorithms.py:113-115).

    Requires the framework data contract (||z_t|| <= 1, y in {-1, 0, +1});
    f32/bf16 throughput semantics (parity lives in the scan/golden paths).
    ``interpret=True`` runs the kernel in the Pallas interpreter (CPU
    tests); otherwise it needs the GPU.

    Usage:
        game = StreamingKernelGame(B, d, alg_flag=0, eta0=2**0.5)
        for z_chunk, y_chunk in feed:   # (CT, B, d), (CT, B) time-major
            game.feed(z_chunk, y_chunk)
        regret, cum, comp = game.result()   # (B,) each — no second pass
    """

    def __init__(self, B: int, d: int, *, alg_flag: int = 0, eta0=1.0,
                 dtype=jnp.float32, interpret: bool = False,
                 validate: bool = False):
        self.B, self.d = B, d
        self.alg_flag = int(alg_flag)
        self.eta0 = float(eta0)
        self.dtype = dtype
        self.interpret = interpret
        self.validate = validate
        self.carry = pg.zero_stream_carry(pg.padded_size(B), d)
        self.t = 0

    def feed(self, z_chunk, y_chunk) -> None:
        z_pack, y_pack = pg.pack_time_major(z_chunk, y_chunk, self.dtype,
                                            validate=self.validate)
        self.feed_packed(z_pack, y_pack)

    def feed_packed(self, z_pack, y_pack) -> None:
        """Feed an already-packed (CT, d, Bp) chunk (e.g. generated on
        device) — no host involvement on the hot path."""
        self.carry = pg.play_packed_stream(
            z_pack, y_pack, self.eta0, self.t, self.carry,
            alg_flag=self.alg_flag, interpret=self.interpret)
        self.t += int(z_pack.shape[0])

    def feed_many_packed(self, z_stack, y_stack) -> None:
        """Feed N stacked packed chunks ((N, CT, d, Bp)) in one jitted
        program."""
        self.carry = pg.play_packed_stream_many(
            z_stack, y_stack, self.eta0, self.t, self.carry,
            alg_flag=self.alg_flag, interpret=self.interpret)
        self.t += int(z_stack.shape[0] * z_stack.shape[1])

    def comparator_action(self) -> jnp.ndarray:
        """Final FTL action per sequence, (B, d) — same comparator the
        scan path exposes (StreamingGame.comparator_action)."""
        theta2 = self.carry[0]                       # (d, Bp)
        x = ftl_action(theta2.T)                     # scale-invariant
        return x[:self.B]

    def result(self) -> RunResult:
        regret, cum, comp = pg.stream_result(self.carry)
        return RunResult(
            cum_loss=pg.unpack_result(cum, self.B),
            regret=pg.unpack_result(regret, self.B),
            comp_loss=pg.unpack_result(comp, self.B),
            x_last=self.comparator_action())

    # ---- checkpoint/resume (tiny O(B d) carry) ----
    def carry_state(self) -> dict:
        th, w, sc = self.carry
        return {"theta2": np.asarray(th), "w": np.asarray(w),
                "sc": np.asarray(sc), "t": np.asarray(self.t)}

    def resume(self, saved: dict) -> None:
        self.carry = (jnp.asarray(saved["theta2"], jnp.float32),
                      jnp.asarray(saved["w"], jnp.float32),
                      jnp.asarray(saved["sc"], jnp.float32))
        self.t = int(saved["t"])
