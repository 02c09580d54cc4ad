"""On-device sequence generation (jax.random) — the throughput path.

The host-NumPy builders in ``sequences.py`` are bit-exact with the
reference's PCG64 streams and exist for parity runs; they cannot feed a pod
(10^6 sequences x T=10^3 is ~20 GB of host->device traffic per sweep).
This module generates the same *distributions* directly on device with
``jax.random`` (threefry), shardable by passing per-shard keys:

  - g(T)-style instances: clipped Gaussian rows + Rademacher labels
    (algorithms.py:155-163's distribution, not its bitstream)
  - separable / Massart-noise streams (sequence_generation.py:54-90)
  - direct generation in the kernels' (T, d, B) layout
    (ops/pallas_game.py), so they consume it with no reshuffling;
  - Rademacher unit rows keyed by a seed-block id, the default sequence
    source of the sharded g sweep (parallel/sweep.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


# Strict-ball deflation: a plain f32 clip z/max(||z||,1) leaves rounded
# rows whose EXACT norms exceed 1 by ~1e-7, which voids the a-priori
# optimality certificate below.  Deflating by 2e-6 (>> the ~5e-7 worst-
# case f32 rounding inflation of norm + divide + per-component rounding)
# guarantees exact row norms <= 1, so by Cauchy-Schwarz every prediction
# of every unit-ball action satisfies |q| <= 1 and the linear-regime
# identity |q - y| = 1 - q y (models/linear_regime.py) holds EXACTLY for
# every prefix of every device-generated sequence: the fused kernels'
# FTL track (actions w_t/||w_t||) plays the certified-exact FTL
# minimizers — exact FTL at kernel throughput, certified A PRIORI.
# (f32 storage only: bf16 packing re-rounds rows by up to 2^-9, so
# bf16-stored games are near-exact rather than certified.)
_STRICT = 1.0 - 2e-6


def _clip_rows(z: jnp.ndarray) -> jnp.ndarray:
    """Row-wise strict clip into the unit ball (see _STRICT)."""
    norms = jnp.sqrt(jnp.sum(z * z, axis=-1, keepdims=True))
    return z * (_STRICT / jnp.maximum(norms, 1.0))


@partial(jax.jit, static_argnames=("B", "T", "d"))
def random_game_batch(key, B: int, T: int, d: int = 5):
    """g(T)-style worst-case-estimation batch: (B, T, d) z and (B, T) y."""
    kz, ky = jax.random.split(key)
    z = _clip_rows(jax.random.normal(kz, (B, T, d), jnp.float32))
    y = jax.random.rademacher(ky, (B, T), jnp.float32)
    return z, y


@partial(jax.jit, static_argnames=("B", "T", "d", "noise_p"))
def separable_stream_batch(key, B: int, T: int, d: int = 5,
                           noise_p: float = 0.0):
    """Separable (optionally Massart-noisy) streams with per-sequence
    ground truths; returns (z, y, u)."""
    ku, kz, kf = jax.random.split(key, 3)
    u = jax.random.normal(ku, (B, d), jnp.float32)
    u = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-30)
    z = _clip_rows(jax.random.normal(kz, (B, T, d), jnp.float32))
    q = jnp.einsum("btd,bd->bt", z, u, precision=jax.lax.Precision.HIGHEST)
    y = jnp.where(q >= 0.0, 1.0, -1.0)
    if noise_p > 0.0:
        flips = jax.random.bernoulli(kf, noise_p, (B, T))
        y = jnp.where(flips, -y, y)
    return z, y, u


@partial(jax.jit, static_argnames=("B", "T", "d", "sigma"))
def regression_stream_batch(key, B: int, T: int, d: int = 5,
                            sigma: float = 0.1):
    """Quadratic-track regression streams (real-valued targets), device
    twin of data.sequences.make_regression_stream; returns (z, y, u)."""
    ku, kz, kn = jax.random.split(key, 3)
    u = jax.random.normal(ku, (B, d), jnp.float32)
    u = u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-30)
    z = _clip_rows(jax.random.normal(kz, (B, T, d), jnp.float32))
    y = (jnp.einsum("btd,bd->bt", z, u,
                    precision=jax.lax.Precision.HIGHEST)
         + sigma * jax.random.normal(kn, (B, T), jnp.float32))
    return z, y, u


@partial(jax.jit, static_argnames=("T", "B", "d", "dtype", "y_dtype"))
def random_packed_batch(key, T: int, B: int, d: int = 5,
                        dtype=jnp.float32, y_dtype=None):
    """Generate directly in the kernel layout: (T, d, B) z and (T, B) y.

    ``y_dtype`` (default: ``dtype``) stores the labels on their own;
    ``jnp.int8`` is value-exact (+-1 labels) and the smallest."""
    kz, ky = jax.random.split(key)
    z = jax.random.normal(kz, (T, d, B), jnp.float32)
    norms = jnp.sqrt(jnp.sum(z * z, axis=1, keepdims=True))
    z = (z * (_STRICT / jnp.maximum(norms, 1.0))).astype(dtype)
    y = jax.random.rademacher(ky, (T, B), jnp.float32).astype(
        y_dtype if y_dtype is not None else dtype)
    return z, y


@partial(jax.jit, static_argnames=("T", "B", "d"))
def rademacher_packed_batch(seed, T: int, B: int, d: int = 5):
    """Rademacher rows scaled 1/sqrt(d) (exact unit norm in f32 up to one
    rounding, deflated by _STRICT so every row stays inside the ball) and
    Rademacher labels, in the kernel layout: (T, d, B) f32, (T, B) int8.
    ``seed`` may be traced: the sequences depend on it alone."""
    kz, ky = jax.random.split(jax.random.key(seed))
    z = jax.random.rademacher(kz, (T, d, B), jnp.float32)
    z = z * jnp.float32(_STRICT / float(d) ** 0.5)
    y = jax.random.rademacher(ky, (T, B), jnp.int8)
    return z, y


def shard_keys(key, n_shards: int):
    """Independent per-shard keys for multi-host / multi-device generation."""
    return jax.random.split(key, n_shards)
