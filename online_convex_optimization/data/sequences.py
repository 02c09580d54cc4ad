"""Sequence families and stream builders (host-NumPy parity path).

Reproduces the four families and registries of the reference's
sequence_generation.py with identical RNG consumption order so inputs are
bitwise identical:

  - label flips           : sequence_generation.py:24-28
  - switching two leaders : sequence_generation.py:36-47
  - random i.i.d. stream  : sequence_generation.py:54-70  (u stream 11,
    data stream 13+rep; rows *clipped* — not normalized — to the unit ball)
  - Massart-noise stream  : sequence_generation.py:72-90  (u stream 21,
    data stream 23+rep, flip probability drawn after labels)
  - CASES / RUNS / REPLICATES registries : sequence_generation.py:104-123

This module is deliberately NumPy-on-host: PCG64 ziggurat streams are not
reproducible with ``jax.random``, and bitwise-identical inputs are a
precondition for the 1e-6 parity bar (SURVEY.md §7).  Batched helpers stack
replicates into ``(B, T, d)`` device-ready arrays; the pure-throughput
on-device generator lives in ``data/device.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from online_convex_optimization.data.rng import rng_stream

Sample = Tuple[np.ndarray, np.ndarray, np.ndarray]
SamplerFn = Callable[..., Sample]


# ------------------------------------------------------------------
# Deterministic adversarial families
# ------------------------------------------------------------------

def flip_sequence(T: int, d: int = 5, dtype=np.float32) -> Sample:
    """Alternating labels (+1, -1, +1, ...) with z = e1 every round.

    Round index t runs 1..T and odd rounds get +1
    (sequence_generation.py:26: ``1.0 if t % 2 else -1.0``).
    """
    z = np.zeros((T, d), dtype=dtype)
    z[:, 0] = 1.0
    y = np.where(np.arange(1, T + 1) % 2 == 1, 1.0, -1.0).astype(dtype)
    u = np.zeros(d, dtype=dtype)
    return z, y, u


def switching_two_leaders_sequence(T: int, *, block_len: int = 20, d: int = 5,
                                   dtype=np.float32) -> Sample:
    """Fixed-length alternating blocks of +1 then -1 labels, z = e1."""
    blocks = np.arange(T) // block_len
    y = np.where(blocks % 2 == 0, 1.0, -1.0).astype(dtype)
    z = np.zeros((T, d), dtype=dtype)
    z[:, 0] = 1.0
    u = np.zeros(d, dtype=dtype)
    return z, y, u


# ------------------------------------------------------------------
# Random stream builders (fixed task per run; fresh sequences per (T, rep))
# ------------------------------------------------------------------

def _clip_rows_to_unit_ball(z: np.ndarray) -> np.ndarray:
    """Row-wise clip (not normalize): ``z_i *= 1/max(||z_i||, 1)``.

    The clip-vs-normalize distinction is a parity-relevant detail
    (sequence_generation.py:64-66).
    """
    norms = np.linalg.norm(z, axis=1, keepdims=True).astype(z.dtype, copy=False)
    np.maximum(norms, 1.0, out=norms)
    z *= 1.0 / norms
    return z


def _unit_ground_truth(run_seed: int, stream: int, d: int) -> np.ndarray:
    gen_u = rng_stream(run_seed, 0, stream)
    u = gen_u.standard_normal(d).astype(np.float32, copy=False)
    n = float(np.linalg.norm(u))
    if n > 0:
        u /= n
    return u


def make_random_iid_stream(*, d: int = 5, run_seed: int = 0) -> SamplerFn:
    """Separable i.i.d. stream: y = sign(z @ u) with ties mapped to +1."""
    u = _unit_ground_truth(run_seed, 11, d)

    def sample(T: int, rep: int = 0) -> Sample:
        gen = rng_stream(run_seed, T, 13 + rep)
        z = gen.standard_normal((T, d)).astype(np.float32, copy=False)
        z = _clip_rows_to_unit_ball(z)
        y = np.sign(z @ u).astype(np.float32, copy=False)
        y[y == 0.0] = 1.0
        return z, y, u

    return sample


def make_noisy_iid_stream(*, p: float, d: int = 5, run_seed: int = 0) -> SamplerFn:
    """Separable stream plus Massart label noise at rate ``p``."""
    u = _unit_ground_truth(run_seed, 21, d)

    def sample(T: int, rep: int = 0) -> Sample:
        gen = rng_stream(run_seed, T, 23 + rep)
        z = gen.standard_normal((T, d)).astype(np.float32, copy=False)
        z = _clip_rows_to_unit_ball(z)
        y = np.sign(z @ u).astype(np.float32, copy=False)
        y[y == 0.0] = 1.0
        flips = gen.random(T) < p
        y[flips] *= -1.0
        return z, y, u

    return sample


def make_regression_stream(*, sigma: float = 0.1, d: int = 5,
                           run_seed: int = 0) -> SamplerFn:
    """Regression stream for the quadratic-loss track (BASELINE.json
    config 1; no reference analog): real-valued targets
    y = <z, u> + sigma * N(0, 1) with clipped-Gaussian rows.  Seed
    streams 31 (ground truth) / 33+rep (data) extend the reference's
    11/13, 21/23 numbering without colliding with it."""
    u = _unit_ground_truth(run_seed, 31, d)

    def sample(T: int, rep: int = 0) -> Sample:
        gen = rng_stream(run_seed, T, 33 + rep)
        z = gen.standard_normal((T, d)).astype(np.float32, copy=False)
        z = _clip_rows_to_unit_ball(z)
        y = (z @ u + sigma * gen.standard_normal(T)).astype(np.float32,
                                                            copy=False)
        return z, y, u

    return sample


def make_flip_stream(*, d: int = 5, run_seed: int = 0) -> SamplerFn:
    def sample(T: int, rep: int = 0) -> Sample:
        return flip_sequence(T, d=d)
    return sample


def make_switching_two_leaders_stream(*, block_len: int = 20, d: int = 5,
                                      run_seed: int = 0) -> SamplerFn:
    def sample(T: int, rep: int = 0) -> Sample:
        return switching_two_leaders_sequence(T, block_len=block_len, d=d)
    return sample


# ------------------------------------------------------------------
# Registries (sequence_generation.py:104-123)
# ------------------------------------------------------------------

CASES: Dict[str, Callable[..., SamplerFn]] = {
    "Random i.i.d. (separable)": lambda *, run_seed: make_random_iid_stream(d=5, run_seed=run_seed),
    "Massart noise 10%": lambda *, run_seed: make_noisy_iid_stream(p=0.10, d=5, run_seed=run_seed),
    "Label flips": lambda *, run_seed: make_flip_stream(d=5, run_seed=run_seed),
    "Switching leaders": lambda *, run_seed: make_switching_two_leaders_stream(block_len=20, d=5, run_seed=run_seed),
}

RUNS_BY_TITLE = {
    "Random i.i.d. (separable)": 48,
    "Massart noise 10%": 48,
    "Label flips": 1,
    "Switching leaders": 1,
}

REPLICATES_BY_TITLE = {
    "Random i.i.d. (separable)": 16,
    "Massart noise 10%": 20,
    "Label flips": 1,
    "Switching leaders": 1,
}


# ------------------------------------------------------------------
# Batched instance builders for the g(T) estimator and device sweeps
# ------------------------------------------------------------------

def sample_g_instance(base_seed: int, T: int, run: int, *, d: int = 5,
                      dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """One worst-case-estimation instance for g(T).

    Mirrors fast_algorithms.py:230-239 (f64 path: no f32 round-trip) when
    ``dtype=float64`` and algorithms.py:155-163 (f32 path) when
    ``dtype=float32`` — same generator, different cast points.
    """
    gen = rng_stream(base_seed, T, run)
    z = gen.standard_normal((T, d)).astype(dtype, copy=False)
    norms = np.linalg.norm(z, axis=1, keepdims=True).astype(dtype, copy=False)
    z *= 1.0 / np.maximum(norms, 1.0)
    y = gen.choice([-1.0, 1.0], size=T).astype(dtype, copy=False)
    return z, y


def sample_g_batch(base_seed: int, T: int, runs: int, *, d: int = 5,
                   dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """Stack ``runs`` g(T) instances into ``(runs, T, d)`` / ``(runs, T)``."""
    zs = np.empty((runs, T, d), dtype=dtype)
    ys = np.empty((runs, T), dtype=dtype)
    for r in range(runs):
        zs[r], ys[r] = sample_g_instance(base_seed, T, r, d=d, dtype=dtype)
    return zs, ys


def stack_replicates(sampler: SamplerFn, T: int, replicates: int,
                     *, dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """Stack a stream's replicates into ``(replicates, T, d)`` arrays.

    Upcasts to ``dtype`` *after* generation, matching the fast driver's
    f32-generate / f64-simulate convention (fast_algorithms.py:175-177).
    """
    samples = [sampler(T, rep=rep) for rep in range(replicates)]
    zs = np.stack([s[0] for s in samples]).astype(dtype, copy=False)
    ys = np.stack([s[1] for s in samples]).astype(dtype, copy=False)
    return zs, ys
