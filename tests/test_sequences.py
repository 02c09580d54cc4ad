"""Sequence generation: reference seed schedules, casts, and registries."""

import numpy as np

from online_convex_optimization.data.rng import rng_stream, run_seed_schedule
from online_convex_optimization.data.sequences import (
    CASES,
    REPLICATES_BY_TITLE,
    RUNS_BY_TITLE,
    flip_sequence,
    make_noisy_iid_stream,
    make_random_iid_stream,
    sample_g_batch,
    sample_g_instance,
    stack_replicates,
    switching_two_leaders_sequence,
)


def test_rng_stream_matches_reference_schedule():
    """The stream must be Generator(PCG64(SeedSequence([base, T, run])))
    exactly (algorithms.py:177-180) — byte-for-byte."""
    want = np.random.Generator(
        np.random.PCG64(np.random.SeedSequence([7, 100, 3]))).standard_normal(8)
    got = rng_stream(7, 100, 3).standard_normal(8)
    np.testing.assert_array_equal(want, got)
    assert run_seed_schedule(0, 0) == 2025  # driver.py:88
    assert run_seed_schedule(5, 2) == 5 + 2025 * 3


def test_flip_sequence_semantics():
    z, y, u = flip_sequence(6)
    np.testing.assert_array_equal(y, [1, -1, 1, -1, 1, -1])  # t=1 odd -> +1
    assert z.dtype == np.float32 and np.all(z[:, 0] == 1.0) and np.all(z[:, 1:] == 0.0)
    np.testing.assert_array_equal(u, 0.0)


def test_switching_blocks():
    _, y, _ = switching_two_leaders_sequence(50, block_len=20)
    np.testing.assert_array_equal(y[:20], 1.0)
    np.testing.assert_array_equal(y[20:40], -1.0)
    np.testing.assert_array_equal(y[40:], 1.0)


def test_iid_stream_properties():
    sampler = make_random_iid_stream(d=5, run_seed=11)
    z, y, u = sampler(300, rep=2)
    assert z.dtype == np.float32 and y.dtype == np.float32
    # Rows are clipped, not normalized: norms <= 1, many strictly < 1.
    norms = np.linalg.norm(z, axis=1)
    assert np.all(norms <= 1.0 + 1e-6)
    assert np.any(norms < 0.999)
    # Labels separable by u with ties mapped to +1.
    expect = np.sign(z @ u)
    expect[expect == 0] = 1.0
    np.testing.assert_array_equal(y, expect.astype(np.float32))
    # Determinism: same (T, rep) -> identical bytes.
    z2, y2, _ = make_random_iid_stream(d=5, run_seed=11)(300, rep=2)
    np.testing.assert_array_equal(z, z2)
    np.testing.assert_array_equal(y, y2)


def test_noisy_stream_flip_rate():
    sampler = make_noisy_iid_stream(p=0.10, d=5, run_seed=1)
    z, y, u = sampler(5000, rep=0)
    clean = np.sign(z @ u)
    clean[clean == 0] = 1.0
    rate = np.mean(y != clean.astype(np.float32))
    assert 0.07 < rate < 0.13


def test_g_instance_dtype_paths():
    """f64 path (fast_algorithms.py:234-239) has no f32 round-trip; the
    f32 path (algorithms.py:158-163) does.  They must differ in the tail
    bits but agree to f32 precision."""
    z64, y64 = sample_g_instance(0, 50, 1, dtype=np.float64)
    z32, y32 = sample_g_instance(0, 50, 1, dtype=np.float32)
    assert z64.dtype == np.float64 and z32.dtype == np.float32
    np.testing.assert_allclose(z64, z32, atol=1e-6)
    np.testing.assert_array_equal(np.sign(y64), np.sign(y32))


def test_batch_builders():
    zs, ys = sample_g_batch(0, 40, 3)
    assert zs.shape == (3, 40, 5) and ys.shape == (3, 40)
    z0, y0 = sample_g_instance(0, 40, 0)
    np.testing.assert_array_equal(zs[0], z0)

    sampler = make_random_iid_stream(d=5, run_seed=9)
    zr, yr = stack_replicates(sampler, 30, 4)
    assert zr.shape == (4, 30, 5) and zr.dtype == np.float64
    z_direct, y_direct, _ = sampler(30, rep=1)
    np.testing.assert_array_equal(zr[1], z_direct.astype(np.float64))


def test_registries_match_reference():
    assert set(CASES) == {"Random i.i.d. (separable)", "Massart noise 10%",
                          "Label flips", "Switching leaders"}
    assert RUNS_BY_TITLE["Random i.i.d. (separable)"] == 48
    assert REPLICATES_BY_TITLE["Massart noise 10%"] == 20
    assert RUNS_BY_TITLE["Switching leaders"] == 1
