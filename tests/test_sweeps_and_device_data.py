"""Sweep front-ends, on-device data generation, and safety utilities."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from online_convex_optimization.data.device import (
    random_game_batch,
    random_packed_batch,
    separable_stream_batch,
    shard_keys,
)
from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.models.sweep_api import (
    ftrl_eta_sweep,
    smart_threshold_sweep,
)
from online_convex_optimization.testing.golden import (
    golden_simulate_alg,
    golden_simulate_smart,
)
from online_convex_optimization.utils.debug import (
    drop_nonfinite_stats,
    finite_or_sentinel,
)


def _batch(B=4, T=80, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, 5))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    return z, y


def test_eta_sweep_matches_golden():
    z, y = _batch()
    grid = np.array([0.25, 1.0, math.sqrt(2.0), 4.0])
    out = np.asarray(ftrl_eta_sweep(z, y, grid))
    assert out.shape == (4, 4)
    for b in (0, 3):
        for e, eta in enumerate(grid):
            want = golden_simulate_alg(z[b], y[b], 0, float(eta))
            assert out[b, e] == pytest.approx(want, abs=1e-9)


def test_eta_sweep_64_settings_one_program():
    """BASELINE config 2: a 64-point learning-rate sweep via one call."""
    z, y = _batch(B=2)
    grid = np.linspace(0.05, 4.0, 64)
    out = np.asarray(ftrl_eta_sweep(z, y, grid))
    assert out.shape == (2, 64)
    assert np.all(np.isfinite(out))


def test_threshold_sweep_matches_golden():
    z, y = _batch(seed=3)
    grid = np.array([0.8, 2.0, 8.0])
    out = np.asarray(smart_threshold_sweep(z, y, grid, eta0=math.sqrt(2)))
    for b in (1, 2):
        for g, th in enumerate(grid):
            want = golden_simulate_smart(z[b], y[b], float(th), math.sqrt(2))
            assert out[b, g] == pytest.approx(want, abs=1e-9)


def test_device_game_batch_distribution():
    key = jax.random.key(0)
    z, y = random_game_batch(key, B=64, T=200)
    norms = np.linalg.norm(np.asarray(z), axis=-1)
    assert np.all(norms <= 1.0 + 1e-5)
    assert set(np.unique(np.asarray(y))) == {-1.0, 1.0}
    # Feedable straight into the simulator.
    res = simulate_linear_batch(z, y, 0, math.sqrt(2))
    assert np.all(np.isfinite(np.asarray(res.regret)))


def test_device_separable_stream_labels():
    z, y, u = separable_stream_batch(jax.random.key(1), B=8, T=300)
    q = np.einsum("btd,bd->bt", np.asarray(z), np.asarray(u))
    np.testing.assert_array_equal(np.asarray(y), np.where(q >= 0, 1.0, -1.0))
    _, y_noisy, _ = separable_stream_batch(jax.random.key(1), B=8, T=300,
                                           noise_p=0.2)
    rate = np.mean(np.asarray(y_noisy) != np.asarray(y))
    assert 0.1 < rate < 0.3


def test_device_packed_batch_shape():
    z, y = random_packed_batch(jax.random.key(2), T=64, B=256)
    assert z.shape == (64, 5, 256) and y.shape == (64, 256)
    assert float(np.max(np.sum(np.asarray(z) ** 2, axis=1))) <= 1.0
    z8, y8 = random_packed_batch(jax.random.key(2), T=8, B=128,
                                 dtype=jnp.bfloat16, y_dtype=jnp.int8)
    assert z8.dtype == jnp.bfloat16 and y8.dtype == jnp.int8
    assert set(np.unique(np.asarray(y8)).tolist()) <= {-1, 1}
    keys = shard_keys(jax.random.key(3), 4)
    assert keys.shape[0] == 4


def test_failure_containment():
    r = jnp.asarray([1.0, jnp.inf, 2.0, jnp.nan, -3.0])
    s = finite_or_sentinel(r)
    n, mx, mean = drop_nonfinite_stats(s)
    assert int(n) == 3
    assert float(mx) == 2.0
    assert float(mean) == pytest.approx(0.0)


def test_eta_sweep_kernel_route_matches_scan_route():
    """use_kernel=True (interpret) == the scan cross-product, incl. padded
    lengths routed through tail masking."""
    import numpy as np

    from online_convex_optimization.models.sweep_api import ftrl_eta_sweep

    rng = np.random.default_rng(8)
    B, T = 128, 48
    z = rng.normal(size=(B, T, 5)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0).astype(np.float32)
    length = np.where(np.arange(B) % 2 == 0, T, 32)
    grid = np.linspace(0.3, 2.0, 3).astype(np.float32)
    got = np.asarray(ftrl_eta_sweep(z, y, grid, length=length,
                                    use_kernel=True, interpret=True))
    want = np.asarray(ftrl_eta_sweep(z, y, grid, length=length,
                                     use_kernel=False))
    np.testing.assert_allclose(got, want, atol=5e-4)
