"""SMART kernel (Pallas through Triton) vs the scan decomposition.

The kernel must reproduce models/smart.py::simulate_smart_batch — which is
itself golden-parity-tested — including the switch round exactly.
Thresholds avoid the ulp-degenerate 0.5 (see tests/test_parity_smart.py).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from online_convex_optimization.models.smart import simulate_smart_batch
from online_convex_optimization.ops.pallas_game import BLOCK as SEQ_TILE
from online_convex_optimization.ops.pallas_smart import simulate_smart_pallas


def _batch(B, T, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, 5)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0).astype(np.float32)
    return z, y


@pytest.mark.parametrize("thresh", [0.75, 2.0, 1e9])
def test_smart_kernel_interpret_matches_scan(thresh):
    z, y = _batch(B=SEQ_TILE, T=48, seed=1)
    got_r, got_t = simulate_smart_pallas(z, y, thresh, math.sqrt(2.0),
                                         interpret=True)
    want = simulate_smart_batch(jnp.asarray(z), jnp.asarray(y),
                                jnp.full((SEQ_TILE,), thresh, jnp.float32),
                                jnp.full((SEQ_TILE,), math.sqrt(2.0),
                                         jnp.float32))
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want.regret),
                               atol=5e-4)
    np.testing.assert_array_equal(np.asarray(got_t),
                                  np.asarray(want.switch_t))


def test_smart_kernel_threshold_eta_grid_interpret():
    """(threshold, eta) hyperparameter grid folded into the lane axis."""
    z, y = _batch(B=SEQ_TILE, T=40, seed=2)
    rng = np.random.default_rng(3)
    th = rng.uniform(0.6, 12.0, SEQ_TILE).astype(np.float32)
    et = rng.uniform(0.3, 3.0, SEQ_TILE).astype(np.float32)
    got_r, got_t = simulate_smart_pallas(z, y, th, et, interpret=True)
    want = simulate_smart_batch(jnp.asarray(z), jnp.asarray(y),
                                jnp.asarray(th), jnp.asarray(et))
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want.regret),
                               atol=5e-4)
    np.testing.assert_array_equal(np.asarray(got_t),
                                  np.asarray(want.switch_t))


def test_smart_kernel_padded_tail_inert():
    z, y = _batch(B=SEQ_TILE, T=64, seed=4)
    z_cut, y_cut = z.copy(), y.copy()
    z_cut[:, 40:] = 0.0
    y_cut[:, 40:] = 0.0
    got_r, got_t = simulate_smart_pallas(z_cut, y_cut, 2.0, 1.2,
                                         interpret=True)
    want_r, want_t = simulate_smart_pallas(z[:, :40], y[:, :40], 2.0, 1.2,
                                           interpret=True)
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want_r),
                               atol=1e-5)
    # tau == T means "never switched": 64 in the padded run, 40 truncated.
    gt, wt = np.asarray(got_t), np.asarray(want_t)
    np.testing.assert_array_equal(np.where(gt == 64, 40, gt), wt)


def test_smart_kernel_bf16_interpret():
    z, y = _batch(B=SEQ_TILE, T=32, seed=5)
    got_r, _ = simulate_smart_pallas(z, y, 2.0, 1.2, dtype=jnp.bfloat16,
                                     interpret=True)
    z_rounded = jnp.asarray(z).astype(jnp.bfloat16).astype(jnp.float32)
    want = simulate_smart_batch(z_rounded, jnp.asarray(y),
                                jnp.full((SEQ_TILE,), 2.0, jnp.float32),
                                jnp.full((SEQ_TILE,), 1.2, jnp.float32))
    np.testing.assert_allclose(np.asarray(got_r)[:SEQ_TILE],
                               np.asarray(want.regret), atol=5e-4)


@pytest.mark.gpu
def test_smart_kernel_gpu_matches_scan():
    z, y = _batch(B=2 * SEQ_TILE, T=256, seed=6)
    T = 256
    got_r, got_t = simulate_smart_pallas(z, y, math.sqrt(2.0 * T),
                                         math.sqrt(2.0))
    want = simulate_smart_batch(
        jnp.asarray(z), jnp.asarray(y),
        jnp.full((2 * SEQ_TILE,), math.sqrt(2.0 * T), jnp.float32),
        jnp.full((2 * SEQ_TILE,), math.sqrt(2.0), jnp.float32))
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want.regret),
                               atol=5e-3)
    np.testing.assert_array_equal(np.asarray(got_t),
                                  np.asarray(want.switch_t))


def test_smart_kernel_immediate_switch_and_extremes():
    """thresh=0 forces a round-0 switch (FTRL from round 1); extreme eta
    values exercise the projection clip on both sides."""
    z, y = _batch(B=SEQ_TILE, T=40, seed=8)
    for thresh, eta in ((0.0, 1e-3), (0.0, 50.0), (1e9, 1e-3)):
        got_r, got_t = simulate_smart_pallas(z, y, thresh, eta,
                                             interpret=True)
        want = simulate_smart_batch(
            jnp.asarray(z), jnp.asarray(y),
            jnp.full((SEQ_TILE,), thresh, jnp.float32),
            jnp.full((SEQ_TILE,), eta, jnp.float32))
        np.testing.assert_allclose(np.asarray(got_r),
                                   np.asarray(want.regret), atol=5e-4,
                                   err_msg=f"thresh={thresh} eta={eta}")
        np.testing.assert_array_equal(np.asarray(got_t),
                                      np.asarray(want.switch_t))


def test_smart_sweep_kernel_interpret_matches_per_lane():
    """Threshold grid as a kernel grid dimension == the per-lane kernel on
    the cross product (no data duplication in the sweep kernel)."""
    from online_convex_optimization.ops.pallas_game import (
        pack_per_seq, pack_sequences, unpack_result)
    from online_convex_optimization.ops.pallas_smart import (
        smart_regrets_packed, smart_sweep_packed)

    z, y = _batch(B=SEQ_TILE, T=40, seed=9)
    grid = np.asarray([0.75, 2.0, 6.0, 1e9], np.float32)
    eta0 = 1.2
    z_pack, y_pack, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    reg, tau = smart_sweep_packed(z_pack, y_pack, jnp.asarray(grid), eta0,
                                  interpret=True)
    for gi, th in enumerate(grid):
        want_r, want_t = smart_regrets_packed(
            z_pack, y_pack,
            pack_per_seq(jnp.full((B,), th)),
            pack_per_seq(jnp.full((B,), eta0)), interpret=True)
        np.testing.assert_allclose(np.asarray(reg[gi]), np.asarray(want_r),
                                   atol=1e-5, err_msg=f"grid[{gi}]")
        np.testing.assert_array_equal(np.asarray(tau[gi]),
                                      np.asarray(want_t))


def test_smart_threshold_sweep_api_kernel_matches_scan():
    """Public sweep API: kernel path == scan path on the same grid."""
    from online_convex_optimization.models.sweep_api import (
        smart_threshold_sweep)

    z, y = _batch(B=SEQ_TILE, T=32, seed=10)
    grid = np.asarray([0.6, 3.0, 50.0], np.float32)
    got = np.asarray(smart_threshold_sweep(z, y, grid, eta0=1.1,
                                           use_kernel=True, interpret=True))
    want = np.asarray(smart_threshold_sweep(z, y, grid, eta0=1.1,
                                            use_kernel=False))
    assert got.shape == want.shape == (SEQ_TILE, 3)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_smart_sweep_kernel_d8_interpret():
    """Sweep kernel generality at d=8 vs the scan on every grid point."""
    from online_convex_optimization.models.sweep_api import (
        smart_threshold_sweep)
    rng = np.random.default_rng(12)
    B, T, d = SEQ_TILE, 32, 8
    z = rng.normal(size=(B, T, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0).astype(np.float32)
    grid = np.asarray([0.8, 4.0], np.float32)
    got = np.asarray(smart_threshold_sweep(z, y, grid, eta0=1.0,
                                           use_kernel=True, interpret=True))
    want = np.asarray(smart_threshold_sweep(z, y, grid, eta0=1.0,
                                            use_kernel=False))
    np.testing.assert_allclose(got, want, atol=5e-4)


@pytest.mark.parametrize("d,T", [(1, 23), (16, 17), (5, 37)])
def test_smart_kernel_general_d_odd_T(d, T):
    """d-generic state and horizons off the unroll grid; switch rounds
    match exactly.  Rows are shrunk off the unit sphere so d = 1 has no
    exact prediction ties (see test_pallas_game_v2)."""
    rng = np.random.default_rng(70 + d)
    B = 64
    z = rng.normal(size=(B, T, d)).astype(np.float32)
    z *= 0.9 / np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0).astype(np.float32)
    th = np.linspace(0.6, 5.0, B).astype(np.float32)
    got_r, got_t = simulate_smart_pallas(z, y, th, 1.3, interpret=True)
    want = simulate_smart_batch(jnp.asarray(z), jnp.asarray(y),
                                jnp.asarray(th), jnp.float32(1.3))
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want.regret),
                               atol=5e-4)
    np.testing.assert_array_equal(np.asarray(got_t),
                                  np.asarray(want.switch_t))


@pytest.mark.parametrize("entry", ["per_sequence", "sweep"])
def test_smart_kernels_lower_for_cuda(entry):
    """Both SMART entry points lower for CUDA through Triton."""
    from online_convex_optimization.ops.pallas_smart import (
        smart_regrets_packed, smart_sweep_packed)

    z = jax.ShapeDtypeStruct((64, 5, 1024), jnp.bfloat16)
    y = jax.ShapeDtypeStruct((64, 1024), jnp.int8)
    if entry == "per_sequence":
        fn = jax.jit(lambda z, y: smart_regrets_packed(z, y, 2.0, 1.3))
    else:
        fn = jax.jit(lambda z, y: smart_sweep_packed(
            z, y, jnp.linspace(0.5, 8.0, 4), 1.3))
    text = fn.trace(z, y).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower() and "mosaic" not in text.lower()
