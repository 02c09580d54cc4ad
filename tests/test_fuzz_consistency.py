"""Randomized cross-path consistency fuzz (seeded, bounded).

Every throughput path must agree with the scan simulators on random
configurations drawn from the supported envelope: batch/horizon/feature
sizes, f32/bf16 storage, scalar and per-lane hyperparameters, padded
tails.  This is the property-test net under the targeted unit tests —
any layout, tiling, or chunking regression that the fixed-shape tests
miss shows up here as a value mismatch.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.models.smart import simulate_smart_batch


def _case(rng, B, T, d):
    z = rng.normal(size=(B, T, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0).astype(np.float32)
    return z, y


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_fused_kernel_vs_scan(seed):
    from online_convex_optimization.ops.pallas_game import (
        pack_per_seq, pack_sequences, regrets_fused, unpack_result)

    rng = np.random.default_rng(100 + seed)
    B = int(rng.choice([64, 200, 1024]))
    T = int(rng.choice([8, 24, 40, 64]))
    d = int(rng.choice([3, 5, 8]))
    alg = int(rng.integers(0, 2))
    dtype = jnp.bfloat16 if rng.random() < 0.5 else jnp.float32
    z, y = _case(rng, B, T, d)
    if dtype == jnp.bfloat16:
        z = np.asarray(jnp.asarray(z).astype(dtype).astype(jnp.float32))

    z_pack, y_pack, _ = pack_sequences(jnp.asarray(z), jnp.asarray(y), dtype)
    if alg == 0 and rng.random() < 0.5:
        etas = rng.uniform(0.2, 3.0, B).astype(np.float32)
        eta_arg = pack_per_seq(jnp.asarray(etas))
        want = simulate_linear_batch(jnp.asarray(z), jnp.asarray(y), 0,
                                     jnp.asarray(etas)).regret
    else:
        eta0 = float(rng.uniform(0.2, 3.0))
        eta_arg = eta0
        want = simulate_linear_batch(jnp.asarray(z), jnp.asarray(y), alg,
                                     eta0).regret
    got = unpack_result(
        regrets_fused(z_pack, y_pack, eta_arg, alg_flag=alg,
                      interpret=True), B)
    # 2e-3: layout/tiling bugs are O(1); near-tie f32 trajectory
    # divergence between op orders legitimately reaches ~1.5e-3.
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-3,
                               err_msg=f"B={B} T={T} d={d} alg={alg} "
                                       f"dtype={dtype}")


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_smart_kernel_vs_scan(seed):
    from online_convex_optimization.ops.pallas_smart import (
        simulate_smart_pallas)

    rng = np.random.default_rng(200 + seed)
    B = int(rng.choice([64, 512]))
    T = int(rng.choice([16, 40, 56]))
    d = int(rng.choice([4, 5, 7]))
    z, y = _case(rng, B, T, d)
    th = rng.uniform(0.6, math.sqrt(2.0 * T) * 1.5, B).astype(np.float32)
    et = rng.uniform(0.3, 3.0, B).astype(np.float32)
    got_r, got_t = simulate_smart_pallas(z, y, th, et, interpret=True)
    want = simulate_smart_batch(jnp.asarray(z), jnp.asarray(y),
                                jnp.asarray(th), jnp.asarray(et))
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want.regret),
                               atol=2e-3,
                               err_msg=f"B={B} T={T} d={d}")
    np.testing.assert_array_equal(np.asarray(got_t),
                                  np.asarray(want.switch_t))


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_streaming_vs_oneshot(seed):
    from online_convex_optimization.models.streaming import (
        StreamingKernelGame)

    rng = np.random.default_rng(300 + seed)
    B = int(rng.choice([64, 256]))
    d = int(rng.choice([3, 5, 8]))
    n_chunks = int(rng.integers(2, 5))
    lens = rng.integers(5, 40, n_chunks)
    T = int(lens.sum())
    z, y = _case(rng, B, T, d)
    game = StreamingKernelGame(B, d, eta0=float(rng.uniform(0.3, 2.5)),
                               interpret=True)
    ztm, ytm = z.transpose(1, 0, 2), y.T
    off = 0
    for ln in lens:
        game.feed(ztm[off:off + ln], ytm[off:off + ln])
        off += int(ln)
    want = simulate_linear_batch(jnp.asarray(z), jnp.asarray(y), 0,
                                 game.eta0)
    np.testing.assert_allclose(np.asarray(game.result().regret),
                               np.asarray(want.regret), atol=2e-3,
                               err_msg=f"B={B} d={d} lens={lens}")


@pytest.mark.parametrize("seed", range(2))
def test_fuzz_padded_tails_inert_everywhere(seed):
    """Random tail padding must be inert in the fused kernel AND the
    SMART kernel (zero rows are loss/gradient/statistics-neutral)."""
    from online_convex_optimization.ops.pallas_game import (
        pack_sequences, regrets_fused, unpack_result)

    rng = np.random.default_rng(400 + seed)
    B, d = 64, 5
    T_true = int(rng.integers(10, 30))
    T_pad = T_true + int(rng.integers(2, 34))
    z, y = _case(rng, B, T_pad, d)
    z[:, T_true:] = 0.0
    y[:, T_true:] = 0.0
    zp, yp, _ = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    zc, yc, _ = pack_sequences(jnp.asarray(z[:, :T_true]),
                               jnp.asarray(y[:, :T_true]))
    got = unpack_result(regrets_fused(zp, yp, 1.1, interpret=True), B)
    want = unpack_result(regrets_fused(zc, yc, 1.1, interpret=True), B)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=2e-5,
                               err_msg=f"T_true={T_true} T_pad={T_pad}")
