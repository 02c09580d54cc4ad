"""Multi-device scenario sweeps on the 8-virtual-device CPU mesh.

Validates that shard_map programs (pmax / psum collectives over the
(data, hyper) mesh) reproduce the single-device batched results exactly.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.models.smart import simulate_smart_batch
from online_convex_optimization.parallel.mesh import make_mesh, scenario_sharding
from online_convex_optimization.parallel.sweep import (
    mean_and_ci,
    sharded_max_regret,
    sharded_regret_stats,
    sharded_smart_regrets,
)
from online_convex_optimization.utils.stats import mean_ci


def _batch(B, T=64, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, 5))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    return jnp.asarray(z), jnp.asarray(y)


def test_eight_devices_present():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 2)])
def test_sharded_max_matches_local(shape):
    mesh = make_mesh(*shape)
    B = 16 * shape[0] * shape[1]
    z, y = _batch(B)
    got = float(sharded_max_regret(mesh, z, y, math.sqrt(2)))
    want = float(jnp.max(simulate_linear_batch(z, y, 0, math.sqrt(2)).regret))
    assert got == pytest.approx(want, abs=1e-12)


def test_sharded_stats_match_local():
    mesh = make_mesh(4, 2)
    z, y = _batch(64, seed=1)
    stats = sharded_regret_stats(mesh, z, y, 0, math.sqrt(2))
    mean, ci = mean_and_ci(stats)
    regs = np.asarray(simulate_linear_batch(z, y, 0, math.sqrt(2)).regret)
    want_mean, want_ci = mean_ci(regs)
    assert float(mean) == pytest.approx(want_mean, rel=1e-12)
    assert float(ci) == pytest.approx(want_ci, rel=1e-9)


def test_sharded_smart_grid_matches_local():
    mesh = make_mesh(8, 1)
    B = 32
    z, y = _batch(B, seed=2)
    thresh = jnp.asarray(np.linspace(0.2, 6.0, B))
    got = np.asarray(sharded_smart_regrets(mesh, z, y, thresh, math.sqrt(2)))
    want = np.asarray(
        simulate_smart_batch(z, y, thresh, jnp.full((B,), math.sqrt(2),
                                                    z.dtype)).regret)
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_explicit_device_put_roundtrip():
    """Placing the batch with a scenario sharding and computing with jit
    (GSPMD path, not shard_map) also matches."""
    mesh = make_mesh(4, 2)
    z, y = _batch(32, seed=3)
    sh = scenario_sharding(mesh)
    z_s = jax.device_put(z, sh)
    y_s = jax.device_put(y, sh)
    res = simulate_linear_batch(z_s, y_s, 0, 1.0)
    want = simulate_linear_batch(z, y, 0, 1.0)
    np.testing.assert_allclose(np.asarray(res.regret),
                               np.asarray(want.regret), atol=1e-12)


def test_sharded_pallas_kernel_matches_unsharded():
    """The fused regret kernel composes with the mesh: lane-axis shards on
    8 devices reproduce the single-device kernel result exactly."""
    from online_convex_optimization.ops.pallas_game import (
        pack_per_seq,
        pack_sequences,
        regrets_fused,
        unpack_result,
    )
    from online_convex_optimization.parallel.sweep import (
        sharded_pallas_regrets,
    )

    n = len(jax.devices())
    B, T = 128 * n, 32
    z, y = _batch(B, T=T, seed=5)
    z = z.astype(jnp.float32)
    y = y.astype(jnp.float32)
    z_pack, y_pack, _ = pack_sequences(z, y)
    mesh = make_mesh(n // 2, 2)

    got = sharded_pallas_regrets(mesh, z_pack, y_pack, 1.3, interpret=True)
    want = regrets_fused(z_pack, y_pack, 1.3, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)

    # Per-lane eta grid sharded with the lanes.
    etas = jnp.asarray(np.linspace(0.2, 3.0, B, dtype=np.float32))
    eta_pack = pack_per_seq(etas)
    got_e = sharded_pallas_regrets(mesh, z_pack, y_pack, eta_pack,
                                   interpret=True)
    want_e = regrets_fused(z_pack, y_pack, eta_pack, interpret=True)
    np.testing.assert_allclose(np.asarray(unpack_result(got_e, B)),
                               np.asarray(unpack_result(want_e, B)),
                               atol=1e-5)


def test_sharded_smart_kernel_matches_unsharded():
    """The fused SMART kernel composes with the mesh: per-lane (threshold,
    eta) grids shard with the lanes; regrets and switch rounds match the
    single-device kernel exactly."""
    import math

    from online_convex_optimization.ops.pallas_game import (
        pack_per_seq,
        pack_sequences,
    )
    from online_convex_optimization.ops.pallas_smart import (
        smart_regrets_packed,
    )
    from online_convex_optimization.parallel.sweep import (
        sharded_smart_pallas,
    )

    n = len(jax.devices())
    B, T = 128 * n, 32
    z, y = _batch(B, T=T, seed=9)
    z = z.astype(jnp.float32)
    y = y.astype(jnp.float32)
    z_pack, y_pack, _ = pack_sequences(z, y)
    rng = np.random.default_rng(1)
    th = pack_per_seq(jnp.asarray(
        rng.uniform(0.6, math.sqrt(2 * T), B).astype(np.float32)))
    et = pack_per_seq(jnp.asarray(
        rng.uniform(0.3, 3.0, B).astype(np.float32)))
    mesh = make_mesh(n // 2, 2)

    got_r, got_t = sharded_smart_pallas(mesh, z_pack, y_pack, th, et,
                                        interpret=True)
    want_r, want_t = smart_regrets_packed(z_pack, y_pack, th, et,
                                          interpret=True)
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(want_r),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(got_t), np.asarray(want_t))


def test_sharded_reductions_contain_nonfinite_scenarios():
    """A diverged (NaN) scenario must not poison pmax/psum reductions."""
    B = 16
    z, y = _batch(B, T=32, seed=11)
    z = np.asarray(z).copy()
    z[3] = np.nan                           # one poisoned scenario
    mesh = make_mesh(4, 2)
    g = sharded_max_regret(mesh, jnp.asarray(z), y, 1.2)
    assert np.isfinite(float(g))
    z_clean, _ = _batch(B, T=32, seed=11)
    g_clean_all = np.asarray(
        simulate_linear_batch(jnp.asarray(z_clean), y, 0, 1.2).regret)
    assert float(g) == pytest.approx(
        float(np.max(np.delete(g_clean_all, 3))), abs=1e-9)
    stats = sharded_regret_stats(mesh, jnp.asarray(z), y, 0, 1.2)
    n, s, ss = (float(v) for v in np.asarray(stats))
    assert n == B - 1 and np.isfinite(s) and np.isfinite(ss)


def test_sharded_stream_step_matches_unsharded():
    """Streaming carry chunks under shard_map == the local streaming kernel
    (carry stays device-local; zero collectives on the hot path)."""
    from online_convex_optimization.ops.pallas_game import (
        pack_time_major, play_packed_stream, stream_result,
        zero_stream_carry)
    from online_convex_optimization.parallel.sweep import (
        sharded_stream_step)

    n = len(jax.devices())
    B, T, d = 128 * n, 64, 5        # one kernel block per device
    z, y = _batch(B, T=T, seed=17)
    ztm = np.asarray(z).transpose(1, 0, 2)
    ytm = np.asarray(y).T
    mesh = make_mesh(n, 1)

    carry_sh = zero_stream_carry(B, d)
    carry_lo = zero_stream_carry(B, d)
    for c in range(0, T, 32):
        zc, yc = pack_time_major(ztm[c:c + 32], ytm[c:c + 32])
        carry_sh = sharded_stream_step(mesh, zc, yc, 1.2, c, carry_sh,
                                       interpret=True)
        carry_lo = play_packed_stream(zc, yc, 1.2, c, carry_lo,
                                      interpret=True)
    got = np.asarray(stream_result(carry_sh)[0])
    want = np.asarray(stream_result(carry_lo)[0])
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sharded_quadratic_matches_local():
    """Quadratic track under shard_map (pure elementwise + scan — no
    collectives needed until the reduction)."""
    from online_convex_optimization.models.quadratic import (
        simulate_quadratic_batch)
    from online_convex_optimization.parallel.sweep import (
        sharded_quadratic_regrets)

    n = len(jax.devices())
    B, T, d = 8 * n, 48, 5
    rng = np.random.default_rng(19)
    z = rng.normal(size=(B, T, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = (z @ (np.ones(d) / np.sqrt(d))
         + 0.1 * rng.normal(size=(B, T))).astype(np.float32)
    mesh = make_mesh(n, 1)
    got = np.asarray(sharded_quadratic_regrets(mesh, jnp.asarray(z),
                                               jnp.asarray(y)))
    want = np.asarray(simulate_quadratic_batch(z, y, 1, 1.0).regret)
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------
# Synthetic g sweep (BASELINE config 5): mesh-shape invariance of the
# (data-sharded seeds, hyper-sharded eta grid, pmax) program.  The seed
# and collective logic is checked with a cheap deterministic stand-in;
# test_sharded_synthetic_g_default_regret_fn runs the default device
# generator + kernel (interpreted) on the same meshes.
# ---------------------------------------------------------------------

def _fake_synth_regrets(seed, eta, *, T, block_seqs, alg_flag, interpret):
    key = jax.random.fold_in(jax.random.key(T + 31 * alg_flag),
                             jnp.asarray(seed, jnp.int32) >> 20)
    base = jax.random.uniform(key, (block_seqs,), jnp.float32)
    return base * eta


def test_sharded_synthetic_g_mesh_invariant():
    from online_convex_optimization.parallel.sweep import (
        sharded_synthetic_g)

    etas = jnp.asarray([0.5, 1.0, 1.5, 2.0], jnp.float32)
    g8 = sharded_synthetic_g(make_mesh(4, 2), T=32, eta_grid=etas,
                             blocks_per_device=2, block_seqs=128,
                             regret_fn=_fake_synth_regrets)
    g1 = sharded_synthetic_g(make_mesh(1, 1), T=32, eta_grid=etas,
                             blocks_per_device=8, block_seqs=128,
                             regret_fn=_fake_synth_regrets)
    np.testing.assert_array_equal(np.asarray(g8), np.asarray(g1))
    # Explicit max over the same 8 seed blocks, per eta.
    want = [max(float(jnp.max(_fake_synth_regrets(
        b << 20, float(eta), T=32, block_seqs=128, alg_flag=0,
        interpret=False))) for b in range(8)) for eta in np.asarray(etas)]
    np.testing.assert_allclose(np.asarray(g8, np.float64), want, rtol=1e-6)


def test_sharded_synthetic_g_eta_divisibility():
    from online_convex_optimization.parallel.sweep import (
        sharded_synthetic_g)

    with pytest.raises(ValueError, match="divisible"):
        sharded_synthetic_g(make_mesh(4, 2), T=16, eta_grid=[1.0, 2.0, 3.0],
                            blocks_per_device=1, block_seqs=128,
                            regret_fn=_fake_synth_regrets)


def test_sharded_synthetic_g_seed_block_guard():
    """int32 seed space holds 4096 disjoint 2^20-strided blocks; beyond
    that the sweep must refuse rather than silently duplicate data."""
    from online_convex_optimization.parallel.sweep import (
        sharded_synthetic_g)

    with pytest.raises(ValueError, match="seed blocks"):
        sharded_synthetic_g(make_mesh(4, 2), T=16, eta_grid=[1.0, 2.0],
                            blocks_per_device=1025, block_seqs=128,
                            regret_fn=_fake_synth_regrets)


def test_three_axis_mesh_matches_local_and_two_axis():
    """make_mesh3 (host, data, hyper) runs the SAME axis-agnostic sweep
    programs (r5): max/stats over a 3-axis mesh equal the local batched
    results and the 2-axis mesh's answers exactly (pmax) / to fp
    tolerance (psum order)."""
    from online_convex_optimization.parallel.mesh import make_mesh3

    z, y = _batch(16, T=48, seed=13)
    mesh3 = make_mesh3(2, 2, 2)
    mesh2 = make_mesh(4, 2)

    g3 = float(sharded_max_regret(mesh3, z, y, 1.3))
    g2 = float(sharded_max_regret(mesh2, z, y, 1.3))
    g_loc = float(jnp.max(simulate_linear_batch(z, y, 0, 1.3).regret))
    assert g3 == g2 == g_loc

    s3 = sharded_regret_stats(mesh3, z, y, 0, 1.3)
    m3, ci3 = mean_and_ci(s3)
    r_loc = np.asarray(simulate_linear_batch(z, y, 0, 1.3).regret)
    m_loc, ci_loc = mean_ci(r_loc)
    np.testing.assert_allclose(float(m3), m_loc, rtol=1e-12)
    np.testing.assert_allclose(float(ci3), ci_loc, rtol=1e-9)

    th = jnp.full((16,), 3.0, z.dtype)
    sm3 = np.asarray(sharded_smart_regrets(mesh3, z, y, th, 1.3))
    sm_loc = np.asarray(simulate_smart_batch(z, y, th, 1.3, None).regret)
    np.testing.assert_allclose(sm3, sm_loc, rtol=1e-12)


def test_synthetic_g_three_axis_disjoint_blocks():
    """On a (host, data, hyper) mesh every non-hyper shard owns DISJOINT
    seed blocks (r5 review: the DATA_AXIS-only version duplicated host
    rows' data and never reduced over the host axis): the 3-axis answer
    equals the 2-axis mesh with the same flattened non-hyper size."""
    from online_convex_optimization.parallel.mesh import make_mesh3
    from online_convex_optimization.parallel.sweep import (
        sharded_synthetic_g)

    etas = [0.5, 1.5]
    g3 = np.asarray(sharded_synthetic_g(
        make_mesh3(2, 2, 2), T=32, eta_grid=etas, blocks_per_device=2,
        block_seqs=128, regret_fn=_fake_synth_regrets))
    g2 = np.asarray(sharded_synthetic_g(
        make_mesh(4, 2), T=32, eta_grid=etas, blocks_per_device=2,
        block_seqs=128, regret_fn=_fake_synth_regrets))
    np.testing.assert_array_equal(g3, g2)
    # And the explicit 8-block max per eta (4 non-hyper shards x 2).
    want = [max(float(jnp.max(_fake_synth_regrets(
        b << 20, float(e), T=32, block_seqs=128, alg_flag=0,
        interpret=False))) for b in range(8)) for e in etas]
    np.testing.assert_allclose(g3.astype(np.float64), want, rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_sharded_synthetic_g_default_regret_fn(shape):
    """The default regret_fn (jax.random generation keyed by seed-block
    ids + the regret kernel, interpreted here) on a virtual mesh equals a
    (1, 1) mesh with the same total seed blocks, and an explicit max over
    those blocks."""
    from online_convex_optimization.parallel.sweep import (
        device_synthetic_regrets, sharded_synthetic_g)

    etas = [0.7, 1.4]
    devs = jax.devices()[:shape[0] * shape[1]]
    from jax.sharding import Mesh
    mesh = Mesh(np.asarray(devs).reshape(shape), ("data", "hyper"))
    g = np.asarray(sharded_synthetic_g(mesh, T=12, eta_grid=etas,
                                       blocks_per_device=1, block_seqs=64,
                                       interpret=True))
    g1 = np.asarray(sharded_synthetic_g(make_mesh(1, 1), T=12,
                                        eta_grid=etas,
                                        blocks_per_device=shape[0],
                                        block_seqs=64, interpret=True))
    np.testing.assert_array_equal(g, g1)
    want = [max(float(np.max(np.asarray(device_synthetic_regrets(
        b << 20, np.float32(e), T=12, block_seqs=64, interpret=True))))
        for b in range(shape[0])) for e in etas]
    np.testing.assert_allclose(g.astype(np.float64), want, rtol=1e-6)
    # Disjoint seed blocks really are different sequences.
    r0 = np.asarray(device_synthetic_regrets(0, np.float32(1.0), T=12,
                                             block_seqs=64, interpret=True))
    r1 = np.asarray(device_synthetic_regrets(1 << 20, np.float32(1.0), T=12,
                                             block_seqs=64, interpret=True))
    assert not np.array_equal(r0, r1)
