"""Regret kernel (Pallas through Triton): layout round-trip, interpret-mode
agreement with the XLA scan, lowering for CUDA, and GPU runs (``gpu``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.ops.pallas_game import (
    BLOCK,
    pack_per_seq,
    pack_sequences,
    regrets_fused,
    simulate_linear_auto,
    unpack_result,
)


def _batch(B=BLOCK, T=64, seed=0, d=5):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0).astype(np.float32)
    return z, y


def _scan(z, y, alg_flag, eta):
    return np.asarray(simulate_linear_batch(
        jnp.asarray(z), jnp.asarray(y), alg_flag, jnp.asarray(eta)).regret,
        np.float32)


def _kernel(z, y, eta, alg_flag=0, dtype=jnp.float32, **kw):
    zp, yp, B = pack_sequences(jnp.asarray(z), jnp.asarray(y), dtype)
    eta = jnp.asarray(eta, jnp.float32)
    if eta.ndim == 1:
        eta = pack_per_seq(eta)
    return np.asarray(unpack_result(
        regrets_fused(zp, yp, eta, alg_flag=alg_flag, interpret=True, **kw),
        B))


def test_pack_unpack_roundtrip():
    z, y = _batch(B=100, T=16)
    z_pack, y_pack, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    assert z_pack.shape == (16, 5, BLOCK) and y_pack.shape == (16, BLOCK)
    assert B == 100
    zp = np.asarray(z_pack)
    for b in (0, 57, 99):
        np.testing.assert_array_equal(zp[:, :, b], z[b])
        np.testing.assert_array_equal(np.asarray(y_pack)[:, b], y[b])
    # Padding sequences are zero (inert in the game).
    np.testing.assert_array_equal(zp[:, :, 100:], 0.0)
    rec = unpack_result(jnp.arange(BLOCK, dtype=jnp.float32), 100)
    np.testing.assert_array_equal(np.asarray(rec), np.arange(100))


def test_ftrl_round_constants_values():
    """In-kernel round constants: scaleh = -eta/(2 sqrt(t)), s2 =
    eta^2/(4 t) at the global round t0 + t + 1."""
    from online_convex_optimization.ops.pallas_game import _ftrl_consts
    eta = jnp.asarray([2.0], jnp.float32)
    for t0, t in ((0.0, 0), (0.0, 3), (10.0, 5)):
        sh, s2 = _ftrl_consts(jnp.float32(t0), jnp.int32(t), eta, eta * eta)
        tg = t0 + t + 1
        np.testing.assert_allclose(np.asarray(sh), [-1.0 / np.sqrt(tg)],
                                   rtol=1e-6)
        np.testing.assert_allclose(np.asarray(s2), [1.0 / tg], rtol=1e-6)


def test_v2_lane_fallback_nb5():
    """Batches whose padded size is not a multiple of the preferred block
    run with the largest power-of-two block dividing it."""
    from online_convex_optimization.ops.pallas_game import pick_block
    assert pick_block(5 * 128, 512) == 128
    assert pick_block(3 * 256, 256) == 128     # too few programs for 256
    assert pick_block(512 * 300, 512) == 512   # enough programs
    assert pick_block(256 * 300, 512) == 256
    z, y = _batch(B=5 * 128, T=16, seed=9)
    got = _kernel(z, y, 1.0, block=512)
    np.testing.assert_allclose(got, _scan(z, y, 0, 1.0), atol=5e-4)


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_v2_interpret_matches_scan(alg_flag):
    z, y = _batch(B=BLOCK, T=32)
    got = np.asarray(simulate_linear_auto(z, y, alg_flag, 1.3,
                                          interpret=True))
    np.testing.assert_allclose(got, _scan(z, y, alg_flag, 1.3), atol=5e-4)


def test_v2_zero_padded_tail_is_inert():
    """Heterogeneous horizons via zero rows: padded steps add no loss."""
    z, y = _batch(B=BLOCK, T=48)
    z_cut, y_cut = z.copy(), y.copy()
    z_cut[:, 32:] = 0.0
    y_cut[:, 32:] = 0.0
    got = _kernel(z_cut, y_cut, 1.0)
    want = _kernel(z[:, :32], y[:, :32], 1.0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_eta_sweep_kernel_interpret_matches_scan_sweep():
    from online_convex_optimization.models.sweep_api import ftrl_eta_sweep
    from online_convex_optimization.ops.pallas_game import eta_sweep_packed

    z, y = _batch(B=BLOCK, T=32, seed=4)
    grid = np.linspace(0.2, 2.5, 3).astype(np.float32)
    z_pack, y_pack, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    out = np.asarray(eta_sweep_packed(z_pack, y_pack, jnp.asarray(grid),
                                      interpret=True))
    assert out.shape == (3, BLOCK)
    want = np.asarray(ftrl_eta_sweep(z, y, grid, use_kernel=False))
    np.testing.assert_allclose(out[:, :B].T, want, atol=5e-4)


def test_v2_bf16_pack_roundtrip():
    z, y = _batch(B=100, T=16)
    z_pack, y_pack, B = pack_sequences(jnp.asarray(z), jnp.asarray(y),
                                       jnp.bfloat16)
    assert z_pack.shape == (16, 5, BLOCK) and z_pack.dtype == jnp.bfloat16
    zp = np.asarray(z_pack.astype(jnp.float32))
    for b in (0, 57, 99):
        np.testing.assert_array_equal(
            zp[:, :, b], z[b].astype(jnp.bfloat16).astype(np.float32))


def test_v2_bf16_interpret_matches_scan():
    """bf16-stored game == f32 scan run on the SAME bf16-rounded inputs."""
    z, y = _batch(B=BLOCK, T=32, seed=2)
    got = _kernel(z, y, 1.3, dtype=jnp.bfloat16)
    z_rounded = np.asarray(jnp.asarray(z).astype(jnp.bfloat16)
                           .astype(jnp.float32))
    np.testing.assert_allclose(got, _scan(z_rounded, y, 0, 1.3), atol=5e-4)


def test_v2_per_lane_eta_interpret_matches_scan():
    """Every sequence gets its own eta -> matches the scan's (B,) eta0."""
    z, y = _batch(B=BLOCK, T=32, seed=7)
    etas = np.linspace(0.2, 3.0, BLOCK).astype(np.float32)
    got = np.asarray(simulate_linear_auto(z, y, 0, etas, interpret=True))
    np.testing.assert_allclose(got, _scan(z, y, 0, etas), atol=5e-4)


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_regrets_fused_interpret_matches_scan(alg_flag):
    z, y = _batch(B=BLOCK, T=32, seed=11)
    got = _kernel(z, y, 1.3, alg_flag=alg_flag)
    np.testing.assert_allclose(got, _scan(z, y, alg_flag, 1.3), atol=5e-4)


def test_regrets_fused_per_lane_eta_interpret():
    z, y = _batch(B=BLOCK, T=32, seed=12)
    etas = np.linspace(0.2, 3.0, BLOCK).astype(np.float32)
    got = _kernel(z, y, etas)
    np.testing.assert_allclose(got, _scan(z, y, 0, etas), atol=5e-4)


def test_regrets_fused_bf16_interpret():
    z, y = _batch(B=BLOCK, T=32, seed=13)
    got = _kernel(z, y, 1.3, dtype=jnp.bfloat16)
    z_rounded = np.asarray(jnp.asarray(z).astype(jnp.bfloat16)
                           .astype(jnp.float32))
    np.testing.assert_allclose(got, _scan(z_rounded, y, 0, 1.3), atol=5e-4)


def test_pack_per_seq_inverts_unpack():
    vals = jnp.arange(2 * BLOCK - 7, dtype=jnp.float32)
    packed = pack_per_seq(vals)
    assert packed.shape == (2 * BLOCK,)
    np.testing.assert_array_equal(np.asarray(packed[-7:]), 0.0)
    rec = np.asarray(unpack_result(packed, 2 * BLOCK - 7))
    np.testing.assert_array_equal(rec, np.asarray(vals))


def test_pack_sequences_validate_rejects_contract_violations():
    z, y = _batch(B=BLOCK, T=8)
    pack_sequences(jnp.asarray(z), jnp.asarray(y), validate=True)  # ok
    z_bad = z.copy()
    z_bad[0, 0] *= 3.0  # row outside the unit ball
    with pytest.raises(ValueError, match="unit L2 ball"):
        pack_sequences(jnp.asarray(z_bad), jnp.asarray(y), validate=True)
    y_bad = y.copy()
    y_bad[0, 0] = 0.5
    with pytest.raises(ValueError, match="labels"):
        pack_sequences(jnp.asarray(z), jnp.asarray(y_bad), validate=True)


def test_v2_generalizes_d8_and_odd_T():
    """The kernel is generic in d (register unroll) and T (an unrolled
    loop plus a static remainder)."""
    for d, T, seed in ((8, 32, 21), (5, 97, 22), (2, 64, 23)):
        z, y = _batch(B=BLOCK, T=T, seed=seed, d=d)
        np.testing.assert_allclose(_kernel(z, y, 1.1), _scan(z, y, 0, 1.1),
                                   atol=5e-4, err_msg=f"d={d} T={T}")


@pytest.mark.parametrize("d", [1, 5, 16, 32, 64])
def test_v2_interpret_matches_scan_general_d(d):
    """Values match the scan across the register-state range (d = 1 has
    no feature reduction at all).  Rows are shrunk off the unit sphere:
    at d = 1 clipped rows are exactly +-1, where FTL's prediction ties
    the label and the f32 rounding of a tie decides the subgradient."""
    z, y = _batch(B=64, T=19, seed=3 + d, d=d)
    z *= 0.9
    np.testing.assert_allclose(_kernel(z, y, 1.2, block=64, unroll=1),
                               _scan(z, y, 0, 1.2), atol=2e-4)


@pytest.mark.parametrize("T,unroll", [(13, 4), (16, 16), (7, 8), (33, 1)])
def test_time_loop_unroll_remainder(T, unroll):
    """T needs no relation to the unroll factor (remainder rounds run
    after the unrolled loop)."""
    z, y = _batch(B=64, T=T, seed=40 + T)
    for alg in (0, 1):
        np.testing.assert_allclose(
            _kernel(z, y, 0.9, alg_flag=alg, block=64, unroll=unroll),
            _scan(z, y, alg, 0.9), atol=2e-4)


@pytest.mark.parametrize("B", [1, 63, 130])
def test_padded_sequences_are_sliced_off(B):
    """Batch sizes off the block grid pad with inert sequences that the
    unpack drops."""
    z, y = _batch(B=B, T=21, seed=50 + B)
    np.testing.assert_allclose(_kernel(z, y, 1.4), _scan(z, y, 0, 1.4),
                               atol=2e-4)


def test_auto_dispatch_envelope():
    """simulate_linear_auto routes inside/outside the kernel envelope and
    agrees with the scan either way; off the GPU only an explicit
    interpret=True reaches the kernel."""
    from online_convex_optimization.ops.pallas_game import (
        _D_KERNEL_MAX, kernel_envelope, use_kernels)

    assert kernel_envelope(5) is None
    assert kernel_envelope(_D_KERNEL_MAX) is None
    reason = kernel_envelope(_D_KERNEL_MAX + 1)
    assert reason is not None and "scan" in reason
    assert use_kernels() is False          # the test harness runs on CPU
    for d in (5, _D_KERNEL_MAX + 8):
        z, y = _batch(B=64, T=16, seed=11, d=d)
        got = np.asarray(simulate_linear_auto(z, y, 0, 1.0, interpret=True))
        np.testing.assert_allclose(got, _scan(z, y, 0, 1.0), atol=2e-4)
    # No GPU and no interpret: the scan, in the input's precision.
    z, y = _batch(B=64, T=16, seed=12)
    z64, y64 = jnp.asarray(z, jnp.float64), jnp.asarray(y, jnp.float64)
    got = np.asarray(simulate_linear_auto(z64, y64, 0, 1.0))
    assert got.dtype == np.float64
    np.testing.assert_array_equal(
        got, np.asarray(simulate_linear_batch(z64, y64, 0, 1.0).regret))


def test_int8_label_stream_is_value_exact():
    """y_dtype=int8 packing: labels are {-1, 0, +1}, so the int8 stream
    carries the SAME label values into the step math (the kernel converts
    on read)."""
    z, y = _batch(B=BLOCK, T=32, seed=17)
    y[:, 30:] = 0.0          # include padding labels
    z[:, 30:] = 0.0
    zp, yp, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    zp8, yp8, _ = pack_sequences(jnp.asarray(z), jnp.asarray(y),
                                 y_dtype=jnp.int8)
    assert yp8.dtype == jnp.int8
    np.testing.assert_array_equal(np.asarray(zp), np.asarray(zp8))
    np.testing.assert_array_equal(np.asarray(yp8, np.float32),
                                  np.asarray(yp, np.float32))
    a = np.asarray(regrets_fused(zp, yp, 1.3, interpret=True))
    b = np.asarray(regrets_fused(zp8, yp8, 1.3, interpret=True))
    np.testing.assert_allclose(a, b, atol=2e-6)


def test_stream_chunks_equal_one_shot():
    """Chaining play_packed_stream over chunks (t0 carried) equals one
    advance over the whole horizon, for FTRL and FTL."""
    from online_convex_optimization.ops.pallas_game import (
        play_packed_stream, stream_result, zero_stream_carry)

    z, y = _batch(B=96, T=40, seed=60)
    zp, yp, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    for alg in (0, 1):
        one = stream_result(play_packed_stream(
            zp, yp, 1.2, 0, zero_stream_carry(zp.shape[2], 5),
            alg_flag=alg, interpret=True))[0]
        carry = zero_stream_carry(zp.shape[2], 5)
        for c0, c1 in ((0, 16), (16, 29), (29, 40)):
            carry = play_packed_stream(zp[c0:c1], yp[c0:c1], 1.2, c0, carry,
                                       alg_flag=alg, interpret=True)
        np.testing.assert_allclose(np.asarray(stream_result(carry)[0]),
                                   np.asarray(one), atol=2e-5)
        np.testing.assert_allclose(np.asarray(one)[:B],
                                   _scan(z, y, alg, 1.2), atol=2e-4)


def test_stream_many_equals_chained_stream():
    """play_packed_stream_many (one jitted scan over stacked chunks)
    equals chained single advances."""
    from online_convex_optimization.ops.pallas_game import (
        play_packed_stream, play_packed_stream_many, zero_stream_carry)

    z, y = _batch(B=64, T=24, seed=61)
    zp, yp, _ = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    zs = zp.reshape(3, 8, 5, zp.shape[2])
    ys = yp.reshape(3, 8, yp.shape[1])
    many = play_packed_stream_many(zs, ys, 0.8, 0,
                                   zero_stream_carry(zp.shape[2], 5),
                                   interpret=True)
    carry = zero_stream_carry(zp.shape[2], 5)
    for i in range(3):
        carry = play_packed_stream(zs[i], ys[i], 0.8, 8 * i, carry,
                                   interpret=True)
    for a, b in zip(many, carry):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_eta_sweep_grid_axis_equals_per_sequence_eta():
    """The eta grid axis gives the same regrets as duplicating the
    sequences with one eta each (the per-lane route)."""
    from online_convex_optimization.ops.pallas_game import eta_sweep_packed

    z, y = _batch(B=40, T=20, seed=62)
    grid = jnp.asarray([0.3, 1.0, 2.7], jnp.float32)
    zp, yp, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    out = np.asarray(eta_sweep_packed(zp, yp, grid, interpret=True))
    for e in range(3):
        np.testing.assert_allclose(
            out[e, :B], _kernel(z, y, np.full(B, grid[e], np.float32)),
            atol=1e-6)


@pytest.mark.parametrize("entry", ["regrets", "stream", "sweep"])
def test_kernels_lower_for_cuda(entry):
    """Each entry point lowers for the CUDA platform without a GPU (the
    Triton route; no other backend's primitive may appear)."""
    from online_convex_optimization.ops import pallas_game as pg

    T, d, Bp = 64, 5, 1024
    z = jax.ShapeDtypeStruct((T, d, Bp), jnp.bfloat16)
    y = jax.ShapeDtypeStruct((T, Bp), jnp.int8)
    if entry == "regrets":
        fn = jax.jit(lambda z, y: pg.regrets_fused(z, y, 1.3))
    elif entry == "stream":
        fn = jax.jit(lambda z, y: pg.play_packed_stream(
            z, y, 1.3, 5, pg.zero_stream_carry(Bp, d)))
    else:
        fn = jax.jit(lambda z, y: pg.eta_sweep_packed(
            z, y, jnp.linspace(0.5, 2.0, 4)))
    text = fn.trace(z, y).lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" in text.lower()
    assert "mosaic" not in text.lower()


@pytest.mark.gpu
@pytest.mark.parametrize("alg_flag", [0, 1])
def test_v2_gpu_matches_scan(alg_flag):
    z, y = _batch(B=2 * BLOCK, T=256)
    zp, yp, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    got = np.asarray(unpack_result(
        regrets_fused(zp, yp, 1.25, alg_flag=alg_flag), B))
    np.testing.assert_allclose(got, _scan(z, y, alg_flag, 1.25), atol=2e-3)


@pytest.mark.gpu
def test_v2_gpu_bf16_matches_scan():
    z, y = _batch(B=2 * BLOCK, T=256, seed=5)
    zp, yp, B = pack_sequences(jnp.asarray(z), jnp.asarray(y), jnp.bfloat16,
                               y_dtype=jnp.int8)
    got = np.asarray(unpack_result(regrets_fused(zp, yp, 1.25), B))
    z_rounded = np.asarray(jnp.asarray(z).astype(jnp.bfloat16)
                           .astype(jnp.float32))
    np.testing.assert_allclose(got, _scan(z_rounded, y, 0, 1.25), atol=5e-3)


@pytest.mark.gpu
def test_v2_gpu_per_lane_eta_matches_scan():
    z, y = _batch(B=2 * BLOCK, T=256, seed=6)
    etas = np.linspace(0.2, 3.0, 2 * BLOCK).astype(np.float32)
    zp, yp, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    got = np.asarray(unpack_result(regrets_fused(zp, yp, pack_per_seq(etas)),
                                   B))
    np.testing.assert_allclose(got, _scan(z, y, 0, etas), atol=5e-3)


@pytest.mark.gpu
def test_onchip_value_parity_large_d():
    """The compiled kernel at the widest d it serves (register pressure
    is only visible to the GPU compiler)."""
    from online_convex_optimization.ops.pallas_game import _D_KERNEL_MAX

    z, y = _batch(B=1024, T=64, seed=8, d=_D_KERNEL_MAX)
    zp, yp, B = pack_sequences(jnp.asarray(z), jnp.asarray(y))
    got = np.asarray(unpack_result(regrets_fused(zp, yp, 1.2), B))
    np.testing.assert_allclose(got, _scan(z, y, 0, 1.2), atol=5e-4)


@pytest.mark.gpu
def test_sharded_synthetic_g_on_chip():
    """The g sweep program (BASELINE config 5) with the device generator
    and the compiled kernel on a (1, 1) mesh equals an explicit max over
    the same seed blocks."""
    from online_convex_optimization.parallel.mesh import make_mesh
    from online_convex_optimization.parallel.sweep import (
        device_synthetic_regrets, sharded_synthetic_g)

    etas = [1.0, float(np.sqrt(2.0))]
    g = np.asarray(sharded_synthetic_g(make_mesh(1, 1), T=64, eta_grid=etas,
                                       blocks_per_device=2, block_seqs=1024))
    want = [max(float(np.max(np.asarray(device_synthetic_regrets(
        b << 20, np.float32(eta), T=64, block_seqs=1024))))
        for b in range(2)) for eta in etas]
    np.testing.assert_allclose(g.astype(np.float64), want, rtol=1e-6)
