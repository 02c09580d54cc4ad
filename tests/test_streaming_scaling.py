"""Streaming chunked game == one-shot scan; scaling harness runs on the
virtual mesh."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.models.streaming import StreamingGame
from online_convex_optimization.parallel.scaling import measure_scaling


def _batch(B=3, T=120, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, 5))
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0)
    return z, y


def _chunks(z, y, ct):
    # time-major chunk feed
    z_tm = np.swapaxes(z, 0, 1)
    y_tm = np.swapaxes(y, 0, 1)
    for s in range(0, z_tm.shape[0], ct):
        yield z_tm[s:s + ct], y_tm[s:s + ct]


@pytest.mark.parametrize("alg_flag", [0, 1])
@pytest.mark.parametrize("ct", [30, 120])
def test_streaming_matches_oneshot(alg_flag, ct):
    z, y = _batch()
    game = StreamingGame(B=3, d=5, alg_flag=alg_flag, eta0=math.sqrt(2),
                         dtype=jnp.float64)
    for zc, yc in _chunks(z, y, ct):
        game.feed(zc, yc)
    res = game.result(_chunks(z, y, ct))
    want = simulate_linear_batch(z, y, alg_flag, math.sqrt(2))
    np.testing.assert_allclose(np.asarray(res.regret),
                               np.asarray(want.regret), atol=1e-9)


def test_streaming_checkpoint_resume():
    z, y = _batch(seed=5)
    # Run halfway, checkpoint, resume in a NEW game, finish.
    g1 = StreamingGame(B=3, d=5, alg_flag=0, eta0=1.0, dtype=jnp.float64)
    feed = list(_chunks(z, y, 40))
    g1.feed(*feed[0])
    saved = g1.carry_state()

    g2 = StreamingGame(B=3, d=5, alg_flag=0, eta0=1.0, dtype=jnp.float64)
    g2.resume(saved)
    for zc, yc in feed[1:]:
        g2.feed(zc, yc)
    res = g2.result(iter(feed))
    want = simulate_linear_batch(z, y, 0, 1.0)
    np.testing.assert_allclose(np.asarray(res.regret),
                               np.asarray(want.regret), atol=1e-9)


def test_streaming_resume_equals_uninterrupted_T1e5(tmp_path):
    """VERDICT round-1 item 8: a T >= 1e5 run checkpointed mid-stream via
    utils/checkpointing and resumed in a fresh process-equivalent game
    matches the uninterrupted run exactly."""
    from online_convex_optimization.utils.checkpointing import (
        load_pytree,
        save_pytree,
    )

    B, d, CT, n_chunks = 4, 5, 4096, 25               # T = 102,400
    rng = np.random.default_rng(42)

    def chunk(i):
        r = np.random.default_rng(1000 + i)
        z = r.normal(size=(CT, B, d)).astype(np.float32)
        z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
        y = np.where(r.random((CT, B)) < 0.5, -1.0, 1.0).astype(np.float32)
        return z, y

    solid = StreamingGame(B=B, d=d, alg_flag=0, eta0=math.sqrt(2))
    for i in range(n_chunks):
        solid.feed(*chunk(i))

    g1 = StreamingGame(B=B, d=d, alg_flag=0, eta0=math.sqrt(2))
    for i in range(n_chunks // 2):
        g1.feed(*chunk(i))
    save_pytree(str(tmp_path / "carry.npz"), g1.carry_state())

    g2 = StreamingGame(B=B, d=d, alg_flag=0, eta0=math.sqrt(2))
    g2.resume(load_pytree(str(tmp_path / "carry.npz"), g2.carry_state()))
    for i in range(n_chunks // 2, n_chunks):
        g2.feed(*chunk(i))

    np.testing.assert_array_equal(np.asarray(g2.state.cum_loss),
                                  np.asarray(solid.state.cum_loss))
    np.testing.assert_array_equal(np.asarray(g2.state.theta),
                                  np.asarray(solid.state.theta))
    assert float(g2.state.t) == float(solid.state.t) == CT * n_chunks + 1
    del rng


def test_scaling_harness_virtual_mesh():
    points = measure_scaling([1, 2, 4], B_per_dev=64, T=64, reps=1)
    assert [p.n_devices for p in points] == [1, 2, 4]
    assert all(p.steps_per_s > 0 for p in points)
    assert points[0].efficiency == 1.0


def _contract_batch(B, T, d=5, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(B, T, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0).astype(np.float32)
    return z, y


@pytest.mark.parametrize("alg_flag", [0, 1])
def test_streaming_kernel_matches_scan(alg_flag):
    """Kernel streaming (carry-in/carry-out Pallas chunks, replay-free
    identity comparator) == batched scan regrets."""
    from online_convex_optimization.models.streaming import (
        StreamingKernelGame)
    B, T, d = 64, 96, 5
    z, y = _contract_batch(B, T, d, seed=21)
    game = StreamingKernelGame(B, d, alg_flag=alg_flag, eta0=1.3,
                               interpret=True)
    ztm, ytm = z.transpose(1, 0, 2), y.T
    for c in range(0, T, 32):
        game.feed(ztm[c:c + 32], ytm[c:c + 32])
    got = game.result()
    want = simulate_linear_batch(jnp.asarray(z), jnp.asarray(y), alg_flag,
                                 1.3)
    np.testing.assert_allclose(np.asarray(got.regret),
                               np.asarray(want.regret), atol=5e-4)
    np.testing.assert_allclose(np.asarray(got.cum_loss),
                               np.asarray(want.cum_loss), atol=5e-4)


def test_streaming_kernel_checkpoint_resume():
    """Serialize the O(B d) carry mid-stream; resumed == uninterrupted."""
    from online_convex_optimization.models.streaming import (
        StreamingKernelGame)
    B, T, d = 64, 128, 5
    z, y = _contract_batch(B, T, d, seed=22)
    ztm, ytm = z.transpose(1, 0, 2), y.T

    full = StreamingKernelGame(B, d, eta0=0.9, interpret=True)
    for c in range(0, T, 32):
        full.feed(ztm[c:c + 32], ytm[c:c + 32])

    first = StreamingKernelGame(B, d, eta0=0.9, interpret=True)
    for c in range(0, 64, 32):
        first.feed(ztm[c:c + 32], ytm[c:c + 32])
    saved = first.carry_state()

    second = StreamingKernelGame(B, d, eta0=0.9, interpret=True)
    second.resume({k: np.array(v) for k, v in saved.items()})
    for c in range(64, T, 32):
        second.feed(ztm[c:c + 32], ytm[c:c + 32])

    np.testing.assert_array_equal(np.asarray(second.result().regret),
                                  np.asarray(full.result().regret))


def test_streaming_kernel_result_x_last_and_validation():
    """result().x_last is the final FTL comparator action (scan-path
    semantics); validate=True rejects contract-violating chunks."""
    from online_convex_optimization.models.streaming import (
        StreamingGame, StreamingKernelGame)
    B, T, d = 64, 64, 5
    z, y = _contract_batch(B, T, d, seed=23)
    ztm, ytm = z.transpose(1, 0, 2), y.T

    kg = StreamingKernelGame(B, d, eta0=1.1, interpret=True, validate=True)
    sg = StreamingGame(B, d, alg_flag=0, eta0=1.1)
    for c in range(0, T, 32):
        kg.feed(ztm[c:c + 32], ytm[c:c + 32])
        sg.feed(ztm[c:c + 32], ytm[c:c + 32])
    np.testing.assert_allclose(np.asarray(kg.result().x_last),
                               np.asarray(sg.comparator_action()),
                               atol=2e-5)

    bad = StreamingKernelGame(B, d, eta0=1.1, interpret=True, validate=True)
    with pytest.raises(ValueError, match="unit L2 ball"):
        bad.feed(3.0 * ztm[:32], ytm[:32])
    with pytest.raises(ValueError, match="labels"):
        bad.feed(ztm[:32], 0.5 * ytm[:32])


def test_streaming_kernel_d8_odd_chunks():
    """Generality: d=8 state and non-power-of-two chunk lengths (ct falls
    back to 1 when the chunk length is odd) still match the scan."""
    from online_convex_optimization.models.streaming import (
        StreamingKernelGame)
    B, T, d = 64, 70, 8
    z, y = _contract_batch(B, T, d, seed=31)
    game = StreamingKernelGame(B, d, eta0=1.3, interpret=True)
    ztm, ytm = z.transpose(1, 0, 2), y.T
    for lo, hi in ((0, 25), (25, 70)):       # odd chunk lengths 25 and 45
        game.feed(ztm[lo:hi], ytm[lo:hi])
    got = game.result()
    want = simulate_linear_batch(jnp.asarray(z), jnp.asarray(y), 0, 1.3)
    np.testing.assert_allclose(np.asarray(got.regret),
                               np.asarray(want.regret), atol=5e-4)


def test_streaming_kernel_feed_many_matches_sequential():
    """One-dispatch stacked feeding == chunk-by-chunk feeding exactly."""
    from online_convex_optimization.models.streaming import (
        StreamingKernelGame)
    from online_convex_optimization.ops.pallas_game import (
        pack_time_major)
    B, T, d, CT = 64, 128, 5, 32
    z, y = _contract_batch(B, T, d, seed=41)
    ztm, ytm = z.transpose(1, 0, 2), y.T
    packs = [pack_time_major(ztm[c:c + CT], ytm[c:c + CT])
             for c in range(0, T, CT)]
    z_stack = jnp.stack([p[0] for p in packs])
    y_stack = jnp.stack([p[1] for p in packs])

    a = StreamingKernelGame(B, d, eta0=1.2, interpret=True)
    for zp, yp in packs:
        a.feed_packed(zp, yp)
    b = StreamingKernelGame(B, d, eta0=1.2, interpret=True)
    b.feed_many_packed(z_stack, y_stack)
    np.testing.assert_array_equal(np.asarray(a.result().regret),
                                  np.asarray(b.result().regret))
    assert a.t == b.t


def test_streaming_kernel_bf16_matches_scan():
    """bf16 chunk storage (the T=1M bench path): results match the scan on
    the bf16-rounded inputs."""
    from online_convex_optimization.models.streaming import (
        StreamingKernelGame)
    B, T, d = 64, 64, 5
    z, y = _contract_batch(B, T, d, seed=51)
    game = StreamingKernelGame(B, d, eta0=1.2, dtype=jnp.bfloat16,
                               interpret=True)
    ztm, ytm = z.transpose(1, 0, 2), y.T
    for c in range(0, T, 32):
        game.feed(ztm[c:c + 32], ytm[c:c + 32])
    got = np.asarray(game.result().regret)
    z_r = np.asarray(jnp.asarray(z).astype(jnp.bfloat16).astype(jnp.float32))
    want = np.asarray(simulate_linear_batch(jnp.asarray(z_r),
                                            jnp.asarray(y), 0, 1.2).regret)
    np.testing.assert_allclose(got, want, atol=5e-4)
