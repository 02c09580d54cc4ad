"""Preemption drill (VERDICT r4 task 7; SURVEY §5 failure detection /
elastic recovery): a sharded g-sweep is KILLED mid-flight in a child
process, then resumed from its checkpointed (per-eta max, blocks-done)
accumulators — the final table must be BIT-EQUAL to an uninterrupted
sweep."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from online_convex_optimization.parallel.mesh import make_mesh
from online_convex_optimization.parallel.sweep import (
    resumable_synthetic_g,
    sharded_synthetic_g,
)

ETAS = (0.5, 1.0, 1.5, 2.0)


def _fake_synth_regrets(seed, eta, *, T, block_seqs, alg_flag, interpret):
    key = jax.random.fold_in(jax.random.key(T + 31 * alg_flag),
                             jnp.asarray(seed, jnp.int32) >> 20)
    base = jax.random.uniform(key, (block_seqs,), jnp.float32)
    return base * eta


_CHILD = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
jax.config.update("jax_enable_x64", True)
sys.path.insert(0, {repo!r})
from online_convex_optimization.parallel.mesh import make_mesh
from online_convex_optimization.parallel import sweep as sw

def fake(seed, eta, *, T, block_seqs, alg_flag, interpret):
    key = jax.random.fold_in(jax.random.key(T + 31 * alg_flag),
                             jnp.asarray(seed, jnp.int32) >> 20)
    return jax.random.uniform(key, (block_seqs,), jnp.float32) * eta

calls = {{"n": 0}}
orig = sw.sharded_synthetic_g
def counting(*a, **k):
    calls["n"] += 1
    if calls["n"] == {kill_at}:
        # Simulate preemption MID-FLIGHT: die before this slice's
        # checkpoint lands, losing its partial work.
        os._exit(17)
    return orig(*a, **k)
sw.sharded_synthetic_g = counting

sw.resumable_synthetic_g(
    make_mesh(4, 2), T=32, eta_grid={etas}, blocks_per_device=8,
    blocks_per_step=2, block_seqs=128, checkpoint_path={ckpt!r},
    regret_fn=fake)
print("UNEXPECTED: sweep completed without preemption")
os._exit(1)
"""


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")
def test_killed_sweep_resumes_bit_equal(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ckpt = str(tmp_path / "g_sweep.npz")

    # 1) child process dies at the start of slice 3 (blocks 4..6 lost).
    script = _CHILD.format(repo=repo, kill_at=3, ckpt=ckpt,
                           etas=list(ETAS))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = repo  # drop any inherited site hooks
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 17, (proc.returncode, proc.stderr[-2000:])
    assert os.path.exists(ckpt), "no checkpoint survived the kill"
    from online_convex_optimization.utils.checkpointing import (
        load_pytree)
    state = load_pytree(ckpt, {"g": np.zeros(len(ETAS), np.float32),
                               "done": np.asarray(0),
                               "key": np.asarray(0, np.int64)})
    assert int(state["done"]) == 4, state  # two slices survived, third lost

    # 2) resume in-process from the checkpoint; must complete.
    mesh = make_mesh(4, 2)
    g_resumed = resumable_synthetic_g(
        mesh, T=32, eta_grid=list(ETAS), blocks_per_device=8,
        blocks_per_step=2, block_seqs=128, checkpoint_path=ckpt,
        regret_fn=_fake_synth_regrets)

    # 3) uninterrupted single-shot sweep: bit-equal.
    g_full = np.asarray(sharded_synthetic_g(
        mesh, T=32, eta_grid=list(ETAS), blocks_per_device=8,
        block_seqs=128, regret_fn=_fake_synth_regrets), np.float32)
    np.testing.assert_array_equal(g_resumed, g_full)


def test_resumable_equals_single_shot_without_preemption(tmp_path):
    """Slicing alone (no kill) is bit-neutral, including a ragged last
    slice."""
    mesh = make_mesh(4, 2)
    g_sliced = resumable_synthetic_g(
        mesh, T=32, eta_grid=list(ETAS), blocks_per_device=8,
        blocks_per_step=3, block_seqs=128,
        checkpoint_path=str(tmp_path / "g.npz"),
        regret_fn=_fake_synth_regrets)
    g_full = np.asarray(sharded_synthetic_g(
        mesh, T=32, eta_grid=list(ETAS), blocks_per_device=8,
        block_seqs=128, regret_fn=_fake_synth_regrets), np.float32)
    np.testing.assert_array_equal(g_sliced, g_full)


def test_checkpoint_provenance_mismatch_recomputes(tmp_path):
    """A checkpoint produced under a DIFFERENT config must not be
    resumed (it would blend incomparable maxima — same guard discipline
    as gt._load_g_cache): the sweep recomputes from scratch and the
    answer matches the uninterrupted run."""
    mesh = make_mesh(4, 2)
    ck = str(tmp_path / "g.npz")
    resumable_synthetic_g(mesh, T=16, eta_grid=list(ETAS),
                          blocks_per_device=4, blocks_per_step=2,
                          block_seqs=128, checkpoint_path=ck,
                          regret_fn=_fake_synth_regrets)
    # Same path, different T: the stale accumulators must be discarded.
    g = resumable_synthetic_g(mesh, T=32, eta_grid=list(ETAS),
                              blocks_per_device=4, blocks_per_step=2,
                              block_seqs=128, checkpoint_path=ck,
                              regret_fn=_fake_synth_regrets)
    g_full = np.asarray(sharded_synthetic_g(
        mesh, T=32, eta_grid=list(ETAS), blocks_per_device=4,
        block_seqs=128, regret_fn=_fake_synth_regrets), np.float32)
    np.testing.assert_array_equal(g, g_full)
