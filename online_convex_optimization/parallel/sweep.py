"""Sharded scenario sweeps: the distributed replacement for the reference's
nested Python loops (driver.py:87-115) and sequential g(T) estimation
(algorithms.py:150-169).

Programs here are ``shard_map`` over a ``(data, hyper)`` mesh: every device
runs the batched ``lax.scan`` simulators on its local scenario shard, then
cross-device statistics are reduced with XLA collectives (NCCL on GPUs):

  - g(T): per-shard max regret  -> ``lax.pmax``   (algorithms.py:166-169)
  - mean/CI: per-shard (n, sum, sum of squares) -> ``lax.psum``
    (driver.py:114-127's mean +- 1.96*SEM, recast as sufficient statistics
     so shards never materialize on one host)
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.data.device import rademacher_packed_batch
from online_convex_optimization.models.smart import simulate_smart_batch
from online_convex_optimization.ops.pallas_game import (
    BLOCK,
    play_packed_stream,
    regrets_fused,
)
from online_convex_optimization.ops.pallas_smart import smart_regrets_packed
from online_convex_optimization.parallel.mesh import DATA_AXIS, HYPER_AXIS
from online_convex_optimization.utils.debug import finite_or_sentinel

_BOTH = (DATA_AXIS, HYPER_AXIS)


def _axes(mesh: Mesh):
    """All mesh axis names, as one spec entry: sweep programs shard the
    scenario batch over EVERY axis and reduce over every axis, so the
    same code serves 1-, 2- and 3-axis ((host, data, hyper)) meshes
    (VERDICT r4 task 7)."""
    return tuple(mesh.axis_names)


def sharded_max_regret(mesh: Mesh, z, y, eta0, *, alg_flag: int = 0,
                       length=None):
    """Max FTRL regret over a sharded scenario batch — the g(T) reduction.

    ``z``: (B, T, d) with B divisible by the mesh size.  Returns a scalar,
    replicated on all devices.
    """
    axes = _axes(mesh)
    in_specs = (P(axes), P(axes))
    if length is not None:
        in_specs = in_specs + (P(axes),)

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=P(),
             check_vma=False)
    def run(*args):
        if length is not None:
            z_loc, y_loc, len_loc = args
        else:
            (z_loc, y_loc), len_loc = args, None
        res = simulate_linear_batch(z_loc, y_loc, alg_flag, eta0, len_loc)
        # Failure containment (utils/debug): one diverged scenario must not
        # poison the cross-device pmax with a NaN.
        r = finite_or_sentinel(res.regret, -jnp.inf)
        local_max = jnp.max(r)
        for ax in axes:
            local_max = jax.lax.pmax(local_max, ax)
        return local_max

    args = (z, y) if length is None else (z, y, length)
    return run(*args)


def sharded_regret_stats(mesh: Mesh, z, y, alg_flag, eta0):
    """Per-shard regrets reduced to global (n, sum, sum_sq) via psum.

    Returns the sufficient statistics from which mean and SEM follow
    (driver.py:114-127) without gathering per-scenario results.
    """

    axes = _axes(mesh)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axes), P(axes)), out_specs=P(),
             check_vma=False)
    def run(z_loc, y_loc):
        res = simulate_linear_batch(z_loc, y_loc, alg_flag, eta0, None)
        # Non-finite scenario results are dropped from (n, sum, sum_sq)
        # instead of poisoning the cross-device psum (utils/debug).
        finite = jnp.isfinite(res.regret)
        r = jnp.where(finite, res.regret, 0.0)
        stats = jnp.stack([jnp.sum(finite.astype(r.dtype)), jnp.sum(r),
                           jnp.sum(r * r)])
        stats = jax.lax.psum(stats, axes)
        return stats

    return run(z, y)


def sharded_smart_regrets(mesh: Mesh, z, y, theta_thresh, eta0, *,
                          block_size: int = 128):
    """SMART regrets computed shard-locally, returned still sharded.

    theta_thresh / eta0 may be (B,) grids sharded with the batch — a
    hyperparameter sweep rides the same program.
    """
    axes = _axes(mesh)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axes), P(axes), P(axes), P(axes)),
             out_specs=P(axes), check_vma=False)
    def run(z_loc, y_loc, th_loc, eta_loc):
        res = simulate_smart_batch(z_loc, y_loc, th_loc, eta_loc, None,
                                   block_size=block_size)
        return res.regret

    B = z.shape[0]
    theta_thresh = jnp.broadcast_to(jnp.asarray(theta_thresh, z.dtype), (B,))
    eta0 = jnp.broadcast_to(jnp.asarray(eta0, z.dtype), (B,))
    return run(z, y, theta_thresh, eta0)


def _check_blocks(Bp: int, mesh: Mesh):
    """Every device gets whole kernel blocks of sequences."""
    if Bp % (BLOCK * mesh.size):
        raise ValueError(f"padded batch {Bp} is not a multiple of "
                         f"{BLOCK} x {mesh.size} devices")


def sharded_pallas_regrets(mesh: Mesh, z_pack, y_pack, eta, *,
                           alg_flag: int = 0, interpret: bool = False):
    """The regret kernel under ``shard_map``: the packed sequence axis is
    sharded across the whole mesh, each device runs the kernel on its
    local sequences, results stay sharded.  ``eta``: scalar, or (Bp,)
    per sequence (sharded with the sequences).  ``interpret=True`` runs
    the kernel in the Pallas interpreter (CPU meshes)."""
    _check_blocks(z_pack.shape[2], mesh)
    per_seq = getattr(eta, "ndim", 0) == 1
    axes = _axes(mesh)
    in_specs = ((P(None, None, axes), P(None, axes))
                + ((P(axes),) if per_seq else ()))

    @partial(shard_map, mesh=mesh, in_specs=in_specs, out_specs=P(axes),
             check_vma=False)
    def run(z_loc, y_loc, *maybe_eta):
        eta_loc = maybe_eta[0] if maybe_eta else eta
        return regrets_fused(z_loc, y_loc, eta_loc, alg_flag=alg_flag,
                             interpret=interpret)

    args = (z_pack, y_pack) + ((eta,) if per_seq else ())
    return run(*args)


def sharded_smart_pallas(mesh: Mesh, z_pack, y_pack, thresh, eta,
                         *, interpret: bool = False):
    """The SMART kernel under ``shard_map``: sequences (and their (Bp,)
    threshold/eta settings) shard across the whole mesh.  Returns
    (regret, switch_t), both still sharded."""
    _check_blocks(z_pack.shape[2], mesh)
    axes = _axes(mesh)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, None, axes), P(None, axes), P(axes),
                       P(axes)),
             out_specs=(P(axes), P(axes)), check_vma=False)
    def run(z_loc, y_loc, th_loc, eta_loc):
        return smart_regrets_packed(z_loc, y_loc, th_loc, eta_loc,
                                    interpret=interpret)

    return run(z_pack, y_pack, thresh, eta)


def sharded_quadratic_regrets(mesh: Mesh, z, y, *, alg_flag: int = 1,
                              eta0: float = 1.0):
    """Quadratic-track regrets under shard_map ((B, T, d) API; the
    exact-FTL game is embarrassingly parallel over sequences, so the
    batch shards over the whole mesh with no collectives)."""
    from online_convex_optimization.models.quadratic import (
        simulate_quadratic_batch)

    axes = _axes(mesh)

    @partial(shard_map, mesh=mesh, in_specs=(P(axes), P(axes)),
             out_specs=P(axes), check_vma=False)
    def run(z_loc, y_loc):
        return simulate_quadratic_batch(z_loc, y_loc, alg_flag, eta0).regret

    return run(z, y)


def sharded_stream_step(mesh: Mesh, z_pack, y_pack, eta, t0, carry, *,
                        alg_flag: int = 0, interpret: bool = False):
    """One streaming advance (ops/pallas_game.py::play_packed_stream) under
    ``shard_map``: sequences and the O(B d) carry shard across the whole
    mesh, so long streams run data-parallel with no collectives on the
    hot path (the carry never leaves its device).  Finalize with
    ``ops.pallas_game.stream_result``, which is elementwise over
    sequences and runs on the sharded carry as it is.
    """
    _check_blocks(z_pack.shape[2], mesh)
    axes = _axes(mesh)
    carry_specs = (P(None, axes),) * 3

    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, None, axes), P(None, axes)) + carry_specs,
             out_specs=carry_specs, check_vma=False)
    def run(z_loc, y_loc, th_loc, w_loc, sc_loc):
        return play_packed_stream(z_loc, y_loc, eta, t0,
                                  (th_loc, w_loc, sc_loc),
                                  alg_flag=alg_flag, interpret=interpret)

    return run(z_pack, y_pack, *carry)


def device_synthetic_regrets(seed, eta, *, T: int, block_seqs: int,
                             alg_flag: int = 0, interpret: bool = False):
    """Regrets of ``block_seqs`` sequences (d=5) generated on the device
    from ``seed`` (Rademacher unit rows and labels, data/device.py),
    played by the regret kernel.  The default ``regret_fn`` of the
    synthetic g sweep."""
    z, y = rademacher_packed_batch(seed, T, block_seqs)
    return regrets_fused(z, y, eta, alg_flag=alg_flag, interpret=interpret)


def sharded_synthetic_g(mesh: Mesh, *, T: int, eta_grid,
                        blocks_per_device: int, block_seqs: int = 65536,
                        seed0: int = 0, alg_flag: int = 0,
                        interpret: bool = False, regret_fn=None,
                        block_offset: int = 0,
                        total_blocks_per_device: int = 0):
    """Large-scale empirical-g sweep (BASELINE config 5): millions of
    sequences x a step-size grid, with the data generated on the device.

    Axis layout:
      - ``hyper`` axis shards the eta grid (``len(eta_grid)`` divisible by
        the axis size);
      - ``data`` axis owns disjoint PRNG seed blocks — every data shard
        evaluates its local etas on its own sequences, and the per-eta
        worst case reduces with ``lax.pmax`` over the data axis
        (algorithms.py:166-169's max, distributed).

    Seeds depend only on the data-axis index, so every eta is scored on
    the SAME sequence population (common random numbers) regardless of the
    mesh shape: ``g(mesh=(D, H), blocks=b)`` equals
    ``g(mesh=(1, 1), blocks=D * b)`` exactly.  Each seed block is
    ``block_seqs`` sequences of Rademacher rows scaled 1/sqrt(d),
    generated on the device with ``jax.random`` keyed by the block's seed
    id (``device_synthetic_regrets``); nothing is transferred from the
    host at any scale, and one block's data is alive at a time.

    Returns (len(eta_grid),) worst-case regrets.  Total sequences per eta
    = (product of non-hyper axis sizes) * blocks_per_device * block_seqs
    — on a 3-axis mesh the host rows own disjoint seed blocks, so
    coverage grows with the host axis.

    ``regret_fn(seed, eta, *, T, block_seqs, alg_flag, interpret)``
    defaults to ``device_synthetic_regrets``; tests inject stand-ins to
    check the seed and collective logic alone.

    ``block_offset`` / ``total_blocks_per_device`` support SLICED sweeps
    (resumable_synthetic_g): the call evaluates per-device seed blocks
    [block_offset, block_offset + blocks_per_device) out of a logical
    total of ``total_blocks_per_device`` (0 = this call is the whole
    sweep).  Seed ids are dev * total + offset + b, so the union of
    slices reproduces the uninterrupted sweep's sequence population
    EXACTLY, block by block.
    """
    if regret_fn is None:
        regret_fn = device_synthetic_regrets

    total_bpd = total_blocks_per_device or blocks_per_device
    if block_offset + blocks_per_device > total_bpd:
        raise ValueError((block_offset, blocks_per_device, total_bpd))
    etas = jnp.asarray(eta_grid, jnp.float32)
    n_hyper = mesh.shape[HYPER_AXIS]
    if etas.shape[0] % n_hyper:
        raise ValueError(f"len(eta_grid)={etas.shape[0]} not divisible by "
                         f"hyper axis size {n_hyper}")
    # Seed blocks are strided by 2^20 in int32 space: block index 4096
    # would wrap to block 0's seed and silently duplicate its sequence
    # population.  All NON-hyper axes (data; plus host on 3-axis meshes)
    # own disjoint blocks.
    n_data_total = 1
    for ax, size in zip(mesh.axis_names, mesh.devices.shape):
        if ax != HYPER_AXIS:
            n_data_total *= int(size)
    total_blocks = n_data_total * total_bpd
    if total_blocks > (1 << 12):
        raise ValueError(
            f"non-hyper devices * blocks_per_device = {total_blocks} "
            f"exceeds the 4096 disjoint seed blocks available in int32 "
            f"seed space; raise block_seqs instead of the block count")
    prog = _synthetic_g_program(mesh, T, blocks_per_device, total_bpd,
                                block_seqs, seed0, alg_flag, interpret,
                                regret_fn)
    return prog(etas, jnp.int32(block_offset))


@functools.lru_cache(maxsize=64)
def _synthetic_g_program(mesh, T, blocks_per_device, total_bpd, block_seqs,
                         seed0, alg_flag, interpret, regret_fn):
    # Cached per static config: a fresh shard_map closure per call would
    # retrace (and recompile) every invocation.  block_offset is a
    # DYNAMIC operand so every slice of a resumable sweep shares this one
    # compile.
    # Flattened data-shard index over EVERY non-hyper axis (data; plus
    # host on 3-axis meshes), so host rows own DISJOINT seed blocks and
    # the reduction covers the whole mesh — mesh-factorization-invariant
    # like the rest of the sweep programs (r5 code-review finding: the
    # DATA_AXIS-only version silently duplicated the host rows' data).
    nh_axes = [ax for ax in mesh.axis_names if ax != HYPER_AXIS]
    nh_sizes = [int(sz) for ax, sz in
                zip(mesh.axis_names, mesh.devices.shape)
                if ax != HYPER_AXIS]

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(P(HYPER_AXIS), P()),
             out_specs=P(HYPER_AXIS), check_vma=False)
    def run(etas_loc, offset):
        dev = jnp.int32(0)
        for ax, sz in zip(nh_axes, nh_sizes):
            dev = dev * sz + jax.lax.axis_index(ax).astype(jnp.int32)

        def per_eta(eta):
            def body(b, acc):
                # Disjoint seed blocks, 2^20 apart.
                seed = seed0 + ((dev * total_bpd + offset + b) << 20)
                r = regret_fn(seed, eta, T=T, block_seqs=block_seqs,
                              alg_flag=alg_flag, interpret=interpret)
                return jnp.maximum(acc, jnp.max(r))

            return jax.lax.fori_loop(0, blocks_per_device, body,
                                     jnp.float32(-jnp.inf))

        g_loc = jax.lax.map(per_eta, etas_loc)
        return jax.lax.pmax(g_loc, tuple(nh_axes))

    return run


def resumable_synthetic_g(mesh: Mesh, *, T: int, eta_grid,
                          blocks_per_device: int, blocks_per_step: int,
                          checkpoint_path: Optional[str] = None,
                          block_seqs: int = 65536, seed0: int = 0,
                          alg_flag: int = 0, interpret: bool = False,
                          regret_fn=None):
    """Preemption-safe g sweep (VERDICT r4 task 7; SURVEY §5 "failure
    detection / elastic recovery").

    The per-device seed blocks are processed in slices of
    ``blocks_per_step``; after each slice the running per-eta max and the
    completed-block count are checkpointed (utils.checkpointing).  A
    preempted host restarts with the same arguments and resumes from the
    last completed slice; because slice seeds are the SAME global block
    ids the uninterrupted sweep uses and max is exact, the resumed result
    is BIT-EQUAL to the uninterrupted ``sharded_synthetic_g`` — tested in
    tests/test_preemption.py by killing a sweep mid-flight.

    Returns (len(eta_grid),) worst-case regrets as float32.
    """
    from online_convex_optimization.utils import checkpointing as ckpt
    from online_convex_optimization.utils.logging_utils import get_logger

    etas = np.asarray(eta_grid, np.float32)
    # Provenance key (same discipline as gt._load_g_cache, round-2
    # ADVICE): resuming accumulators produced under a DIFFERENT config
    # would silently blend incomparable maxima.  The key is stored as a
    # hashed array leaf alongside the state; mismatch recomputes from
    # scratch with a warning.
    import hashlib
    import json as _json
    key_str = _json.dumps({
        "T": int(T), "etas": [float(v) for v in etas],
        "blocks_per_device": int(blocks_per_device),
        "block_seqs": int(block_seqs), "seed0": int(seed0),
        "alg_flag": int(alg_flag),
        "mesh": {str(k): int(v) for k, v in
                 zip(mesh.axis_names, mesh.devices.shape)},
    }, sort_keys=True)
    key_hash = np.frombuffer(
        hashlib.sha256(key_str.encode()).digest()[:8], np.int64)[0]

    g = np.full(etas.shape, -np.inf, np.float32)
    done = 0
    state_like = {"g": g, "done": np.asarray(0),
                  "key": np.asarray(0, np.int64)}
    if checkpoint_path and ckpt.exists(checkpoint_path):
        st = ckpt.load_pytree(checkpoint_path, state_like)
        if int(st["key"]) == int(key_hash):
            g, done = np.asarray(st["g"], np.float32), int(st["done"])
        else:
            get_logger().warning(
                "resumable_synthetic_g: checkpoint %s was produced under "
                "a different config (key mismatch); recomputing from "
                "scratch", checkpoint_path)
    while done < blocks_per_device:
        # NOTE: a ragged last slice (blocks_per_step not dividing
        # blocks_per_device) compiles a second program (the per-slice
        # block count is static); pick a divisor to stay on one compile.
        step = min(blocks_per_step, blocks_per_device - done)
        g_slice = sharded_synthetic_g(
            mesh, T=T, eta_grid=eta_grid, blocks_per_device=step,
            total_blocks_per_device=blocks_per_device, block_offset=done,
            block_seqs=block_seqs, seed0=seed0, alg_flag=alg_flag,
            interpret=interpret, regret_fn=regret_fn)
        g = np.maximum(g, np.asarray(g_slice, np.float32))
        done += step
        if checkpoint_path:
            ckpt.save_pytree(checkpoint_path,
                             {"g": g, "done": np.asarray(done),
                              "key": np.asarray(key_hash, np.int64)})
    return g


def mean_and_ci(stats, z_value: float = 1.96):
    """mean +- z * SEM from (n, sum, sum_sq) sufficient statistics.

    Matches driver.py:59-63's ddof=1 SEM.
    """
    n, s, ss = stats[0], stats[1], stats[2]
    mean = s / n
    var = jnp.maximum(ss - n * mean * mean, 0.0) / jnp.maximum(n - 1.0, 1.0)
    sem = jnp.sqrt(var / n)
    ci = jnp.where(n > 1.0, z_value * sem, 0.0)
    return mean, ci
