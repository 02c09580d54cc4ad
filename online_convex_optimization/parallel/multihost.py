"""Multi-host sweep worker: the multi-process entry point.

On several hosts each host runs this module (all with the same arguments
plus its own process id); ``jax.distributed.initialize`` is given the
coordinator address, process count and id explicitly.  The same code
path is smoke-tested by spawning N CPU processes with gloo collectives
(tests/test_multihost.py) — exercising true cross-process psum/pmax.

Worker protocol: each process generates ITS OWN scenario shard on device
(data/device.py keys are split per process), runs the batched FTRL game
locally, and only the g(T) max and the (n, sum, sum_sq) regret statistics
cross hosts — O(1) bytes between hosts per sweep, as SURVEY.md §5
prescribes.
"""

from __future__ import annotations

import argparse
import json
from functools import partial
from typing import Optional

import numpy as np


def run_worker(T: int, per_device_batch: int, *, eta0: float,
               seed: int = 0, coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               n_hyper: int = 1, bench_reps: int = 0,
               host_axis: bool = False) -> dict:
    """Run one host's share of a global FTRL regret sweep; returns the
    globally reduced statistics (identical on every host).

    ``n_hyper > 1`` turns the sweep into a 2-axis (data, hyper) program:
    the global devices form a (n_global/n_hyper, n_hyper) mesh, each hyper
    column evaluates its own eta (eta0 scaled by a per-column factor), data
    collectives reduce within each column, and the per-eta results return
    sharded over the hyper axis — the pod-scale shape of a learning-rate
    sweep.

    ``host_axis=True`` (VERDICT r4 task 7) makes the PROCESS boundary an
    explicit leading mesh axis: devices reshape to (n_host, n_data,
    n_hyper) with each process's local devices forming one host row, and
    the sweep reduces over (host, data) — the per-host psum/pmax rides
    gloo/DCN across processes while the intra-host reduction stays local,
    exactly the collective layout of a real multi-host pod."""
    import jax

    if num_processes is not None and num_processes > 1:
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)

    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from online_convex_optimization.data.device import random_game_batch
    from online_convex_optimization.models.linear import simulate_linear_batch

    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    if n_global % n_hyper:
        raise ValueError(f"n_hyper={n_hyper} must divide {n_global}")
    n_data = n_global // n_hyper
    eta_grid = jnp.asarray(
        eta0 * np.linspace(1.0, 2.0, n_hyper, dtype=np.float32))

    # Per-device scenario shards from independent keys (split globally so
    # every device's stream is distinct and reproducible).  The key ->
    # device assignment is the flat jax.devices() order in BOTH mesh
    # layouts, so host_axis only changes the collective structure, not
    # the data — solo and multi-host runs stay comparable.
    keys = jax.random.split(jax.random.key(seed), n_global)

    if host_axis:
        n_host = num_processes if (num_processes or 0) > 1 else 1
        if n_data % n_host:
            raise ValueError(f"host axis {n_host} must divide data axis "
                             f"{n_data}")
        mesh = Mesh(np.asarray(jax.devices()).reshape(
            n_host, n_data // n_host, n_hyper), ("host", "data", "hyper"))
        keys = keys.reshape(n_host, n_data // n_host, n_hyper)
        key_spec = P("host", "data", "hyper")
        reduce_axes = ("host", "data")
    else:
        mesh = Mesh(np.asarray(jax.devices()).reshape(n_data, n_hyper),
                    ("data", "hyper"))
        keys = keys.reshape(n_data, n_hyper)
        key_spec = P("data", "hyper")
        reduce_axes = ("data",)

    @partial(jax.shard_map, mesh=mesh, in_specs=key_spec,
             out_specs=(P("hyper"), P("hyper")), check_vma=False)
    def sweep(key_shard):
        key0 = key_shard.reshape(-1)[0]
        z, y = random_game_batch(key0, per_device_batch, T)
        eta = eta_grid[jax.lax.axis_index("hyper")]
        res = simulate_linear_batch(z, y, 0, eta)
        r = res.regret
        # Reduce over every non-hyper axis: one result per eta column.
        g_max = jax.lax.pmax(jnp.max(r), reduce_axes)
        stats = jax.lax.psum(
            jnp.stack([jnp.asarray(r.size, r.dtype), jnp.sum(r),
                       jnp.sum(r * r)]), reduce_axes)
        return g_max[None], stats[None]

    jitted = jax.jit(sweep)
    g_max, stats = jitted(keys)
    g_max = np.asarray(g_max)                       # (n_hyper,)
    stats = np.asarray(stats)                       # (n_hyper, 3)
    n = stats[:, 0]
    mean = stats[:, 1] / n
    var = np.maximum(stats[:, 2] - n * mean * mean, 0.0) / np.maximum(
        n - 1.0, 1.0)
    out = {
        "process_id": process_id or 0,
        "n_global_devices": n_global,
        "n_local_devices": n_local,
        "mesh": (list(mesh.devices.shape) if host_axis
                 else [n_data, n_hyper]),
        "axes": list(mesh.axis_names),
        "total_scenarios": int(n.sum()),
        "g_max_by_eta": [float(v) for v in g_max],
        "mean_by_eta": [float(v) for v in mean],
        "eta_grid": [float(v) for v in np.asarray(eta_grid)],
        # Single-axis compatibility fields (global over everything).
        "g_max": float(g_max.max()),
        "mean_regret": float((stats[:, 1].sum()) / n.sum()),
        "sem": float(np.sqrt(var.mean() / n.sum())),
    }

    if bench_reps > 0:
        # Timed mode (BASELINE.md: steps/s at 1 host / >= 2 hosts): the
        # sweep is re-run bench_reps times; the host fetch fences each.
        import time
        np.asarray(jitted(keys)[0])
        best = float("inf")
        for _ in range(bench_reps):
            t0 = time.perf_counter()
            np.asarray(jitted(keys)[0])
            best = min(best, time.perf_counter() - t0)
        steps = n_global * per_device_batch * T
        out["bench_steps_per_s"] = steps / best
        out["bench_steps_per_s_per_device"] = steps / best / n_global
    return out


def run_stream_handoff(T: int, B: int, *, chunks: int = 8, split: int = 4,
                       eta0: float, seed: int = 0,
                       coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> dict:
    """Sequence-parallel hand-off: process 0 advances the streaming carry
    through chunks [0, split), SHIPS it over the wire (gloo here; NCCL
    between GPUs the same way), and process 1 finishes chunks
    [split, chunks) — the time axis of ONE logical stream split across
    hosts.  The shipped carry is O(B*d) bytes regardless of T, the whole
    point of the chunked-carry streaming design (models/streaming.py).

    Every process also runs the full stream locally as the single-process
    reference; the hand-off result must match it BITWISE (the carry is
    f32-exact through the broadcast and _advance is deterministic)."""
    import jax

    multi = num_processes is not None and num_processes > 1
    if multi:
        try:
            jax.config.update("jax_cpu_collectives_implementation", "gloo")
        except Exception:
            pass
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    from jax.experimental import multihost_utils

    from online_convex_optimization.models.streaming import StreamingGame

    d = 5
    pid = process_id or 0
    if T % chunks:
        raise ValueError("T must divide into chunks")
    CT = T // chunks
    # Deterministic stream both processes can regenerate (contract data).
    rng = np.random.default_rng(seed)
    zs = rng.standard_normal((chunks, CT, B, d)).astype(np.float32)
    zs /= np.maximum(np.linalg.norm(zs, axis=-1, keepdims=True), 1.0)
    ys = np.sign(rng.standard_normal((chunks, CT, B))).astype(np.float32)
    ys[ys == 0] = 1.0

    def replay():
        return ((zs[c], ys[c]) for c in range(chunks))

    # Single-process reference (each host computes it independently).
    ref = StreamingGame(B, d, alg_flag=0, eta0=eta0)
    for c in range(chunks):
        ref.feed(zs[c], ys[c])
    ref_res = ref.result(replay())

    # Hand-off run.
    game = StreamingGame(B, d, alg_flag=0, eta0=eta0)
    if pid == 0:
        for c in range(split):
            game.feed(zs[c], ys[c])
    if multi:
        carry = multihost_utils.broadcast_one_to_all(
            game.carry_state(), is_source=(pid == 0))
        game.resume(jax.tree.map(np.asarray, carry))
    finisher = 1 if multi else 0
    if pid == finisher:
        for c in range(split, chunks):
            game.feed(zs[c], ys[c])
    if multi:
        final = multihost_utils.broadcast_one_to_all(
            game.carry_state(), is_source=(pid == finisher))
        game.resume(jax.tree.map(np.asarray, final))
    res = game.result(replay())

    cum = np.asarray(res.cum_loss)
    reg = np.asarray(res.regret)
    return {
        "process_id": pid,
        "mode": "stream-handoff",
        "chunks": chunks,
        "split": split,
        "cum_loss": [float(v) for v in cum],
        "regret": [float(v) for v in reg],
        "bitwise_cum": bool((cum == np.asarray(ref_res.cum_loss)).all()),
        "bitwise_regret": bool((reg == np.asarray(ref_res.regret)).all()),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description="multi-host OCO sweep worker")
    p.add_argument("--t", type=int, default=256)
    p.add_argument("--per-device-batch", type=int, default=1024)
    p.add_argument("--eta0", type=float, default=float(np.sqrt(2.0)))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--hyper", type=int, default=1,
                   help="size of the hyperparameter mesh axis")
    p.add_argument("--bench-reps", type=int, default=0,
                   help="time the sweep this many times (0 = off)")
    p.add_argument("--host-axis", action="store_true",
                   help="3-axis (host, data, hyper) mesh with the "
                        "process boundary as the leading axis")
    p.add_argument("--mode", choices=["sweep", "stream-handoff"],
                   default="sweep")
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--split", type=int, default=4)
    args = p.parse_args(argv)
    if args.mode == "stream-handoff":
        out = run_stream_handoff(args.t, args.per_device_batch,
                                 chunks=args.chunks, split=args.split,
                                 eta0=args.eta0, seed=args.seed,
                                 coordinator=args.coordinator,
                                 num_processes=args.num_processes,
                                 process_id=args.process_id)
    else:
        out = run_worker(args.t, args.per_device_batch, eta0=args.eta0,
                         seed=args.seed, coordinator=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id, n_hyper=args.hyper,
                         bench_reps=args.bench_reps,
                         host_axis=args.host_axis)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
