"""Scaling measurement harness: steps/s at 1 chip / 1 host / N hosts.

BASELINE.md requires steps/s scaling efficiency measured across mesh
sizes.  ``measure_scaling`` runs the same sharded FTRL sweep on growing
device subsets and reports aggregate and per-device throughput plus
efficiency vs. the single-device run.  On a pod each host calls this with
its local view (jax.distributed already initialized); in the CPU test
harness virtual devices exercise the same code path.

Timing note: ``_time`` fences each measurement by pulling one scalar to
the host, which also waits for the device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.parallel.mesh import DATA_AXIS, HYPER_AXIS, make_mesh


@dataclass(frozen=True)
class ScalePoint:
    n_devices: int
    steps_per_s: float
    steps_per_s_per_device: float
    efficiency: float  # vs the smallest measured mesh


def _sweep_program(mesh, B_per_dev: int, T: int, d: int, eta0: float,
                   reps: int):
    """One timed unit: ``reps`` chained sharded FTRL batches -> max regret."""
    n = mesh.size
    B = B_per_dev * n

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P((DATA_AXIS, HYPER_AXIS)), P((DATA_AXIS, HYPER_AXIS))),
             out_specs=P(), check_vma=False)
    def run_shard(z_loc, y_loc):
        def body(i, acc):
            eta = eta0 * (1.0 + 1e-6 * i.astype(z_loc.dtype))
            res = simulate_linear_batch(z_loc, y_loc, 0, eta)
            return acc + jnp.max(res.regret)
        acc = jax.lax.fori_loop(0, reps, body, jnp.zeros((), z_loc.dtype))
        acc = jax.lax.pmax(acc, DATA_AXIS)
        return jax.lax.pmax(acc, HYPER_AXIS)

    rng = np.random.default_rng(0)
    z = rng.standard_normal((B, T, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((B, T)) < 0.5, -1.0, 1.0).astype(np.float32)
    from online_convex_optimization.parallel.mesh import scenario_sharding
    sh = scenario_sharding(mesh)
    z_dev = jax.device_put(jnp.asarray(z), sh)
    y_dev = jax.device_put(jnp.asarray(y), sh)
    fn = jax.jit(run_shard)
    return fn, (z_dev, y_dev), B * T * reps


def _time(fn, args, runs: int = 3) -> float:
    np.asarray(fn(*args))  # compile + warm, fenced by host fetch
    best = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        np.asarray(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def measure_scaling(device_counts: Optional[Sequence[int]] = None, *,
                    B_per_dev: int = 1024, T: int = 256, d: int = 5,
                    eta0: float = float(np.sqrt(2.0)),
                    reps: int = 4) -> List[ScalePoint]:
    """Measure sharded FTRL throughput for each device count."""
    n_avail = len(jax.devices())
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n_avail]
    points: List[ScalePoint] = []
    base_per_dev = None
    for n in device_counts:
        mesh = make_mesh(n, 1)
        fn, args, steps = _sweep_program(mesh, B_per_dev, T, d, eta0, reps)
        secs = _time(fn, args)
        sps = steps / secs
        per_dev = sps / n
        if base_per_dev is None:
            base_per_dev = per_dev
        points.append(ScalePoint(
            n_devices=n, steps_per_s=sps, steps_per_s_per_device=per_dev,
            efficiency=per_dev / base_per_dev))
    return points


def measure_multihost(configs=((1, 4), (2, 2)), *, T: int = 256,
                      per_device_batch: int = 512, bench_reps: int = 3):
    """Cross-PROCESS scaling: spawn (n_processes, devices_per_process)
    worker groups (gloo CPU collectives standing in for DCN) and collect
    each configuration's timed sweep throughput — the '1 host / >= 2
    hosts' rows of BASELINE.md, measurable without a pod."""
    import json as _json
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    points = []
    for n_proc, devs in configs:
        port = free_port()
        env = {**os.environ, "PYTHONPATH": repo, "JAX_PLATFORMS": "cpu",
               "XLA_FLAGS": f"--xla_force_host_platform_device_count={devs}"}
        procs = [subprocess.Popen(
            [sys.executable, "-m",
             "online_convex_optimization.parallel.multihost",
             "--t", str(T), "--per-device-batch", str(per_device_batch),
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(n_proc), "--process-id", str(i),
             "--bench-reps", str(bench_reps)],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for i in range(n_proc)]
        outs = []
        for pr in procs:
            stdout, stderr = pr.communicate(timeout=600)
            if pr.returncode != 0:
                raise RuntimeError(stderr[-2000:])
            outs.append(_json.loads(stdout.strip().splitlines()[-1]))
        points.append({
            "n_processes": n_proc,
            "devices_per_process": devs,
            "n_global_devices": outs[0]["n_global_devices"],
            "steps_per_s": outs[0]["bench_steps_per_s"],
            "steps_per_s_per_device":
                outs[0]["bench_steps_per_s_per_device"],
            "agree_across_hosts": all(
                abs(o["bench_steps_per_s"] - outs[0]["bench_steps_per_s"])
                / outs[0]["bench_steps_per_s"] < 0.5 for o in outs),
        })
    return points


def main(argv=None):
    """Measure the scaling curve and write it as a JSON artifact
    (BASELINE.md: steps/s measured across mesh sizes)."""
    import argparse
    import json

    p = argparse.ArgumentParser(description="OCO scaling curve")
    p.add_argument("--out", default="results/scaling.json")
    p.add_argument("--b-per-dev", type=int, default=1024)
    p.add_argument("--t", type=int, default=256)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--multihost", action="store_true",
                   help="also measure 1-vs-2-process (simulated hosts)")
    args = p.parse_args(argv)

    pts = measure_scaling(B_per_dev=args.b_per_dev, T=args.t, reps=args.reps)
    record = {
        "backend": jax.default_backend(),
        "n_devices_available": len(jax.devices()),
        "virtual_mesh": jax.default_backend() == "cpu",
        "workload": {"B_per_dev": args.b_per_dev, "T": args.t,
                     "reps": args.reps, "program": "sharded FTRL sweep"},
        "points": [vars(pt) for pt in pts],
    }
    if args.multihost:
        record["multihost_points"] = measure_multihost(
            T=args.t, per_device_batch=args.b_per_dev)
    import os
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    for pt in pts:
        print(f"n={pt.n_devices:3d}  {pt.steps_per_s:.3e} steps/s  "
              f"({pt.steps_per_s_per_device:.3e}/dev, "
              f"eff {pt.efficiency:.2f})")
    print(f"-> {args.out}")


if __name__ == "__main__":
    main()
