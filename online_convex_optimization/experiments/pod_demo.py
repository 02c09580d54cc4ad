"""Large-scale empirical-g sweep demo (BASELINE config 5).

The reference estimates g(T) by looping 1000 FTRL simulations per horizon
in one Python thread (algorithms.py:135-171).  This demo runs the
large-scale version of that estimate: millions of sequences x a step-size
grid, each device generating its own disjoint sequence population on the
device (``jax.random`` keyed by seed-block ids; nothing is transferred
from the host at any scale), playing it with the regret kernel, and
reducing the per-eta worst case across the mesh with ``lax.pmax``
(parallel/sweep.py::sharded_synthetic_g).

On several devices the same program shards the eta grid over the
``hyper`` axis and the sequence population over ``data``; on one device
it runs on a (1, 1) mesh.  The program is mesh-shape-invariant by
construction (tested on a virtual CPU mesh).

Run: ``python -m online_convex_optimization.experiments.pod_demo
--t 1000 --seqs 1048576 --out results/pod_scale_demo.json``
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--t", type=int, default=1000, help="horizon T")
    p.add_argument("--seqs", type=int, default=1 << 20,
                   help="sequences per eta (rounded up to a block multiple)")
    p.add_argument("--etas", type=float, nargs="*",
                   default=[0.25, 0.5, 0.75, 1.0, math.sqrt(2.0), 2.0,
                            2.0 * math.sqrt(2.0), 4.0])
    p.add_argument("--block-seqs", type=int, default=131072,
                   help="sequences generated and played per seed block")
    p.add_argument("--n-hyper", type=int, default=1,
                   help="hyper-axis size (eta-grid sharding)")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import jax

    from online_convex_optimization.utils import compile_cache
    compile_cache.enable()

    from online_convex_optimization.parallel.mesh import make_mesh
    from online_convex_optimization.parallel.sweep import (
        sharded_synthetic_g)

    n_dev = len(jax.devices())
    if args.n_hyper > n_dev:
        raise ValueError(f"--n-hyper {args.n_hyper} > {n_dev} devices")
    mesh = make_mesh(n_dev // args.n_hyper, args.n_hyper)
    n_data = mesh.shape["data"]
    n_used = n_data * args.n_hyper  # devices the mesh actually covers
    per_block = args.block_seqs
    blocks = -(-args.seqs // (per_block * n_data))
    seqs = blocks * per_block * n_data

    def run():
        g = sharded_synthetic_g(mesh, T=args.t, eta_grid=args.etas,
                                blocks_per_device=blocks,
                                block_seqs=args.block_seqs)
        return np.asarray(g)

    g = run()                 # warm-up (compile)
    t0 = time.perf_counter()
    g = run()
    wall = time.perf_counter() - t0

    steps = len(args.etas) * seqs * args.t
    result = {
        "metric": "pod_scale_g_sweep",
        "T": args.t,
        "n_sequences_per_eta": seqs,
        "eta_grid": list(args.etas),
        "g_max": {f"{e:g}": float(v) for e, v in zip(args.etas, g)},
        "devices": n_used,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "mesh": dict(mesh.shape),
        "total_steps": steps,
        "wall_s": wall,
        "steps_per_s": steps / wall,
        "note": ("worst-case FTRL regret over device-generated Rademacher "
                 "sequences generated on the device; pmax over the data "
                 "axis, eta grid on the hyper axis"),
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
