"""Headline benchmark: FTRL regret steps/s on one GPU (batched online game).

Prints the card's name and power limit, then ONE JSON line:
  {"metric": "ftrl_steps_per_s", "value": N, "unit": "steps/s",
   "median": ..., "min": ..., "repeats": 5, "device": {...}}

A "step" is one full online round for one sequence: action (scale +
ball projection), prediction dot product, hinge loss, subgradient,
accumulator update (fast_algorithms.py:99-112 semantics).  The measured
program also scores the comparator (in the kernel's carried statistics),
so the number is end-to-end regret evaluation throughput.

Shape: 262,144 sequences x T=1024 x d=5 resident on the device, z as bf16
and y as int8 (11 bytes per step), generated on the device.  Each repeat
is one ``regrets_fused`` call ending in ``block_until_ready``; the number
is steps over the median (and best) of 5 repeats after a warm-up.
Without a GPU the benchmark refuses to run.

    python bench.py
"""

import json
import shutil
import subprocess
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from online_convex_optimization.data.device import random_packed_batch
    from online_convex_optimization.ops.pallas_game import regrets_fused
    from online_convex_optimization.utils import compile_cache, telemetry

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench.py: needs a GPU; JAX found "
                         f"{jax.devices()[0].platform}")
    compile_cache.enable()
    telemetry.install()
    if shutil.which("nvidia-smi"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    T, B = 1024, 262144
    z, y = random_packed_batch(jax.random.key(0), T, B, dtype=jnp.bfloat16,
                               y_dtype=jnp.int8)
    eta = np.float32(np.sqrt(2.0))
    run = jax.jit(lambda z, y: regrets_fused(z, y, eta))
    jax.block_until_ready(run(z, y))           # compile + warm
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(run(z, y))
        times.append(time.perf_counter() - t0)
    rates = sorted(B * T / t for t in times)
    print(json.dumps({
        "metric": "ftrl_steps_per_s",
        "value": rates[-1],
        "unit": "steps/s",
        "median": rates[len(rates) // 2],
        "min": rates[0],
        "repeats": len(rates),
        "spread_frac": (rates[-1] - rates[0]) / rates[-1],
        "device": telemetry.snapshot(),
    }))


if __name__ == "__main__":
    main()
