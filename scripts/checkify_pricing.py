"""Checkify pricing on the g(T) sweep (VERDICT round-2 task 7).

``estimate_g(check=True)`` checkify-wraps the batched simulator so a
NaN/inf born inside the scan surfaces as a located error instead of
silently riding into the max reduction (``utils.debug.checked``).  What
does that guard cost on the g(T) sweep?  (``--check`` defaults on.)

This probe times the hot call of the sweep — ``gt._g_for_T`` over a
padded one-compile chunk, exactly what ``estimate_g`` runs per horizon —
with check on/off on the current backend and prints the measured ratio
(appended as a JSON line to ``--out`` when given).  The pipeline's own
dtype rule applies: x64 on the CPU, f32 on an accelerator.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", type=int, default=200)
    parser.add_argument("--T", type=int, default=1000)
    parser.add_argument("--out", default="",
                        help="append the record to this JSON-lines file")
    args = parser.parse_args()

    import jax

    from online_convex_optimization.experiments.gt import _g_for_T
    from online_convex_optimization.utils.logging_utils import log_metrics

    backend = jax.default_backend()
    dtype = np.float64 if backend == "cpu" else np.float32

    timings = {}
    for check in (False, True):
        # Warm (compile + host RNG caches), then best-of-3.
        _g_for_T(args.T, args.runs, 0, np.sqrt(2.0), dtype, 4096,
                 check=check)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            g = _g_for_T(args.T, args.runs, 0, np.sqrt(2.0), dtype, 4096,
                         check=check)
            best = min(best, time.perf_counter() - t0)
        timings[check] = best
        print({"check": check, "seconds": best, "g": g})

    ratio = timings[True] / timings[False]
    rec = {"metric": f"checkify_g_sweep_overhead_{backend}",
           "value": ratio, "unit": "x",
           "note": f"_g_for_T T={args.T} runs={args.runs} "
                   f"dtype={np.dtype(dtype).name}: "
                   f"check=False {timings[False]:.3f}s, "
                   f"check=True {timings[True]:.3f}s (warm best-of-3; "
                   f"host sequence generation included, as in the sweep)",
           "backend": backend}
    print(rec)
    if args.out:
        log_metrics(args.out, rec)


if __name__ == "__main__":
    main()
