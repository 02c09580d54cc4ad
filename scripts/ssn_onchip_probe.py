"""Device f32 SSN vs warm banded ADMM at T=1024.

The f32 SSN certificate is a multi-candidate refined duality gap over
compensated double-word dots (ops/df32.py).  This probe compares it with
the production band programs (`experiments.evaluate._band_programs`, i.e.
exactly what evaluate_stream_exact dispatches) on a hard out-of-contract
batch:

  - certified fraction at the production fail_tol 2e-4 (SSN f32),
  - warm best-of-3 wall for the SSN f32 band program vs the banded ADMM.

Prints `ssn_f32_certified_frac_T1024` and the two wall records (appended
to ``--out`` when given).  Works on any backend; record the device with
any number kept.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def _hard_batch(B, T, d=5, scale=2.0, seed=0):
    rng = np.random.default_rng(seed)
    z = scale * rng.normal(size=(B, T, d)).astype(np.float32)
    y = np.sign(np.einsum("btd,bd->bt", z, rng.normal(size=(B, d)))
                + 0.5 * rng.normal(size=(B, T))).astype(np.float32)
    y[y == 0] = 1.0
    return z, y


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--T", type=int, default=1024)
    parser.add_argument("--B", type=int, default=8)
    parser.add_argument("--out", default="",
                        help="append the records to this JSON-lines file")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from online_convex_optimization.experiments.evaluate import (
        _band_programs)
    from online_convex_optimization.utils.logging_utils import log_metrics

    backend = jax.default_backend()
    z, y = _hard_batch(args.B, args.T)
    zd = jnp.asarray(z)
    yd = jnp.asarray(y)

    records = []
    walls = {}
    for name, use_ssn in (("ssn_f32", True), ("admm", False)):
        solve, _, _ = _band_programs(args.T, "l2", 2000, "highest",
                                     use_ssn, False)

        def run():
            _, res, _ = solve(zd, yd)
            return res

        res = np.asarray(run())  # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(run())
            best = min(best, time.perf_counter() - t0)
        walls[name] = best
        frac = float((res <= 2e-4).mean())
        records.append({
            "metric": f"exact_band_{name}_wall_s_T{args.T}",
            "value": best, "unit": "s",
            "note": f"warm best-of-3, B={args.B} hard out-of-contract "
                    f"sequences, production band program; certified "
                    f"fraction at 2e-4: {frac:.4f}"})
        if use_ssn:
            records.append({
                "metric": f"ssn_f32_certified_frac_T{args.T}",
                "value": frac, "unit": "frac",
                "note": "multi-candidate compensated duality-gap "
                        "certificate (round-4); round-3 baseline 0.84"})

    records.append({
        "metric": f"ssn_f32_vs_admm_wall_ratio_T{args.T}",
        "value": walls["ssn_f32"] / walls["admm"], "unit": "x",
        "note": "production band programs, warm"})

    for r in records:
        r["backend"] = backend
        print(r)
        if args.out:
            log_metrics(args.out, r)


if __name__ == "__main__":
    main()
