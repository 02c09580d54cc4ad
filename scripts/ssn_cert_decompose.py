"""Decompose the f32 SSN certificate's wall time across its knobs.

This probe attributes the wall of the f32 SSN band solve (T=1024, B=8,
`ssn_onchip_probe.py`'s batch) across the certificate knobs by re-timing
the SAME band solve with each knob dialed down, fresh-traced per config:

  default      : production constants
  cert_1x      : _CERT_EVERY=200 — certificate evaluated once, newton
                 budget unchanged => cert-count share
  rungs_1      : one continuation rung instead of 4 => rung share
  refine_min   : refinement/polish loop counts minimized => candidate-
                 refinement share
  inner_1      : 1 fixed-mu inner step per rung instead of 4

Prints `ssn_cert_decomp_*` wall records (appended to ``--out`` when
given).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--T", type=int, default=1024)
    parser.add_argument("--B", type=int, default=8)
    parser.add_argument("--band", type=int, default=256)
    parser.add_argument("--out", default="",
                        help="append the records to this JSON-lines file")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    import online_convex_optimization.models.ssn as ssn
    from online_convex_optimization.utils.logging_utils import log_metrics

    rng = np.random.default_rng(0)
    z = 2.0 * rng.normal(size=(args.B, args.T, 5)).astype(np.float32)
    y = np.sign(np.einsum("btd,bd->bt", z, rng.normal(size=(args.B, 5)))
                + 0.5 * rng.normal(size=(args.B, args.T))).astype(np.float32)
    y[y == 0] = 1.0
    zd, yd = jnp.asarray(z), jnp.asarray(y)

    defaults = dict(_CERT_EVERY=ssn._CERT_EVERY, _CERT_RUNGS=ssn._CERT_RUNGS,
                    _CERT_INNER=ssn._CERT_INNER,
                    _CERT_REFINE=ssn._CERT_REFINE,
                    _CERT_REFINE_FZ=ssn._CERT_REFINE_FZ,
                    _CERT_REFINE_SS=ssn._CERT_REFINE_SS,
                    _CERT_CD_SWEEPS=ssn._CERT_CD_SWEEPS)
    configs = {
        "default": {},
        "cert_1x": dict(_CERT_EVERY=200),
        "rungs_1": dict(_CERT_RUNGS=(3e-5,)),
        "refine_min": dict(_CERT_REFINE=1, _CERT_REFINE_FZ=1,
                           _CERT_REFINE_SS=1, _CERT_CD_SWEEPS=1),
        "inner_1": dict(_CERT_INNER=1),
    }

    def run_once():
        outs = []
        for b in range(args.B):
            for lo in range(0, args.T, args.band):
                X, res, _ = ssn.ssn_all_prefixes(
                    zd[b], yd[b], iters=80, tol=2e-4, band_lo=lo,
                    band_rows=args.band)
                outs.append(res)
        return np.concatenate([np.asarray(r) for r in outs])

    for name, knobs in configs.items():
        for k, v in {**defaults, **knobs}.items():
            setattr(ssn, k, v)
        ssn.ssn_all_prefixes.clear_cache()
        res = run_once()  # compile + warm
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            run_once()
            best = min(best, time.perf_counter() - t0)
        frac = float((res <= 2e-4).mean())
        rec = {"metric": f"ssn_cert_decomp_{name}_wall_s_T{args.T}",
               "value": best, "unit": "s",
               "note": (f"B={args.B} band={args.band} certified_frac="
                        f"{frac:.3f} knobs={knobs}"),
               "backend": jax.default_backend()}
        print(rec)
        if args.out:
            log_metrics(args.out, rec)
    for k, v in defaults.items():
        setattr(ssn, k, v)


if __name__ == "__main__":
    main()
