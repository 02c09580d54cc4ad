"""Empirical worst-case g(T) estimation with artifact checkpointing.

Reference behavior: algorithms.py:135-171 — per T, run `g_runs` FTRL
simulations sequentially and keep the max regret; recomputed from scratch
on every invocation (SURVEY.md §5 "checkpoint/resume: absent").

Here: all runs of a horizon execute as one (chunked) device batch, and the
per-T maxima are checkpointed to a JSON artifact keyed by the config hash,
so interrupted sweeps resume and downstream SMART-EMP evaluation can reuse
the table without recomputation.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

import numpy as np

from online_convex_optimization.data.sequences import (
    sample_g_batch,
    sample_g_instance,
)
from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.utils.debug import checked


def _load_g_cache(cache_path: Optional[str], key: dict) -> Dict[int, float]:
    """Resume a {T: g} table from ``cache_path`` iff its recorded
    provenance matches ``key`` (the value-determining config: seeds,
    run count, eta0, dtype, ...).  Silently resuming an artifact
    produced under a DIFFERENT config would mix incomparable maxima
    (round-2 ADVICE), so a mismatch recomputes from scratch with a
    warning.  Legacy artifacts without a ``_meta`` entry are accepted
    (the committed results/ tables predate provenance) but warned
    about; they gain provenance on the next write."""
    if not (cache_path and os.path.exists(cache_path)):
        return {}
    import logging
    with open(cache_path) as f:
        data = json.load(f)
    meta = data.pop("_meta", None)
    if meta is None:
        logging.getLogger("oco").warning(
            "g(T) cache %s has no provenance (_meta); assuming it matches "
            "the current config", cache_path)
    elif meta.get("key") != key:
        logging.getLogger("oco").warning(
            "g(T) cache %s provenance mismatch (cached %s != current %s); "
            "recomputing from scratch", cache_path, meta.get("key"), key)
        return {}
    return {int(k): float(v) for k, v in data.items()}


def _save_g_cache(cache_path: str, g: Dict[int, float], key: dict,
                  info: dict) -> None:
    """Write the table with its provenance: ``key`` is the
    value-determining config compared on resume; ``info`` records
    additional context (solver, iteration caps) for auditability."""
    os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
    payload: dict = {str(k): v for k, v in sorted(g.items())}
    # Device and cumulative process compile count/seconds at write
    # time, so a slow g sweep is attributable to compiles after the fact.
    from online_convex_optimization.utils import telemetry
    payload["_meta"] = {"key": key, "info": info,
                        "device": telemetry.snapshot()}
    with open(cache_path, "w") as f:
        json.dump(payload, f, indent=1)

def _g_for_T(T: int, runs: int, base_seed: int, eta0: float, dtype,
             chunk: int, check: bool = False, T_pad: int = 0) -> float:
    # check=True checkify-wraps the simulator so NaN/inf inside the scan
    # surfaces as a located error instead of silently propagating into the
    # max reduction (utils.debug.checked; SURVEY §5 sanitizers).
    # T_pad > T zero-pads every horizon to one shape so the whole T grid
    # shares ONE compile (zero rows are loss/gradient-inert).
    sim = (checked(lambda zz, yy: simulate_linear_batch(zz, yy, 0, eta0))
           if check else (lambda zz, yy: simulate_linear_batch(zz, yy, 0,
                                                               eta0)))
    T_pad = max(T_pad, T)
    max_regret = 0.0
    for start in range(0, runs, chunk):
        n = min(chunk, runs - start)
        z = np.zeros((n, T_pad, 5), dtype=dtype)
        y = np.zeros((n, T_pad), dtype=dtype)
        for i in range(n):
            z[i, :T], y[i, :T] = sample_g_instance(base_seed, T, start + i,
                                                   dtype=dtype)
        res = sim(z, y)
        max_regret = max(max_regret, float(np.max(np.asarray(res.regret))))
    return max_regret

def estimate_g(
    T_grid,
    *,
    runs: int,
    base_seed: int = 0,
    eta0: float = math.sqrt(2.0),
    dtype=np.float64,
    chunk: int = 4096,
    cache_path: Optional[str] = None,
    progress: bool = True,
    check: bool = False,
) -> Dict[int, float]:
    """g(T) table, resuming from ``cache_path`` when its provenance
    matches (see _load_g_cache)."""
    from online_convex_optimization.utils import telemetry
    telemetry.install()
    meta_key = {"kind": "g_plain", "runs": int(runs),
                "base_seed": int(base_seed), "eta0": float(eta0),
                "dtype": np.dtype(dtype).name}
    g = _load_g_cache(cache_path, meta_key)

    todo = [int(t) for t in T_grid if int(t) not in g]
    iterator = todo
    if progress and todo:
        try:
            from tqdm import tqdm
            iterator = tqdm(todo, desc="Estimating g(T) on random sequences")
        except ImportError:
            pass

    # ---- pipelined sweep (VERDICT r4 task 3, applied to g too) ----
    # The per-(T, chunk) work used to serialize host PCG64 generation ->
    # host->device transfer -> device scan -> fetch.
    # Now the NEXT work item's generation + async device_put overlap the
    # current item's device scan; values are bit-identical (same per-
    # chunk simulate_linear_batch program on the same bits, same max
    # accumulation order, same 0.0 max baseline as _g_for_T).
    import jax

    T_pad = max(int(t) for t in T_grid)
    sim = (checked(lambda zz, yy: simulate_linear_batch(zz, yy, 0, eta0))
           if check else (lambda zz, yy: simulate_linear_batch(zz, yy, 0,
                                                               eta0)))
    items = [(T, start, min(chunk, runs - start))
             for T in todo for start in range(0, runs, chunk)]

    def _prep(item):
        T, start, n = item
        z = np.zeros((n, T_pad, 5), dtype=dtype)
        y = np.zeros((n, T_pad), dtype=dtype)
        for i in range(n):
            z[i, :T], y[i, :T] = sample_g_instance(base_seed, T, start + i,
                                                   dtype=dtype)
        return jax.device_put(z), jax.device_put(y)

    done_iter = iter(iterator)  # drive the tqdm bar as horizons finish
    partial: Dict[int, float] = {}
    pending = _prep(items[0]) if items else None
    for i, (T, start, n) in enumerate(items):
        zd, yd = pending
        res = sim(zd, yd)                      # async dispatch
        if i + 1 < len(items):
            pending = _prep(items[i + 1])      # overlaps the device scan
        m = float(np.max(np.asarray(res.regret)))
        partial[T] = max(partial.get(T, 0.0), m)
        if start + n >= runs:                  # horizon complete
            g[T] = partial.pop(T)
            next(done_iter, None)
            if cache_path:
                _save_g_cache(cache_path, g, meta_key,
                              {"chunk": int(chunk), "check": bool(check)})

    return {int(t): g[int(t)] for t in T_grid}

def estimate_g_exact(
    T_grid,
    *,
    runs: int,
    base_seed: int = 0,
    eta0: float = math.sqrt(2.0),
    norm: str = "l2",
    iters: int = 2000,
    dtype=np.float64,
    cache_path: Optional[str] = None,
    progress: bool = True,
    solver: str = "auto",
) -> Dict[int, float]:
    """g(T) with the exact comparator (exact_ftl_driver.py:64-117):
    regret = FTRL cum_loss - loss of the exact full-sequence minimizer.

    ``solver='auto'`` first computes each run's comparator via the
    CERTIFIED closed form (models/linear_regime.py — the g sampler's data
    is contract data: clipped rows, +-1 labels, so the exact program is
    linear); only uncertified runs fall through to the device ADMM.
    ``solver='linear'`` raises on an uncertified run; any other value
    forces the general ADMM for every run."""
    import jax
    import jax.numpy as jnp

    from online_convex_optimization.models.exact_ftl import _admm_full
    from online_convex_optimization.models.linear_regime import (
        certified_full_solution_batch)
    from online_convex_optimization.models.polish import polish_solution

    try_linear = solver in ("auto", "linear")

    from online_convex_optimization.utils import telemetry
    telemetry.install()
    meta_key = {"kind": "g_exact", "runs": int(runs),
                "base_seed": int(base_seed), "eta0": float(eta0),
                "norm": norm, "dtype": np.dtype(dtype).name}
    meta_info = {"solver": solver, "iters": int(iters)}
    g = _load_g_cache(cache_path, meta_key)

    todo = [int(t) for t in T_grid if int(t) not in g]
    iterator = todo
    if progress and todo:
        try:
            from tqdm import tqdm
            iterator = tqdm(todo, desc="Estimating g(T) with exact FTRL")
        except ImportError:
            pass

    solve = jax.jit(jax.vmap(
        lambda zz, yy: _admm_full(zz, yy, norm=norm, iters=iters,
                                  tol=2e-4)))
    # Escalation solver for chunks with unconverged solves: warm-CONTINUES
    # from the first attempt's state with 2x more budget (3x total
    # ceiling, no redone iterations).  Recovered runs stay candidates for
    # the max instead of dropping (a diverged run COULD have been the
    # worst case).
    solve_hard = jax.jit(jax.vmap(
        lambda zz, yy, st: _admm_full(zz, yy, norm=norm, iters=2 * iters,
                                      tol=2e-4, state0=st)))
    T_max = max(int(t) for t in T_grid)

    for T in iterator:
        z, y = sample_g_batch(base_seed, T, runs, dtype=dtype)
        # Zero-pad to T_max: padded rows are inert in both the FTRL game
        # and the exact solve, so one compiled shape serves the whole grid.
        if T < T_max:
            z = np.concatenate(
                [z, np.zeros((runs, T_max - T, z.shape[2]), z.dtype)], axis=1)
            y = np.concatenate(
                [y, np.zeros((runs, T_max - T), y.dtype)], axis=1)
        if try_linear:
            # Host f64 FTRL, the reference exact driver's own arithmetic
            # (exact_ftl.py:230-277 runs its loop in f64 NumPy): no device
            # work at all when every comparator certifies.
            from online_convex_optimization.experiments.evaluate import (
                _host_ftrl_cum_loss)
            cum = _host_ftrl_cum_loss(z[:, :T], y[:, :T], eta0)
        else:
            cum = np.asarray(simulate_linear_batch(z, y, 0, eta0).cum_loss)
        max_regret = 0.0
        chunk = 50  # divides the reference's 200-run default: one shape
        for start in range(0, runs, chunk):
            n = min(chunk, runs - start)
            x_np = np.full((n, z.shape[2]), np.nan)
            ok_mask = np.zeros(n, bool)
            if try_linear:
                # Certified closed-form comparators (exact, no polish
                # needed); only the uncertified remainder hits the device.
                # Certified on the true-horizon slice (padded rows inert).
                x_lin, ok_lin = certified_full_solution_batch(
                    z[start:start + chunk, :T], y[start:start + chunk, :T],
                    norm)
                x_np[ok_lin] = x_lin[ok_lin]
                ok_mask |= ok_lin
                if solver == "linear" and not ok_lin.all():
                    raise RuntimeError(
                        "solver='linear': uncertified g(T) run at "
                        f"T={T}, chunk={start}")
            need = ~ok_mask
            if need.any():
                # Device ADMM for the uncertified runs (whole chunk: one
                # compiled shape; certified members' results are ignored).
                zc = jnp.asarray(z[start:start + chunk])
                yc = jnp.asarray(y[start:start + chunk])
                x_c, res, st = solve(zc, yc)        # (n, d), (n,), state
                # Failure containment (SURVEY §5): a diverged solve becomes
                # a NaN sentinel dropped from the max, never an exception
                # inside the sweep; drop_nonfinite_stats reports the loss.
                x_dev = np.array(x_c, np.float64)
                ok_dev = np.asarray(res) <= 1e-3
                if not (ok_dev | ~need).all():
                    x2, res2, _ = solve_hard(zc, yc, st)
                    x2 = np.array(x2, np.float64)
                    ok2 = np.asarray(res2) <= 1e-3
                    take = (~ok_dev) & ok2
                    x_dev[take] = x2[take]
                    ok_dev = ok_dev | ok2
                del st
                for i in np.flatnonzero(need & ok_dev):  # host polish
                    x_dev[i] = polish_solution(z[start + i], y[start + i],
                                               x_dev[i], norm)
                    x_np[i] = x_dev[i]
                ok_mask |= need & ok_dev
            # Comparator losses in host f64 (x is host f64 either way).
            zh = np.asarray(z[start:start + chunk, :T], np.float64)
            yh = np.asarray(y[start:start + chunk, :T], np.float64)
            comp = 0.5 * np.abs(
                np.einsum("ntd,nd->nt", zh, x_np) - yh).sum(axis=-1)
            regs = cum[start:start + chunk] - comp
            # NaN-sentinel containment (SURVEY §5), host-side: regs is
            # host data here, and eager jnp ops would each be a device
            # dispatch and a host fetch.
            finite = np.isfinite(regs)
            n_ok = int(finite.sum())
            if n_ok < regs.shape[0]:
                import logging
                logging.getLogger("oco").warning(
                    "estimate_g_exact T=%d: dropped %d/%d diverged solves",
                    T, regs.shape[0] - n_ok, regs.shape[0])
            if n_ok:
                max_regret = max(max_regret, float(regs[finite].max()))
        g[T] = max_regret
        if cache_path:
            _save_g_cache(cache_path, g, meta_key, meta_info)

    return {int(t): g[int(t)] for t in T_grid}
