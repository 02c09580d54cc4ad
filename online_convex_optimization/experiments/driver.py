"""Experiment driver: g(T) estimation -> per-case evaluation -> figures.

Reproduces the reference pipelines (driver.py:204-226, fast_driver.py:
201-220, exact_ftl_driver.py:268-293) as one CLI with structured results:

    python -m online_convex_optimization.experiments.driver \
        --t-max 1000 --g-runs 1000 --out-dir results

Outputs in --out-dir:
  - g_emp_<key>.json          : checkpointed g(T) table (resumable)
  - results.json              : per-case mean/CI stats + config echo
  - empirical_g_T.png         : g(T) vs theory curves
  - algorithm_comparison.png  : per-case regret comparison grid
(exact mode writes *_exact.png, matching the exact driver's outputs.)
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Dict

import numpy as np

from online_convex_optimization.data.sequences import (
    CASES,
    REPLICATES_BY_TITLE,
    RUNS_BY_TITLE,
)
from online_convex_optimization.experiments.config import (
    ExperimentConfig,
    config_from_args,
)
from online_convex_optimization.experiments.evaluate import (
    evaluate_stream_exact,
    evaluate_stream_with_stats,
)
from online_convex_optimization.experiments.gt import estimate_g, estimate_g_exact
from online_convex_optimization.experiments.plotting import (
    plot_comparisons,
    plot_empirical_g,
)


def _resolve_dtype(cfg: ExperimentConfig):
    import jax
    if cfg.precision == "f32":
        return np.float32
    if cfg.precision == "x64" or jax.default_backend() == "cpu":
        jax.config.update("jax_enable_x64", True)
        return np.float64
    return np.float32


def run_experiment(cfg: ExperimentConfig) -> Dict:
    from online_convex_optimization.utils.logging_utils import (
        get_logger, log_metrics)
    from online_convex_optimization.utils import telemetry
    log = get_logger()
    telemetry.install()  # count compiles from here on
    compile_base = telemetry.compile_stats()
    t_start = time.time()
    dtype = _resolve_dtype(cfg)
    os.makedirs(cfg.out_dir, exist_ok=True)
    log.info("experiment start: exact=%s T_grid=%s g_runs=%d dtype=%s",
             cfg.exact, cfg.T_grid, cfg.g_runs, np.dtype(dtype).name)
    suffix = "_exact" if cfg.exact else ""
    cache = (os.path.join(cfg.out_dir, f"g_emp_{cfg.g_cache_key()}.json")
             if cfg.checkpoint else None)

    # 1) empirical g(T)
    if cfg.exact and cfg.exact_solver in ("auto", "xla"):
        # Pre-compile the deterministic families' fallback ADMM program
        # in a daemon thread: the certified path keeps the main thread
        # host-bound meanwhile, so the compile overlaps instead of
        # serializing (evaluate.warm_exact_fallback).
        import threading

        from online_convex_optimization.experiments.evaluate import (
            warm_exact_fallback)
        threading.Thread(
            target=lambda: warm_exact_fallback(
                max(cfg.T_grid), norm=cfg.norm, iters=cfg.exact_iters,
                dtype=dtype),
            daemon=True).start()
    if cfg.exact:
        g_emp = estimate_g_exact(cfg.T_grid, runs=cfg.g_runs,
                                 base_seed=cfg.base_seed, eta0=cfg.eta0,
                                 norm=cfg.norm, iters=cfg.exact_iters,
                                 dtype=dtype, cache_path=cache,
                                 solver=cfg.exact_solver)
        g_title = "Empirical worst-case g(T) for SMART (exact FTRL)"
    else:
        g_emp = estimate_g(cfg.T_grid, runs=cfg.g_runs,
                           base_seed=cfg.base_seed, eta0=cfg.eta0,
                           dtype=dtype, chunk=cfg.batch_chunk,
                           cache_path=cache, check=cfg.check)
        g_title = "Empirical worst-case g(T) for SMART (ALG_WC = FTRL)"

    plot_empirical_g(cfg.T_grid, g_emp,
                     out_path=os.path.join(cfg.out_dir,
                                           f"empirical_g_T{suffix}.png"),
                     title=g_title, dpi=cfg.dpi)

    # 2) per-case evaluation (optionally under a jax.profiler trace)
    import contextlib

    from online_convex_optimization.utils.profiling import trace
    prof = trace(cfg.profile_dir) if cfg.profile_dir else (
        contextlib.nullcontext())
    titles = cfg.cases or tuple(CASES)
    stats_by_case = {}
    audit_by_case = {}
    eff_runs, eff_reps = {}, {}
    with prof:
        for title in titles:
            builder = CASES[title]
            runs = cfg.runs_override or RUNS_BY_TITLE.get(title, 1)
            reps = cfg.replicates_override or REPLICATES_BY_TITLE.get(title, 1)
            eff_runs[title], eff_reps[title] = runs, reps
            if cfg.exact:
                audit_by_case[title] = {}
                stats_by_case[title] = evaluate_stream_exact(
                    builder, cfg.T_grid, runs=runs, replicates=reps,
                    base_seed=cfg.base_seed, eta0=cfg.eta0, norm=cfg.norm,
                    iters=cfg.exact_iters, dtype=dtype, stream_name=title,
                    solver=cfg.exact_solver,
                    selection=cfg.exact_selection,
                    audit_out=audit_by_case[title])
            else:
                stats_by_case[title] = evaluate_stream_with_stats(
                    builder, cfg.T_grid, g_emp, runs=runs, replicates=reps,
                    base_seed=cfg.base_seed, eta0=cfg.eta0, dtype=dtype,
                    batch_chunk=cfg.batch_chunk, stream_name=title)

    plot_comparisons(
        cfg.T_grid, stats_by_case,
        out_path=os.path.join(cfg.out_dir,
                              f"algorithm_comparison{suffix}.png"),
        runs_by_title=eff_runs, reps_by_title=eff_reps,
        suptitle=("Exact FTL vs FTRL" if cfg.exact
                  else "Online Linear Binary Classification"),
        dpi=cfg.dpi)

    # 3) structured results.  device: which device ran this, and the
    # compile count/seconds of this run (set-up, not compute).
    results = {
        "config": dataclasses.asdict(cfg),
        "wall_s": time.time() - t_start,
        "device": telemetry.snapshot(since=compile_base),
        "g_emp": {str(k): v for k, v in g_emp.items()},
        "stats": {
            title: {k: {"mean": list(map(float, m)), "ci": list(map(float, c))}
                    for k, (m, c) in stats.items()}
            for title, stats in stats_by_case.items()
        },
    }
    if cfg.exact:
        # Solver-path audit (VERDICT round-2 task 8): how every cell was
        # produced — certified closed form vs general solver — plus
        # replicate escalation/recovery/drop counts.
        results["audit"] = audit_by_case
    with open(os.path.join(cfg.out_dir, f"results{suffix}.json"), "w") as f:
        json.dump(results, f, indent=1)
    log.info("experiment done in %.1fs -> %s", results["wall_s"],
             cfg.out_dir)
    log_metrics(os.path.join(cfg.out_dir, "metrics.jsonl"), {
        "event": "experiment_done", "exact": cfg.exact,
        "wall_s": results["wall_s"], "g_runs": cfg.g_runs,
        "cases": list(results["stats"])})
    return results


def main(argv=None) -> None:
    from online_convex_optimization.utils import compile_cache
    compile_cache.enable()
    cfg = config_from_args(argv)
    results = run_experiment(cfg)
    print(f"done in {results['wall_s']:.1f}s -> {cfg.out_dir}/")


if __name__ == "__main__":
    main()
