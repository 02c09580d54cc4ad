"""Quadratic-loss track study (BASELINE config 1): regret vs T for exact
ball-constrained least-squares FTL and FTRL on the regression stream.

The reference has no quadratic driver (config 1 is a BASELINE-only
target); this study gives the track the same experiment surface as the
hinge pipelines: padded one-compile batches over a horizon grid, the
reference aggregation (replicate mean per run, mean +- 1.96*SEM across
runs), a JSON artifact with provenance, and a figure.

Run:  python -m online_convex_optimization.experiments.quadratic_study
          --t-max 2000 --runs 5 --replicates 4 --out-dir results
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Tuple

import numpy as np

from online_convex_optimization.data.rng import run_seed_schedule
from online_convex_optimization.data.sequences import (
    make_regression_stream,
    stack_replicates,
)
from online_convex_optimization.utils.logging_utils import (
    get_logger,
    log_metrics,
)
from online_convex_optimization.utils.stats import mean_ci

LABELS = ("FTRL", "FTL (exact LS)")


def evaluate_quadratic_stream(
    T_grid,
    *,
    runs: int = 5,
    replicates: int = 4,
    base_seed: int = 0,
    eta0: float = 1.0,
    sigma: float = 0.1,
    d: int = 5,
    dtype=np.float32,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Regret statistics for the quadratic track on the regression
    stream.  Zero-padding horizons to max(T_grid) is inert (padded
    rounds lose 0.5*(0-0)^2 = 0 and leave the comparator's carried
    (A, b, c) statistics untouched), so ONE compiled shape serves the
    whole grid — the same discipline as the hinge evaluators."""
    import jax.numpy as jnp

    from online_convex_optimization.models.quadratic import (
        simulate_quadratic_batch)

    T_grid = [int(t) for t in T_grid]
    T_max = max(T_grid)
    by_T = {k: np.empty((runs, len(T_grid), replicates)) for k in LABELS}
    for run in range(runs):
        sampler = make_regression_stream(
            sigma=sigma, d=d, run_seed=run_seed_schedule(base_seed, run))
        for ti, T in enumerate(T_grid):
            z, y = stack_replicates(sampler, T, replicates, dtype=dtype)
            if T < T_max:
                z = np.concatenate(
                    [z, np.zeros((replicates, T_max - T, d), z.dtype)], 1)
                y = np.concatenate(
                    [y, np.zeros((replicates, T_max - T), y.dtype)], 1)
            zj, yj = jnp.asarray(z), jnp.asarray(y)
            # Both algorithms ride one batched call via the flag vector.
            z2 = jnp.concatenate([zj, zj])
            y2 = jnp.concatenate([yj, yj])
            flags = jnp.concatenate([jnp.zeros(replicates, jnp.int32),
                                     jnp.ones(replicates, jnp.int32)])
            res = simulate_quadratic_batch(z2, y2, flags, eta0)
            reg = np.asarray(res.regret)
            by_T["FTRL"][run, ti] = reg[:replicates]
            by_T["FTL (exact LS)"][run, ti] = reg[replicates:]

    stats: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for k in LABELS:
        run_means = np.nanmean(by_T[k], axis=2)
        means, cis = [], []
        for ti in range(len(T_grid)):
            mu, ci = mean_ci(run_means[:, ti])
            means.append(mu)
            cis.append(ci)
        stats[k] = (np.asarray(means), np.asarray(cis))
    return stats


def plot_quadratic(T_grid, stats, *, out_path: str, dpi: int = 150) -> bool:
    """Write the figure; False (and a log line) without matplotlib."""
    from online_convex_optimization.experiments.plotting import (
        _skipped, pyplot)
    plt = pyplot()
    if plt is None:
        return _skipped(out_path)
    fig, ax = plt.subplots(figsize=(7, 4.5))
    x = np.asarray(T_grid, float)
    for label, (mean, ci) in stats.items():
        line = ax.plot(x, mean, marker="o", label=label)[0]
        ax.fill_between(x, mean - ci, mean + ci,
                        color=line.get_color(), alpha=0.2)
    ax.plot(x, np.log(np.maximum(x, 2.0)),
            "k--", alpha=0.5, label=r"$\log T$ guide")
    ax.set_xlabel("T")
    ax.set_ylabel("regret")
    ax.set_title("Quadratic track: exact ball-LS FTL vs FTRL "
                 "(regression stream)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=dpi)
    plt.close(fig)
    return True


@dataclasses.dataclass
class QuadraticConfig:
    t_min: int = 200
    t_max: int = 2000
    t_step: int = 200
    runs: int = 5
    replicates: int = 4
    base_seed: int = 0
    eta0: float = 1.0
    sigma: float = 0.1
    d: int = 5
    out_dir: str = "results"
    dpi: int = 150

    @property
    def T_grid(self):
        return tuple(range(self.t_min, self.t_max + 1, self.t_step))


def run_study(cfg: QuadraticConfig) -> dict:
    log = get_logger()
    t0 = time.time()
    os.makedirs(cfg.out_dir, exist_ok=True)
    stats = evaluate_quadratic_stream(
        cfg.T_grid, runs=cfg.runs, replicates=cfg.replicates,
        base_seed=cfg.base_seed, eta0=cfg.eta0, sigma=cfg.sigma, d=cfg.d)
    plot_quadratic(cfg.T_grid, stats,
                   out_path=os.path.join(cfg.out_dir,
                                         "quadratic_regret.png"),
                   dpi=cfg.dpi)
    results = {
        "config": dataclasses.asdict(cfg),
        "wall_s": time.time() - t0,
        "stats": {
            k: {"mean": [float(v) for v in m],
                "ci": [float(v) for v in c]}
            for k, (m, c) in stats.items()
        },
    }
    with open(os.path.join(cfg.out_dir, "results_quadratic.json"), "w") as f:
        json.dump(results, f, indent=1)
    log.info("quadratic study done in %.1fs -> %s", results["wall_s"],
             cfg.out_dir)
    log_metrics(os.path.join(cfg.out_dir, "metrics.jsonl"), {
        "event": "quadratic_study_done", "wall_s": results["wall_s"],
        "T_grid": list(cfg.T_grid)})
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    d = QuadraticConfig()
    p.add_argument("--t-min", type=int, default=d.t_min)
    p.add_argument("--t-max", type=int, default=d.t_max)
    p.add_argument("--t-step", type=int, default=d.t_step)
    p.add_argument("--runs", type=int, default=d.runs)
    p.add_argument("--replicates", type=int, default=d.replicates)
    p.add_argument("--base-seed", type=int, default=d.base_seed)
    p.add_argument("--eta0", type=float, default=d.eta0)
    p.add_argument("--sigma", type=float, default=d.sigma)
    p.add_argument("--d", type=int, default=d.d)
    p.add_argument("--out-dir", default=d.out_dir)
    p.add_argument("--dpi", type=int, default=d.dpi)
    a = p.parse_args(argv)
    cfg = QuadraticConfig(t_min=a.t_min, t_max=a.t_max, t_step=a.t_step,
                          runs=a.runs, replicates=a.replicates,
                          base_seed=a.base_seed, eta0=a.eta0, sigma=a.sigma,
                          d=a.d, out_dir=a.out_dir, dpi=a.dpi)
    results = run_study(cfg)
    print(f"done in {results['wall_s']:.1f}s -> {cfg.out_dir}/")


if __name__ == "__main__":
    main()
