"""Figure generation reproducing the reference's two plot types.

  - empirical g(T) vs sqrt(T/pi) and sqrt(2T)      : driver.py:142-159
  - per-case algorithm comparison grid with CI bands : driver.py:162-197

Figures are regenerated from saved structured results (results.json), not
recomputed — the reference couples computation and plotting; here they are
separate stages.  matplotlib is optional: without it every figure is
skipped with a log line and the JSON results are unaffected.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np

def pyplot():
    """matplotlib's pyplot on the Agg backend, or None when matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _skipped(out_path: str) -> bool:
    from online_convex_optimization.utils.logging_utils import get_logger
    get_logger().info("matplotlib is not installed: skipped figure %s",
                      out_path)
    return False


LABELS = {
    "FTRL": "FTRL",
    "FTL": "FTL",
    "SMART": "SMART (√2T)",
    "EMP": "SMART (empirical g)",
}


def _plot_with_ci(ax, x, mean, ci, label):
    """Mean curve with a 95%-CI band (band layout mirrors the reference
    figures, driver.py:134-139, which output-parity pins)."""
    mean = np.asarray(mean, dtype=float)
    ci = np.asarray(ci, dtype=float)
    (line,) = ax.plot(x, mean, label=label)
    if np.any(ci > 0.0):
        ax.fill_between(x, mean - ci, mean + ci, alpha=0.2, linewidth=0,
                        color=line.get_color())


def plot_empirical_g(T_grid, g_emp: Mapping[int, float], *,
                     out_path: str = "empirical_g_T.png",
                     title: str = "Empirical worst-case g(T) for SMART (ALG_WC = FTRL)",
                     dpi: int = 600) -> bool:
    """Write the g(T) figure; False (and a log line) without matplotlib."""
    plt = pyplot()
    if plt is None:
        return _skipped(out_path)
    T_grid = [int(t) for t in T_grid]
    plt.figure(figsize=(7.5, 5.0))
    g_vals = [float(g_emp[t]) for t in T_grid]
    plt.plot(T_grid, g_vals, marker="o", label="Empirical g(T)")
    plt.plot(T_grid, [math.sqrt(t / math.pi) for t in T_grid],
             linestyle="--", label=r"$\sqrt{T/\pi}$")
    plt.plot(T_grid, [math.sqrt(2 * t) for t in T_grid],
             marker="x", label=r"$\sqrt{2T}$")
    plt.title(title, fontsize=18)
    plt.xlabel("T rounds", fontsize=16)
    plt.ylabel("g(T)", fontsize=16)
    plt.legend(prop={"size": 14})
    plt.tight_layout()
    plt.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close()
    return True


def plot_comparisons(T_grid,
                     stats_by_case: Dict[str, Dict[str, Tuple[np.ndarray, np.ndarray]]],
                     *,
                     out_path: str = "algorithm_comparison.png",
                     runs_by_title: Mapping[str, int] = None,
                     reps_by_title: Mapping[str, int] = None,
                     suptitle: str = "Online Linear Binary Classification",
                     dpi: int = 600) -> bool:
    """Write the comparison grid; False (and a log line) without
    matplotlib."""
    plt = pyplot()
    if plt is None:
        return _skipped(out_path)
    T_grid = [int(t) for t in T_grid]
    n_cases = len(stats_by_case)
    cols = 2
    rows = int(math.ceil(n_cases / cols))
    fig, axes = plt.subplots(rows, cols, figsize=(12, 4.0 * rows),
                             squeeze=False)
    axes = axes.flatten()

    for idx, (title, stats) in enumerate(stats_by_case.items()):
        ax = axes[idx]
        for key, (mean, ci) in stats.items():
            _plot_with_ci(ax, T_grid, mean, ci, LABELS.get(key, key))
        runs = (runs_by_title or {}).get(title, 1)
        reps = (reps_by_title or {}).get(title, 1)
        ax.set_title(f"{title} (runs={runs}, reps/T={reps})", fontsize=16)
        ax.set_xlabel("T rounds", fontsize=14)
        ax.set_ylabel("Cumulative regret", fontsize=14)
        ax.legend(prop={"size": 12})

    for j in range(n_cases, rows * cols):
        axes[j].axis("off")

    fig.suptitle(suptitle, fontsize=20)
    fig.tight_layout()
    plt.savefig(out_path, dpi=dpi, bbox_inches="tight")
    plt.close()
    return True
