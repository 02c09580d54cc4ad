"""Experiment configuration tree with CLI overrides.

The reference freezes all configuration in dataclass defaults with no CLI
(driver.py:47-51, exact_ftl_driver.py:41-49; SURVEY.md §5 "config/flag
system").  Here the same knobs are one dataclass with an argparse front-end,
and hyperparameters that were constants (eta0, threshold rule, norm) are
explicit fields.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    # Horizon grid: arange(100, 1100, 100) in the reference (driver.py:49).
    t_min: int = 100
    t_max: int = 1000
    t_step: int = 100
    base_seed: int = 0
    g_runs: int = 1000            # driver.py:51 (exact driver: 200)
    eta0: float = math.sqrt(2.0)  # driver.py:102
    cases: Tuple[str, ...] = ()   # empty = all registry cases
    runs_override: Optional[int] = None
    replicates_override: Optional[int] = None
    precision: str = "auto"       # auto: x64 on CPU, f32 on the GPU
    exact: bool = False           # exact-FTL comparison mode (exact driver)
    exact_iters: int = 2000
    # Exact device solver: "auto"/"xla" = banded XLA ADMM (see the CLI
    # help for "linear" and "ssn").
    exact_solver: str = "auto"
    exact_selection: str = "canonical"  # degenerate-optima selection:
    #   "canonical" (default) = min-l2-norm contract (models/canonical.py,
    #   docs/DESIGN.md): host-side LP-verified closed forms + T_max-prefix
    #   dedup on the deterministic families (no device solves, and
    #   host-f64 scoring that matches the golden oracle exactly);
    #   "committed" = historical solver selection, reproduces the
    #   round-3 artifact bitwise
    norm: str = "l2"              # exact oracle ball (exact_ftl.py:72)
    out_dir: str = "results"
    dpi: int = 600                # matches the reference (driver.py:158)
    checkpoint: bool = True
    batch_chunk: int = 4096       # max sequences per device batch
    # checkify NaN/inf guards in the compute paths, on by default
    # (scripts/checkify_pricing.py prices the guard on the g(T) sweep hot
    # call); --no-check turns it off.
    check: bool = True
    profile_dir: str = ""         # write a jax.profiler trace of the eval

    @property
    def T_grid(self) -> Tuple[int, ...]:
        return tuple(range(self.t_min, self.t_max + 1, self.t_step))

    def g_cache_key(self) -> str:
        fields = {
            "t": list(self.T_grid), "seed": self.base_seed,
            "runs": self.g_runs, "eta0": self.eta0,
            "precision": self.precision, "exact": self.exact,
            "norm": self.norm if self.exact else None,
            "iters": self.exact_iters if self.exact else None,
        }
        if self.exact:  # plain-pipeline keys predate (and ignore) this
            fields["solver"] = self.exact_solver
        payload = json.dumps(fields, sort_keys=True)
        return hashlib.sha1(payload.encode()).hexdigest()[:12]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="oco",
        description="Online convex optimization experiments (JAX)")
    d = ExperimentConfig()
    p.add_argument("--t-min", type=int, default=d.t_min)
    p.add_argument("--t-max", type=int, default=d.t_max)
    p.add_argument("--t-step", type=int, default=d.t_step)
    p.add_argument("--base-seed", type=int, default=d.base_seed)
    p.add_argument("--g-runs", type=int, default=d.g_runs)
    p.add_argument("--eta0", type=float, default=d.eta0)
    p.add_argument("--cases", nargs="*", default=None,
                   help="subset of case titles (default: all)")
    p.add_argument("--runs", type=int, default=None,
                   help="override per-case run count")
    p.add_argument("--replicates", type=int, default=None,
                   help="override per-case replicate count")
    p.add_argument("--precision", choices=["auto", "x64", "f32"],
                   default=d.precision)
    p.add_argument("--exact", action="store_true",
                   help="exact-FTL comparison mode (exact_ftl_driver.py)")
    p.add_argument("--exact-iters", type=int, default=d.exact_iters)
    p.add_argument("--exact-solver",
                   choices=["auto", "linear", "xla", "ssn"],
                   default=d.exact_solver,
                   help="exact solve: auto = certified closed form where "
                        "the optimality certificate holds, banded XLA ADMM "
                        "otherwise; linear = require the certificate; "
                        "xla = force the banded ADMM; ssn = force "
                        "the semismooth-Newton band solver (l2; g(T) "
                        "estimation still uses the ADMM comparator solves)")
    p.add_argument("--exact-selection", choices=["committed", "canonical"],
                   default=d.exact_selection,
                   help="degenerate-optima selection contract: committed = "
                        "historical (bitwise-pinned artifacts); canonical = "
                        "min-l2-norm point of the optimal face, "
                        "solver-independent, host-side closed forms + "
                        "T_max dedup on deterministic families")
    p.add_argument("--norm", choices=["l2", "linf", "l1"], default=d.norm)
    p.add_argument("--out-dir", default=d.out_dir)
    p.add_argument("--dpi", type=int, default=d.dpi)
    p.add_argument("--no-checkpoint", action="store_true")
    p.add_argument("--batch-chunk", type=int, default=d.batch_chunk)
    p.add_argument("--check", action="store_true", default=d.check,
                   dest="check",
                   help="checkify NaN/inf guards inside the compute paths "
                        "(default: on)")
    p.add_argument("--no-check", action="store_false", dest="check",
                   help="disable the checkify guards explicitly")
    p.add_argument("--profile-dir", default="",
                   help="capture a jax.profiler trace of the evaluation")
    return p


def config_from_args(argv: Optional[Sequence[str]] = None) -> ExperimentConfig:
    args = build_parser().parse_args(argv)
    return ExperimentConfig(
        t_min=args.t_min, t_max=args.t_max, t_step=args.t_step,
        base_seed=args.base_seed, g_runs=args.g_runs, eta0=args.eta0,
        cases=tuple(args.cases) if args.cases else (),
        runs_override=args.runs, replicates_override=args.replicates,
        precision=args.precision, exact=args.exact,
        exact_iters=args.exact_iters,
        exact_solver=args.exact_solver,
        exact_selection=args.exact_selection, norm=args.norm,
        out_dir=args.out_dir, dpi=args.dpi,
        checkpoint=not args.no_checkpoint, batch_chunk=args.batch_chunk,
        check=args.check, profile_dir=args.profile_dir)
