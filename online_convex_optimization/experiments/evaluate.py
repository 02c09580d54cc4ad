"""Per-case regret evaluation: the batched replacement for the reference's
run/T/replicate nested loops (driver.py:70-129, exact_ftl_driver.py:120-206).

For one case, ALL (run, T, replicate) scenarios are evaluated as padded
device batches:

  - sequences are generated host-side with the reference's exact seed
    schedule (run_seed = base + 2025*(run+1); fresh sampler per run);
  - horizons share one compiled program via padding to T_max + length
    masks (so 10 horizon values don't mean 10 XLA compiles);
  - FTRL and FTL ride one ``simulate_linear_batch`` call with a flag
    vector; SMART(sqrt(2T)) and SMART(empirical g) ride one
    ``simulate_smart_batch`` call with a threshold vector;
  - aggregation reproduces the reference exactly: mean over replicates per
    run, then mean +- 1.96*SEM across runs (driver.py:114-127).

The EXACT mode (``evaluate_stream_exact``) additionally dispatches per
cell on the certified linear regime (models/linear_regime.py): certified
cells are solved by the closed form and scored entirely host-side in f64
(the reference exact driver's own arithmetic — no device work at all),
while uncertified cells (the deterministic w = 0 families,
out-of-contract data) run the banded device ADMM + host active-set
polish, whose one-time compile ``warm_exact_fallback`` pre-triggers
from a driver daemon thread.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import jax
import numpy as np

from online_convex_optimization.data.rng import run_seed_schedule
from online_convex_optimization.data.sequences import stack_replicates
from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.models.smart import simulate_smart_batch
from online_convex_optimization.utils.stats import mean_ci

ALGO_KEYS = ("FTRL", "FTL", "SMART", "EMP")  # driver.py:43

Stats = Dict[str, Tuple[np.ndarray, np.ndarray]]


def _host_ftrl_cum_loss(z: np.ndarray, y: np.ndarray,
                        eta0: float) -> np.ndarray:
    """Batched f64 FTRL cumulative loss with the reference's exact-driver
    semantics (/root/reference/exact_ftl.py:230-277 runs its FTRL loop in
    f64 NumPy): scale eta0/sqrt(max(1, t)), project iff ||x||^2 > 1,
    tie-exact subgradient.  Vectorized over the batch; padded (z = 0,
    y = 0) rounds are inert.  Used for CERTIFIED cells, where no device
    work remains."""
    z = np.asarray(z, np.float64)
    y = np.asarray(y, np.float64)
    B, T, d = z.shape
    theta = np.zeros((B, d))
    cum = np.zeros(B)
    for t in range(T):
        x = (-(eta0 / math.sqrt(max(1, t + 1)))) * theta
        nsq = np.einsum("bd,bd->b", x, x)
        over = nsq > 1.0
        if over.any():
            x[over] *= 1.0 / np.sqrt(nsq[over])[:, None]
        q = np.einsum("bd,bd->b", z[:, t], x)
        diff = q - y[:, t]
        cum += 0.5 * np.abs(diff)
        theta += (0.5 * np.sign(diff))[:, None] * z[:, t]
    return cum


def _pad_T(z: np.ndarray, y: np.ndarray, T_max: int):
    T = z.shape[1]
    if T == T_max:
        return z, y
    pz = np.zeros((z.shape[0], T_max, z.shape[2]), dtype=z.dtype)
    py = np.zeros((y.shape[0], T_max), dtype=y.dtype)
    pz[:, :T] = z
    py[:, :T] = y
    return pz, py


def evaluate_stream_golden(
    stream_builder: Callable,
    T_grid,
    g_emp: Mapping[int, float],
    *,
    base_seed: int = 0,
    eta0: float = math.sqrt(2.0),
) -> Stats:
    """Deterministic-family evaluation via the f64 golden oracle.

    The two adversarial families are 1 run x 1 replicate (microseconds of
    work) but ULP-DEGENERATE: z = e1 every round makes q == y exact ties
    reachable, so an f32 device evaluation can flip a tie subgradient and
    genuinely change the trajectory (observed: 0.26 regret units on
    "Switching leaders" FTRL).  The reference's figures are f64; this path
    reproduces them bit-for-bit at trivial cost.
    """
    from online_convex_optimization.testing.golden import (
        golden_simulate_alg,
        golden_simulate_smart,
    )

    sampler = stream_builder(run_seed=run_seed_schedule(base_seed, 0))
    curves = {k: [] for k in ALGO_KEYS}
    for T in (int(t) for t in T_grid):
        z, y = (np.asarray(a, np.float64) for a in sampler(T, 0)[:2])
        curves["FTRL"].append(golden_simulate_alg(z, y, 0, eta0))
        curves["FTL"].append(golden_simulate_alg(z, y, 1, eta0))
        curves["SMART"].append(
            golden_simulate_smart(z, y, math.sqrt(2.0 * T), eta0))
        curves["EMP"].append(golden_simulate_smart(z, y, g_emp[T], eta0))
    return {k: (np.asarray(v), np.zeros(len(v)))
            for k, v in curves.items()}


def _eval_chunk_on_device(zd, yd, lend, th_theory, th_emp, eta0):
    """All four algorithms on one uploaded chunk: FTRL+FTL ride one
    flag-vector linear scan, SMART(theory)+SMART(emp) one threshold-
    vector SMART scan; the [chunk, chunk] duplication happens ON DEVICE
    (eager concatenates), so the chunk's (z, y) bytes cross the host link
    once instead of four times.

    BIT-IDENTITY: the two simulators are invoked as the SAME two jitted
    programs the pre-r5 loop compiled (not merged into one jit — a
    merged program fuses differently and perturbs f32 reduction order by
    ~1 ulp, measured).  Identical programs on identical operand bits =>
    identical statistics; only the transfer path changed."""
    import jax.numpy as jnp

    n = zd.shape[0]
    z2 = jnp.concatenate([zd, zd])
    y2 = jnp.concatenate([yd, yd])
    len2 = jnp.concatenate([lend, lend])
    flags = jnp.concatenate([jnp.zeros(n, jnp.int32),
                             jnp.ones(n, jnp.int32)])
    lin = simulate_linear_batch(z2, y2, flags, eta0, len2)
    th2 = jnp.concatenate([th_theory, th_emp])
    sm = simulate_smart_batch(z2, y2, th2, eta0, len2)
    return lin.regret, sm.regret


def evaluate_stream_with_stats(
    stream_builder: Callable,
    T_grid,
    g_emp: Mapping[int, float],
    *,
    runs: int = 1,
    replicates: int = 1,
    base_seed: int = 0,
    eta0: float = math.sqrt(2.0),
    dtype=np.float64,
    batch_chunk: int = 4096,
    stream_name: str = "",
    progress: bool = True,
) -> Stats:
    """Mean regret and 95% CI per algorithm per horizon for one case."""
    if runs == 1 and replicates == 1 and np.dtype(dtype) != np.float64:
        # Deterministic family on an f32 backend: route to the f64 golden
        # oracle (see evaluate_stream_golden — tie-degenerate sequences).
        return evaluate_stream_golden(stream_builder, T_grid, g_emp,
                                      base_seed=base_seed, eta0=eta0)
    T_grid = [int(t) for t in T_grid]
    T_max = max(T_grid)

    # ---- build the full scenario batch host-side (seed-exact) ----
    all_z, all_y, all_len, all_T = [], [], [], []
    for run in range(runs):
        sampler = stream_builder(run_seed=run_seed_schedule(base_seed, run))
        for T in T_grid:
            z, y = stack_replicates(sampler, T, replicates, dtype=dtype)
            z, y = _pad_T(z, y, T_max)
            all_z.append(z)
            all_y.append(y)
            all_len.extend([T] * replicates)
            all_T.extend([T] * replicates)
    z = np.concatenate(all_z)                 # (B, T_max, d)
    y = np.concatenate(all_y)                 # (B, T_max)
    lengths = np.asarray(all_len)
    B = z.shape[0]

    thresh_theory = np.sqrt(2.0 * lengths).astype(dtype)
    thresh_emp = np.asarray([g_emp[t] for t in all_T], dtype=dtype)

    # ---- batched device evaluation (chunked, double-buffered) ----
    # Transfer discipline (VERDICT r4 task 3): the old loop host-
    # concatenated [chunk, chunk] and passed the doubled arrays to BOTH
    # the linear and the SMART call — 4x the chunk's z bytes through the
    # host link, serially between compute calls.  Now each chunk's
    # (z, y) crosses ONCE via an explicit async device_put, the
    # FTRL/FTL + SMART duplication happens on device inside one jitted
    # program, and the NEXT chunk's upload is issued before blocking on
    # the current chunk's results, so transfer overlaps compute.
    # Bitwise-neutral: the per-sequence scan arithmetic is unchanged
    # (verified against the committed full-scale artifact).
    regrets = {k: np.empty(B) for k in ALGO_KEYS}
    starts = list(range(0, B, batch_chunk))
    iterator = starts
    if progress and B > batch_chunk:
        try:
            from tqdm import tqdm
            iterator = tqdm(starts, desc=f"{stream_name:>24} | B={B}")
        except ImportError:
            pass

    def _put(s):
        e = min(s + batch_chunk, B)
        return (jax.device_put(z[s:e]), jax.device_put(y[s:e]),
                jax.device_put(lengths[s:e]),
                jax.device_put(thresh_theory[s:e]),
                jax.device_put(thresh_emp[s:e]))

    pending = _put(0) if starts else None
    for i, s in enumerate(iterator):
        e = min(s + batch_chunk, B)
        n = e - s
        zd, yd, lend, thd, emd = pending
        lin_reg_d, sm_reg_d = _eval_chunk_on_device(zd, yd, lend, thd, emd,
                                                    eta0)
        # Issue the next chunk's transfer while this chunk computes.
        if i + 1 < len(starts):
            pending = _put(starts[i + 1])
        lin_reg = np.asarray(lin_reg_d)
        sm_reg = np.asarray(sm_reg_d)
        regrets["FTRL"][s:e] = lin_reg[:n]
        regrets["FTL"][s:e] = lin_reg[n:]
        regrets["SMART"][s:e] = sm_reg[:n]
        regrets["EMP"][s:e] = sm_reg[n:]

    # ---- failure containment (SURVEY §5): a non-finite scenario result
    # becomes a dropped sentinel, never a poisoned mean ----
    n_bad = sum(int((~np.isfinite(regrets[k])).sum()) for k in ALGO_KEYS)
    if n_bad:
        import logging
        logging.getLogger("oco").warning(
            "evaluate[%s]: dropped %d non-finite scenario results",
            stream_name, n_bad)

    # ---- reference aggregation: reps -> run mean -> mean +- CI ----
    stats: Stats = {}
    nT = len(T_grid)
    for k in ALGO_KEYS:
        r = regrets[k].reshape(runs, nT, replicates)
        run_means = np.nanmean(np.where(np.isfinite(r), r, np.nan), axis=2)
        means, cis = [], []
        for ti in range(nT):
            vals = run_means[:, ti]
            mu, ci = mean_ci(vals[np.isfinite(vals)])
            means.append(mu)
            cis.append(ci)
        stats[k] = (np.asarray(means), np.asarray(cis))
    return stats


# SSN Newton-step budget (first attempt; escalation doubles it).  The
# measured envelope: converged prefixes take 27-49 steps; rows still
# uncertified at 80 essentially never certify with more steps (cert
# frac 0.982 at 80 vs 0.985 at 2000 on the hard probe batch) and ride
# the escalation/sentinel contract instead.
_SSN_NEWTON_BUDGET = 80


@functools.lru_cache(maxsize=16)
def _band_programs(T_max: int, norm: str, iters: int, use_ssn: bool,
                   ssn_f64: bool):
    """Jitted band-solver programs: (prefix_solve, prefix_solve_hard,
    band_los).  ONE cached builder shared by evaluate_stream_exact and
    the prewarm daemon (round-2 ADVICE: the prewarm used to hand-
    duplicate this construction and relied on XLA's computation-
    fingerprint dedup to match — now both literally hold the same jit
    object, and the lru_cache also prevents fresh-closure retraces /
    remote recompiles across runs).

    Prefix BANDING: the per-prefix problems are independent, so the
    T_max rows split into 256-row bands, each with its OWN while_loop —
    short prefixes stop iterating as soon as their band converges
    instead of waiting for the global slowest (measured 1.6x on the
    T=1000 iid cell).  band_lo is a DYNAMIC operand so one compiled
    program serves every band; lax.map folds all bands into one
    dispatch.
    """
    import jax
    import jax.numpy as jnp

    from online_convex_optimization.models.exact_ftl import (
        _admm_all_prefixes)

    band_rows = 256 if T_max >= 512 else T_max
    band_los = sorted({min(b * band_rows, T_max - band_rows)
                       for b in range(-(-T_max // band_rows))})
    band_los_arr = jnp.asarray(band_los, jnp.int32)

    if use_ssn:
        # Semismooth-Newton band solver (models/ssn.py): same banding
        # and state-continuation contract as the ADMM; budgets here cap
        # NEWTON steps, each worth ~25-100x an ADMM iteration.  f64 when
        # available (accuracy-first); f32 uses the compensated multi-
        # candidate certificate (comp mode), which is what makes the
        # method production-usable without x64 at all.
        #
        # BUDGET: Newton steps, NOT ADMM iterations.  Round 4 passed the
        # ADMM's 2000 here, so the ~1.5% never-certifying rows of a hard
        # band ran 2000 Newton steps with the compensated certificate
        # every 10 — 200 certificate evaluations instead of 8.  THAT was
        # the measured "31x certificate wall" (34.8 s vs 1.87 s for the
        # same solves at the 80-step envelope, ssn_cert_decomp_* records;
        # converged solves take 27-49 steps and stragglers ride the
        # escalation contract, which continues from saved state).
        from online_convex_optimization.models.ssn import (
            ssn_all_prefixes)
        # norm is always 'l2' here: use_ssn with any other norm is
        # rejected at the evaluate_stream_exact entry (the pipeline
        # keeps the ADMM for linf — see the gate's measured rationale),
        # and auto_ssn is gated on norm == 'l2'.
        assert norm == "l2", norm
        sdt = jnp.float64 if ssn_f64 else jnp.float32

        def _band(z1, y1, lo, st=None, budget=_SSN_NEWTON_BUDGET):
            return ssn_all_prefixes(z1.astype(sdt), y1.astype(sdt),
                                    iters=budget, tol=2e-4,
                                    state0=st, band_lo=lo,
                                    band_rows=band_rows, norm=norm)
    else:
        def _band(z1, y1, lo, st=None, budget=None):
            return _admm_all_prefixes(
                z1, y1, norm=norm, iters=(3 * iters if budget is None
                                          else budget), tol=2e-4,
                state0=st, band_lo=lo, band_rows=band_rows)

    @jax.jit
    def prefix_solve(zz, yy):
        def one(lo):
            return jax.vmap(
                lambda z1, y1: _band(z1, y1, lo))(zz, yy)
        return jax.lax.map(one, band_los_arr)  # (n_bands, B, ...)

    # Escalation solver for bands with unconverged replicates: CONTINUES
    # from the first attempt's saved state with 3x more budget (6x total
    # ceiling) — the iteration is Markov in the state, so nothing is
    # redone.  Recovers would-be-dropped replicates instead of
    # sentineling them.
    hard_budget = 2 * _SSN_NEWTON_BUDGET if use_ssn else 3 * iters
    prefix_solve_hard = jax.jit(jax.vmap(
        lambda zz, yy, st, lo: _band(zz, yy, lo, st=st,
                                     budget=hard_budget),
        in_axes=(0, 0, 0, None)))
    return prefix_solve, prefix_solve_hard, band_los


def warm_exact_fallback(T_max: int, *, norm: str = "l2",
                        iters: int = 2000, dtype=np.float64) -> None:
    """Compile the general-solver band program AHEAD of the exact
    pipeline (the driver runs this in a daemon thread): the certified
    fast path keeps the main thread host-bound at the start of an exact
    run, so compiling the deterministic families' fallback ADMM program
    meanwhile takes the compile off the critical path.  Shares the jitted program
    object with evaluate_stream_exact via _band_programs (B = 1
    deterministic-cell shape compiled here)."""
    import jax
    import jax.numpy as jnp

    prefix_solve, _, _ = _band_programs(int(T_max), norm, int(iters),
                                        False, False)
    z = jnp.zeros((1, int(T_max), 5), dtype)
    y = jnp.zeros((1, int(T_max)), dtype)
    # Trace + compile only; an all-zero problem converges immediately.
    jax.block_until_ready(prefix_solve(z, y)[1])


def evaluate_stream_exact(
    stream_builder: Callable,
    T_grid,
    *,
    runs: int = 1,
    replicates: int = 1,
    base_seed: int = 0,
    eta0: float = math.sqrt(2.0),
    norm: str = "l2",
    iters: int = 2000,
    dtype=np.float64,
    stream_name: str = "",
    progress: bool = True,
    polish: bool = True,
    fail_tol: float = 1e-3,
    solver: str = "auto",
    selection: str = "committed",
    audit_out: Optional[dict] = None,
) -> Stats:
    """Exact-FTL comparison mode (exact_ftl_driver.py:120-206): per
    scenario, solve all prefixes once (batched device ADMM + host
    active-set polish to interior-point accuracy), then score FTRL (same
    exact comparator) and exact FTL from the shared trajectory.

    Failure containment (SURVEY §5): replicates whose ADMM residual
    exceeds ``fail_tol`` become NaN sentinels and are dropped from the
    aggregation (logged), instead of killing the whole sweep the way the
    reference's raise would (exact_ftl.py:125-126).

    ``solver``: "auto" first tries the CERTIFIED closed form
    (models/linear_regime.py) — on binary-label contract data the exact
    program is linear and every prefix minimizer is w_t/||w_t||, checked
    per prefix by the optimality certificate (max_i |<z_i, x*_t>| <= 1),
    so the device solve and the polish vanish entirely; uncertified
    cells split by WHY they failed: out-of-contract data (rows outside
    the unit ball, l2) goes to the semismooth-Newton band solver in
    both regimes (models/ssn.py — 8.4x the ADMM on CPU f64; in f32 the
    compensated certificate at the 80-step Newton budget certifies more
    prefixes than the ADMM; see docs/BENCHMARKS.md) — and in-contract selection-degenerate cells
    (the deterministic w=0 families) stay on the banded lax.map XLA
    ADMM either way, whose committed artifact statistics are
    bitwise-pinned.  "linear"
    requires the certificate (raises if any cell is uncertified).
    "xla" forces the banded XLA formulation; "ssn" forces the
    semismooth-Newton solver for every general cell.

    Arithmetic note ("auto"): certified cells are scored host-side in
    f64 (the reference exact driver's own dtype) while general cells
    are scored in the device ``dtype`` — identical when dtype is f64
    (the committed pipelines); with an f32 dtype the mix is logged once
    so it cannot pass silently (round-2 ADVICE).

    ``selection``: "committed" keeps the historical solver selection on
    degenerate optima (the committed artifacts are bitwise-pinned to
    it); "canonical" (l2) applies the min-norm canonical-selection
    contract (models/canonical.py): structured degenerate cells are
    solved host-side by LP-verified closed forms with T_max-prefix
    dedup — no device solver at all — and general cells get the
    canonicalizer after the polish, making the trajectory
    solver-independent.  See docs/DESIGN.md "Canonical selection".

    ``audit_out``: pass a dict to receive solver-path accounting — cells
    by route (certified / canonical / admm / ssn) and replicate-level
    escalation / recovery / drop counts — which the driver embeds in
    results_exact.json so committed artifacts record how each statistic
    was produced.
    """
    import logging

    import jax
    import jax.numpy as jnp

    from online_convex_optimization.models.polish import polish_prefix_actions
    from online_convex_optimization.ops.hinge import normalized_hinge

    T_grid = [int(t) for t in T_grid]
    T_max = max(T_grid)
    labels = ("FTRL", "FTL (exact)")
    by_T = {k: np.empty((runs, len(T_grid), replicates)) for k in labels}
    n_dropped = 0

    # Every horizon is zero-padded to T_max before the solve: padded rows
    # (z = 0, y = 0) contribute |<0,x> - 0| = 0 to every prefix objective,
    # so prefix minimizers for p >= length all equal the length-prefix
    # minimizer and the ONE compiled (T_max, reps) program serves the whole
    # horizon grid (10 horizons would otherwise mean 10 compiles).
    # tol: residual-based early exit (iters is the cap); under vmap the
    # while_loop runs until the slowest replicate converges, so easy
    # (run, T) calls finish in a fraction of the iteration budget.
    # Prefix BANDING: the per-prefix problems are independent, so the T_max
    # rows split into bands of ``band_rows`` prefixes, each with its OWN
    # while_loop — short prefixes stop iterating as soon as their band
    # converges instead of waiting for the global slowest (measured 1.6x
    # on the T=1000 iid cell).  band_lo is a DYNAMIC operand so one
    # compiled program serves every band.
    use_ssn = solver == "ssn"
    try_linear = solver in ("auto", "linear")
    require_linear = solver == "linear"
    if try_linear:
        from online_convex_optimization.models.linear_regime import (
            certified_prefix_actions_batch)
    if use_ssn and norm != "l2":
        # MEASURED (r5): the linf SSN (models/ssn.py norm='linf') reaches
        # LP-grade optima but certifies only ~96.6% of prefixes at the
        # production 2e-4 gap bar vs the banded ADMM's 99.7% on the same
        # instances (degenerate small-prefix faces keep rigorous gaps in
        # the e-3 range), so the PIPELINE keeps the ADMM for linf —
        # routing ssn here would drop replicates the ADMM certifies.
        # The capability remains available at the model surface:
        # ExactFTL(method='ssn', norm='linf') under x64.
        raise ValueError("solver='ssn' supports norm='l2' only in the "
                         "pipeline (linf SSN: use ExactFTL(method='ssn', "
                         "norm='linf'); see docs/BENCHMARKS.md)")
    # SSN dtype: f64 when x64 is on (accuracy-first); without x64 the
    # f32 compensated multi-candidate certificate
    # (models/ssn.py comp mode) carries the rigorous duality gap — rows
    # it cannot close stay above fail_tol and are escalated/sentineled
    # by the usual failure contract.
    ssn_f64 = bool(jax.config.jax_enable_x64)
    # Shared jitted band programs (also used by the prewarm daemon).
    prefix_solve, prefix_solve_hard, band_los = _band_programs(
        T_max, norm, iters, use_ssn, ssn_f64)

    # 'auto' escalation of OUT-OF-CONTRACT cells (rows outside the unit
    # ball — general user data, the reference's own smoke-test regime)
    # to the semismooth-Newton solver, in BOTH precision regimes:
    #   - f64: ~20-60 Newton steps vs the ADMM's 1.8-2.2k iterations
    #     (8.4x measured, CPU f64 T=512);
    #   - f32: the compensated multi-candidate certificate makes the
    #     solves certifiable (more prefixes at 2e-4 than the ADMM on
    #     the hard probe batch of scripts/ssn_onchip_probe.py), given
    #     the Newton budget of _SSN_NEWTON_BUDGET (passing the ADMM's
    #     iteration count instead burns certificate evaluations on
    #     never-certifying rows).
    # In-contract uncertified cells (the deterministic w=0 families)
    # DELIBERATELY stay on the ADMM: their minimizer sets are selection-
    # degenerate and the committed artifact statistics are bitwise-
    # pinned to that path.
    auto_ssn = solver == "auto" and norm == "l2"

    def _general_programs(z_cell, T):
        if auto_ssn and bool(np.any(
                np.linalg.norm(z_cell[:, :T], axis=-1) > 1.0 + 1e-9)):
            return _band_programs(T_max, norm, iters, True,
                                  ssn_f64)[:2] + ("ssn",)
        return prefix_solve, prefix_solve_hard, "ssn" if use_ssn else "admm"

    # Solver-path accounting for the artifact (VERDICT round-2 task 8).
    audit = {"cells": 0, "cells_certified": 0, "cells_canonical": 0,
             "cells_admm": 0, "cells_ssn": 0,
             "replicates_escalated": 0, "replicates_recovered": 0,
             "replicates_dropped": 0}

    if selection not in ("committed", "canonical"):
        raise ValueError(f"unknown selection {selection!r}")
    # All three balls get the canonical ladder (r5 task 4): the
    # optimality LP's normal cone is norm-aware (models/canonical.py).
    use_canonical = selection == "canonical"
    if use_canonical:
        from online_convex_optimization.models.canonical import (
            canonical_prefix_actions, canonicalize)

    run_iter = range(runs)
    if progress:
        try:
            from tqdm import tqdm
            run_iter = tqdm(run_iter,
                            desc=f"{stream_name:>24} | exact runs={runs}")
        except ImportError:
            pass

    def issue(run):
        # Issue ALL horizon solves for one run up-front: device dispatch
        # is asynchronous, so the accelerator crunches the queued ADMM
        # programs while the host runs the per-prefix polish loop below.
        sampler = stream_builder(run_seed=run_seed_schedule(base_seed, run))
        # selection='canonical': T_max-PREFIX DEDUP for the structured
        # (deterministic) families.  Every horizon of a deterministic
        # family is a prefix of the longest cell, so the canonical
        # solver runs ONCE per replicate at T_max and shorter horizons
        # slice the shared trajectory — no device solver at all for
        # these cells (the 10x the committed selection could not take
        # without moving its pinned artifacts; see docs/DESIGN.md).
        canon_cache = None
        if use_canonical:
            zf, yf = stack_replicates(sampler, T_max, replicates,
                                      dtype=np.float64)
            accs = [canonical_prefix_actions(zf[b], yf[b], norm)
                    for b in range(replicates)]
            if all(a is not None for a in accs):
                canon_cache = (zf, yf, np.stack(accs))   # (B, T_max+1, d)
        pending = []
        for T in T_grid:
            z, y = stack_replicates(sampler, T, replicates, dtype=dtype)
            z, y = _pad_T(z, y, T_max)
            if try_linear:
                # Certified closed form: exact (f64, zero iterations) when
                # every (replicate, prefix) passes the optimality
                # certificate — the common case on contract data.  Certify
                # on the TRUE horizon slice (the certificate matmul is
                # O(B T^2 d) host BLAS; padded rows are inert duplicates
                # of prefix T, reattached afterwards).
                X_lin = certified_prefix_actions_batch(z[:, :T], y[:, :T],
                                                       norm)
                if X_lin is not None:
                    # Certified cells never touch the device: replay,
                    # comparator, and FTRL all run host-side in f64 (the
                    # reference exact driver's own dtype), so no transfer
                    # or dispatch is spent on them.
                    audit["cells"] += 1
                    audit["cells_certified"] += 1
                    pending.append((T, z, y, None, None,
                                    ("linear", X_lin), None))
                    continue
                if require_linear:
                    raise RuntimeError(
                        f"solver='linear': cell (run={run}, T={T}) failed "
                        "the closed-form optimality certificate")
            if canon_cache is not None:
                zf, yf, accs = canon_cache
                if ((np.asarray(z[:, :T], np.float64) == zf[:, :T]).all()
                        and (np.asarray(y[:, :T], np.float64)
                             == yf[:, :T]).all()):
                    # Canonical trajectory slice: exact LP-verified
                    # minimizers, scored through the same host-f64 path
                    # as certified cells.
                    audit["cells"] += 1
                    audit["cells_canonical"] += 1
                    pending.append((T, z, y, None, None,
                                    ("linear", accs[:, 1:T + 1]), None))
                    continue
            zj, yj = jnp.asarray(z), jnp.asarray(y)
            solve, hard, kind = _general_programs(z, T)
            audit["cells"] += 1
            audit["cells_" + kind] += 1
            pending.append((T, z, y, zj, yj, solve(zj, yj), hard))
        return pending

    # Prefetching keeps TWO runs' ADMM states alive ((reps, T_max, T_max)
    # S/U per horizon, released only as cells are consumed).  Above ~4 GB
    # of state, fall back to one run in flight — the host polish still
    # hides under the current run's queued solves, only the cross-run
    # overlap is lost.
    state_bytes = (2 * len(T_grid) * replicates * 2 * T_max * T_max
                   * np.dtype(dtype).itemsize)
    prefetch = state_bytes <= (4 << 30)

    mixed_warned = False
    pend_next = issue(0) if runs else []
    for run in run_iter:
        pending = pend_next
        if prefetch and run + 1 < runs:
            # Prefetch: queue the NEXT run's solves before consuming this
            # run's results, so the device stays busy through the host
            # polish (cross-run pipelining; device is the critical path).
            # Rare escalations do queue behind the prefetched run — a
            # latency hiccup on already-slow cells, not lost device work.
            pend_next = issue(run + 1)
        lin_cells = []
        for ti in range(len(pending)):
            T, z, y, zj, yj, solved, escalate = pending[ti]
            pending[ti] = None  # release the ADMM states early
            is_linear = isinstance(solved[0], str) and solved[0] == "linear"
            if is_linear:
                # Certified closed form: already the exact f64 optimum for
                # every prefix — nothing to escalate, nothing to polish,
                # nothing to send to the device.  Scored after the loop in
                # one batched host pass per run.
                lin_cells.append((ti, T, z, y, solved[1]))
                continue
            B = zj.shape[0]
            d_dim = zj.shape[2]
            X_dev, res_dev, st_dev = solved
            X_all = np.array(X_dev, np.float64)  # (n_bands, B, rows, d)
            res_all = np.asarray(res_dev)        # (n_bands, B, rows)
            X = np.empty((B, T_max, d_dim))
            bad = np.zeros(B, bool)              # per replicate
            for bi, lo in enumerate(band_los):
                Xb = X_all[bi]
                bad_b = ~(res_all[bi].max(axis=1) <= fail_tol)
                if bad_b.any():
                    audit["replicates_escalated"] += int(bad_b.sum())
                    stb = jax.tree.map(lambda a, bi=bi: a[bi], st_dev)
                    Xb2, resb2, _ = escalate(zj, yj, stb, lo)
                    Xb2 = np.array(Xb2, np.float64)
                    bad_b2 = ~(np.asarray(resb2).max(axis=1) <= fail_tol)
                    take = bad_b & ~bad_b2   # recovered replicates
                    audit["replicates_recovered"] += int(take.sum())
                    Xb[take] = Xb2[take]
                    bad_b = bad_b & bad_b2
                # Overlapping tail band (T_max % band_rows != 0) simply
                # overwrites rows both bands solved.
                X[:, lo:lo + Xb.shape[1]] = Xb
                bad |= bad_b
            del solved, st_dev, X_dev, res_dev  # release the ADMM state
            n_dropped += int(bad.sum())
            X[bad] = np.nan
            if polish:
                for b in np.flatnonzero(~bad):
                    acts = np.concatenate([np.zeros((1, X.shape[2])), X[b]])
                    acts = polish_prefix_actions(z[b], y[b], acts, norm,
                                                 lengths=range(1, T + 1))
                    X[b] = acts[1:]
                    if use_canonical:
                        # Solver-independent selection on any degenerate
                        # faces the general path landed on (cheap: only
                        # strictly-smaller-norm exact-tie candidates are
                        # ever accepted).
                        zb = np.asarray(z[b], np.float64)
                        yb = np.asarray(y[b], np.float64)
                        for ti_ in range(1, T + 1):
                            X[b, ti_ - 1] = canonicalize(
                                zb[:ti_], yb[:ti_], X[b, ti_ - 1], norm)
            # Prefixes past the true horizon solve the same (zero-padded)
            # problem as prefix T — pin them to the polished prefix-T row
            # so the comparator X[:, -1] is the exact full-sequence action.
            X[:, T:] = X[:, T - 1][:, None, :]
            Xj = jnp.asarray(X)
            # exact-FTL replay: action for round t is the prefix-t solution
            # shifted by one (prefix 0 action = 0); padded rounds are inert.
            X_play = jnp.concatenate(
                [jnp.zeros((Xj.shape[0], 1, Xj.shape[2]), Xj.dtype),
                 Xj[:, :-1]], axis=1)
            q = jnp.sum(zj * X_play, axis=-1)
            cum_exact = jnp.sum(normalized_hinge(q, yj), axis=-1)
            q_c = jnp.einsum("btd,bd->bt", zj, Xj[:, -1],
                             precision=jax.lax.Precision.HIGHEST)
            comp = jnp.sum(normalized_hinge(q_c, yj), axis=-1)
            by_T["FTL (exact)"][run, ti] = np.asarray(cum_exact - comp)
            # FTRL with the shared exact comparator.
            lin = simulate_linear_batch(zj, yj, 0, eta0)
            by_T["FTRL"][run, ti] = np.asarray(lin.cum_loss) - np.asarray(comp)
        if lin_cells:
            if (not mixed_warned and len(lin_cells) < len(by_T["FTRL"][run])
                    and np.dtype(dtype) != np.float64):
                # Certified cells score host-f64, general cells score in
                # the f32 device dtype — surface the mixed arithmetic
                # once rather than letting it pass silently.
                mixed_warned = True
                logging.getLogger("oco").info(
                    "evaluate_stream_exact[%s]: mixed scoring arithmetic "
                    "(certified cells host-f64, general cells %s)",
                    stream_name, np.dtype(dtype).name)
            # ---- certified cells: one batched host f64 pass per run ----
            # Replay, comparator, and FTRL in f64 on the true-horizon
            # slices; the exact-FTL action for round t is the prefix-t
            # minimizer shifted by one (prefix-0 action = 0).  This is the
            # reference exact driver's own arithmetic (f64 NumPy,
            # exact_ftl.py:230-333) — no f32 round-trip.
            zs = np.concatenate([np.asarray(c[2], np.float64)
                                 for c in lin_cells])
            ys = np.concatenate([np.asarray(c[3], np.float64)
                                 for c in lin_cells])
            cum_ftrl = _host_ftrl_cum_loss(zs, ys, eta0)
            ofs = 0
            for ti, T, zc, yc, X in lin_cells:
                B = X.shape[0]
                zc = np.asarray(zc, np.float64)[:, :T]
                yc = np.asarray(yc, np.float64)[:, :T]
                X_play = np.concatenate(
                    [np.zeros((B, 1, X.shape[2])), X[:, :T - 1]], axis=1)
                q = np.einsum("btd,btd->bt", zc, X_play)
                cum_exact = 0.5 * np.abs(q - yc).sum(axis=1)
                q_c = np.einsum("btd,bd->bt", zc, X[:, T - 1])
                comp = 0.5 * np.abs(q_c - yc).sum(axis=1)
                by_T["FTL (exact)"][run, ti] = cum_exact - comp
                by_T["FTRL"][run, ti] = cum_ftrl[ofs:ofs + B] - comp
                ofs += B
        if not prefetch and run + 1 < runs:
            pend_next = issue(run + 1)

    if n_dropped:
        logging.getLogger("oco").warning(
            "evaluate_stream_exact[%s]: dropped %d diverged replicates",
            stream_name, n_dropped)
    audit["replicates_dropped"] = n_dropped
    if audit_out is not None:
        audit_out.update(audit)

    stats: Stats = {}
    for k in labels:
        run_means = np.nanmean(by_T[k], axis=2)      # sentinel-aware
        means, cis = [], []
        for ti in range(len(T_grid)):
            mu, ci = mean_ci(run_means[:, ti])
            means.append(mu)
            cis.append(ci)
        stats[k] = (np.asarray(means), np.asarray(cis))
    return stats
