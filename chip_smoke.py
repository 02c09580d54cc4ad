#!/usr/bin/env python3
"""End-to-end smoke test of the system on NVIDIA GPUs, in one process.

Drives the main paths through the entry points a user calls, at the sizes
users run, with every kernel compiled for the card (never interpreted),
and checks each phase against the repository's plain references:

  1. reference-scale g(T) pipeline (``run_experiment``), f32 on the card,
     vs an x64 CPU recompute and the committed ``results/results.json``;
  2. exact pipeline (``--exact``) vs ``results/results_exact.json``, plus
     an out-of-contract T=1000 solve (ADMM and SSN, x64) vs SciPy HiGHS;
  3. x64 parity of the scan on the card vs ``testing/golden.py``;
  4. batched regret at 262,144 x T=1024 x d=5 (bf16 z, int8 y): the
     Triton kernel vs ``simulate_linear_batch``, timed, and an x64 CPU
     slice;
  5. SMART at the same shape: kernel vs ``simulate_smart_batch``;
  6. eta (64) and SMART-threshold (16) sweeps at 4,096 x T=1000;
  7. long-horizon streaming, T=2^20 in chunks with a checkpoint/resume,
     and a T=2^16 prefix vs the one-shot kernel and the scan;
  8. the quadratic track at ``quadratic_study`` defaults vs x64 CPU;
  9. ``__graft_entry__.entry()`` and ``dryrun_multichip(1)``.

With ``--four-cards`` it runs only the sharded sweeps on four GPUs against
unsharded runs.  Any failed check raises: the script then exits non-zero
and does not print its last line, which is one JSON object naming the
device.  Without a GPU it refuses to run.

    python3 chip_smoke.py                 # one GPU, every phase
    python3 chip_smoke.py --four-cards    # four GPUs, sharded sweeps only
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
ETA = math.sqrt(2.0)

# Every size the phases use, in one place.
SIZES = {
    "plain_runs": 1000, "plain_t_max": 1000,    # `make experiment`
    "exact_runs": 200, "exact_T": 1000,         # `make experiment-exact`
    "parity_T": 1000,
    "batched": (262144, 1024),                  # bench.py's shape, d=5
    "sweeps": (4096, 1000),
    "stream": (16384, 8192, 128, 8),            # B, chunk, chunks, prefix
    "quadratic_T_max": 2000,                    # quadratic_study default
    "four_T": 1000, "four_block": 65536, "four_B": 16384,
}


def require_gpu(count: int = 1) -> None:
    """Refuse to run unless JAX's default backend is the GPU with at least
    ``count`` devices — no fallback to the CPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPU(s); JAX found {len(devs)} "
            f"{devs[0].platform} device(s)")


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    if shutil.which("nvidia-smi") is None:
        raise SystemExit("chip_smoke: nvidia-smi not found")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


CARD = ""


def check(label: str, dev: float, tol: float, why: str = "") -> None:
    """Print a phase's max deviation beside its tolerance; raise if out."""
    ok = bool(np.isfinite(dev)) and dev <= tol
    print(f"[check] {label}: max deviation {dev:.3e} (tolerance {tol:.1e}"
          f"{'; ' + why if why else ''}) {'ok' if ok else 'FAILED'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{label}: deviation {dev} > {tol}")


def report_time(label: str, seconds: float, extra: str = "") -> None:
    print(f"[time] {label}: {seconds:.6f} s{extra} ({CARD})", flush=True)


def timed(fn, *args, repeats: int = 5):
    """Median wall time of ``fn(*args)`` over ``repeats`` runs after one
    warm-up, each ending in ``block_until_ready``; returns (median, out)."""
    import jax

    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def memory(label: str, jitted, *args) -> None:
    """compiled.memory_analysis() of a jitted step at these arguments."""
    ma = jitted.lower(*args).compile().memory_analysis()
    print(f"[memory] {label}: arguments {ma.argument_size_in_bytes} B, "
          f"outputs {ma.output_size_in_bytes} B, temp "
          f"{ma.temp_size_in_bytes} B, code "
          f"{ma.generated_code_size_in_bytes} B", flush=True)


def max_rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


def _stats_dev(got: dict, committed: dict) -> float:
    """Largest relative deviation over g(T) and every case statistic."""
    devs = [max_rel([got["g_emp"][k] for k in committed["g_emp"]],
                    list(committed["g_emp"].values()))]
    for title, algs in committed["stats"].items():
        for alg, mc in algs.items():
            devs.append(max_rel(got["stats"][title][alg]["mean"],
                                mc["mean"]))
    return max(devs)


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------

def phase_plain(out_dir: str) -> None:
    import jax

    from online_convex_optimization.experiments.config import (
        config_from_args)
    from online_convex_optimization.experiments.driver import (
        run_experiment)
    from online_convex_optimization.experiments.gt import _g_for_T

    cfg = config_from_args(["--t-max", str(SIZES["plain_t_max"]),
                            "--g-runs", str(SIZES["plain_runs"]),
                            "--out-dir", os.path.join(out_dir, "plain")])
    t0 = time.perf_counter()
    res = run_experiment(cfg)
    report_time("plain pipeline (10 horizons x 1000 runs + 4 cases)",
                time.perf_counter() - t0,
                f"; compile {res['device']['compile_seconds']:.1f} s")
    assert res["device"]["platform"] == jax.devices()[0].platform
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(), jax.default_device(cpu):
        for T in (100, cfg.t_max):
            g64 = _g_for_T(T, cfg.g_runs, cfg.base_seed, cfg.eta0,
                           np.float64, cfg.batch_chunk)
            check(f"plain g({T}) f32 card vs x64 CPU",
                  max_rel(res["g_emp"][str(T)], g64), 1e-3,
                  "f32 regrets over T rounds; max over 1000 runs")
    with open(os.path.join(REPO, "results", "results.json")) as f:
        committed = json.load(f)
    check("plain pipeline vs committed results/results.json",
          _stats_dev(res, committed), 1e-2,
          "relative; an f32 run on another device or in another order")


def phase_exact(out_dir: str) -> None:
    import jax
    from scipy.optimize import linprog

    from online_convex_optimization.experiments.config import (
        config_from_args)
    from online_convex_optimization.experiments.driver import (
        run_experiment)
    from online_convex_optimization.models.exact_ftl import ExactFTL

    cfg = config_from_args(["--exact", "--g-runs", str(SIZES["exact_runs"]),
                            "--out-dir", os.path.join(out_dir, "exact")])
    t0 = time.perf_counter()
    res = run_experiment(cfg)
    report_time("exact pipeline (--exact --g-runs 200)",
                time.perf_counter() - t0,
                f"; compile {res['device']['compile_seconds']:.1f} s")
    with open(os.path.join(REPO, "results", "results_exact.json")) as f:
        committed = json.load(f)
    check("exact pipeline vs committed results/results_exact.json",
          _stats_dev(res, committed), 1e-2,
          "relative; host-f64 certified cells, f32 device g(T)")

    # One out-of-contract sequence (rows outside the unit ball), linf
    # ball: the exact LP optimum from HiGHS is the reference.
    rng = np.random.default_rng(7)
    T, d = SIZES["exact_T"], 5
    z = 1.5 * rng.normal(size=(T, d))
    y = np.where(rng.random(T) < 0.5, -1.0, 1.0)
    c = np.concatenate([np.zeros(d), 0.5 * np.ones(T)])
    A_ub = np.block([[z, -np.eye(T)], [-z, -np.eye(T)]])
    lp = linprog(c, A_ub=A_ub, b_ub=np.concatenate([y, -y]),
                 bounds=[(-1, 1)] * d + [(0, None)] * T, method="highs")
    assert lp.status == 0, lp.message
    f_ref = float(lp.fun)
    with jax.enable_x64():
        for method in ("admm", "ssn"):
            solver = ExactFTL(d=d, T_max=T, norm="linf", method=method,
                              iters=20000, allow_linear=False)
            t0 = time.perf_counter()
            x = solver.solve_full(z, y)
            report_time(f"exact T=1000 out-of-contract solve ({method}, x64)",
                        time.perf_counter() - t0)
            f = 0.5 * float(np.abs(z @ x - y).sum())
            assert np.max(np.abs(x)) <= 1.0 + 1e-9
            check(f"exact {method} objective vs HiGHS (linf, T=1000)",
                  (f - f_ref) / max(1.0, f_ref), 1e-8,
                  "relative; the active-set polish's accuracy")


def phase_parity() -> None:
    import jax
    import jax.numpy as jnp

    from online_convex_optimization.data.sequences import (
        flip_sequence, make_noisy_iid_stream, make_random_iid_stream,
        switching_two_leaders_sequence)
    from online_convex_optimization.models.linear import (
        simulate_linear_batch)
    from online_convex_optimization.testing.golden import (
        golden_simulate_alg)

    T = SIZES["parity_T"]
    fams = {
        "flip": flip_sequence(T)[:2],
        "switching": switching_two_leaders_sequence(T)[:2],
        "iid": make_random_iid_stream(d=5, run_seed=2025)(T, rep=0)[:2],
        "massart": make_noisy_iid_stream(p=0.10, d=5,
                                         run_seed=4050)(T, rep=1)[:2],
    }
    with jax.enable_x64():
        for name, (z, y) in fams.items():
            z64 = jnp.asarray(np.asarray(z, np.float64))
            y64 = jnp.asarray(np.asarray(y, np.float64))
            assert z64.devices() == {jax.devices()[0]}
            for alg in (0, 1):
                got = np.asarray(simulate_linear_batch(
                    z64[None], y64[None], alg, ETA).regret)[0]
                want = golden_simulate_alg(z, y, alg, ETA)
                check(f"x64 parity on the card, {name}, alg {alg}",
                      abs(float(got) - want), 1e-6, "BASELINE.md bar")


def _random_packed(key, T, B, d=5):
    from online_convex_optimization.data.device import random_packed_batch
    import jax.numpy as jnp
    return random_packed_batch(key, T, B, d, jnp.bfloat16, jnp.int8)


def _scan_layout(z_pack, y_pack):
    """The kernel's (T, d, B) inputs in the scan's (B, T, d) f32 layout."""
    import jax.numpy as jnp
    return (jnp.transpose(z_pack, (2, 0, 1)).astype(jnp.float32),
            y_pack.T.astype(jnp.float32))


def phase_batched() -> None:
    import jax
    import jax.numpy as jnp

    from online_convex_optimization.models.linear import (
        simulate_linear_batch)
    from online_convex_optimization.ops.pallas_game import regrets_fused

    B, T = SIZES["batched"]
    z, y = _random_packed(jax.random.key(0), T, B)
    zs, ys = _scan_layout(z, y)
    etas = jnp.linspace(0.25, 4.0, B, dtype=jnp.float32)
    tol = 2e-2
    why = ("f32 sums of T=1024 losses, |cum| <= 2T: rounding ~sqrt(T) ulp "
           "at 2048 plus reordered reductions")
    for alg, eta, name in ((0, np.float32(ETA), "FTRL scalar eta"),
                           (0, etas, "FTRL per-sequence eta"),
                           (1, np.float32(ETA), "FTL")):
        kern = jax.jit(lambda z, y, e, a=alg: regrets_fused(z, y, e,
                                                            alg_flag=a))
        scan = jax.jit(lambda z, y, e, a=alg: simulate_linear_batch(
            z, y, a, e).regret)
        if name == "FTRL scalar eta":
            memory("regret kernel (262144 x 1024 x 5, bf16 z, int8 y)",
                   kern, z, y, eta)
        t_k, r_k = timed(kern, z, y, eta)
        t_s, r_s = timed(scan, zs, ys, eta)
        report_time(f"regret kernel, {name}", t_k,
                    f" = {B * T / t_k:.4e} steps/s")
        report_time(f"regret scan (simulate_linear_batch), {name}", t_s,
                    f" = {B * T / t_s:.4e} steps/s")
        check(f"regret kernel vs scan, {name}",
              float(jnp.max(jnp.abs(r_k - r_s))), tol, why)
        # x64 CPU on a 1,024-sequence slice of the same values.
        cpu = jax.devices("cpu")[0]
        with jax.enable_x64(), jax.default_device(cpu):
            z64 = np.asarray(zs[:1024], np.float64)
            y64 = np.asarray(ys[:1024], np.float64)
            e64 = np.asarray(eta, np.float64)
            e64 = e64[:1024] if e64.ndim else e64
            r64 = np.asarray(simulate_linear_batch(z64, y64, alg,
                                                   e64).regret)
        check(f"regret kernel vs x64 CPU (1024 sequences), {name}",
              float(np.max(np.abs(np.asarray(r_k[:1024]) - r64))), tol, why)
    peak()


def peak() -> None:
    stats = jax_device().memory_stats() or {}
    print("[memory] peak_bytes_in_use:", stats.get("peak_bytes_in_use"),
          flush=True)


def jax_device():
    import jax
    return jax.devices()[0]


def phase_smart() -> None:
    import jax
    import jax.numpy as jnp

    from online_convex_optimization.models.smart import (
        simulate_smart_batch)
    from online_convex_optimization.ops.pallas_smart import (
        smart_regrets_packed)

    B, T = SIZES["batched"]
    z, y = _random_packed(jax.random.key(1), T, B)
    thresh = jnp.linspace(0.5, math.sqrt(2.0 * T), B, dtype=jnp.float32)
    eta = np.float32(ETA)
    kern = jax.jit(lambda z, y, th: smart_regrets_packed(z, y, th, eta))
    memory("SMART kernel (262144 x 1024 x 5, bf16 z, int8 y)", kern, z, y,
           thresh)
    t_k, (r_k, tau_k) = timed(kern, z, y, thresh)
    zs, ys = _scan_layout(z, y)
    scan = jax.jit(lambda z, y, th: simulate_smart_batch(z, y, th, eta))
    t_s, res = timed(scan, zs, ys, thresh, repeats=3)
    report_time("SMART kernel", t_k, f" = {B * T / t_k:.4e} steps/s")
    report_time("SMART scan (simulate_smart_batch)", t_s,
                f" = {B * T / t_s:.4e} steps/s")
    # The switch test compares the FTL lead, a difference of sums of
    # ~T terms (|F|, cnt ~ 1e3) carrying f32 errors ~1e-3, with the
    # threshold.  A lead that close to its threshold may switch a round
    # apart in two f32 formulations, and the sequence then takes another
    # (equally valid) trajectory.  So switch rounds are compared as a
    # share, and values where the switch rounds agree.
    why = ("leads within ~1e-3 of the threshold: f32 sums of T=1024 "
           "terms of size ~1")
    tau_k = np.asarray(tau_k).astype(np.int64)
    for ref, r_ref, tau_ref in (
            ("scan", res.regret, res.switch_t),
            ("x64 CPU (1024 sequences)",) + _smart_x64(zs, ys, thresh, eta)):
        n = np.asarray(r_ref).shape[0]
        agree = tau_k[:n] == np.asarray(tau_ref).astype(np.int64)
        check(f"SMART kernel vs {ref}: share of switch rounds that differ",
              float(1.0 - agree.mean()), 2e-2, why)
        check(f"SMART kernel vs {ref} where switch rounds agree",
              float(np.max(np.abs(np.asarray(r_k)[:n]
                                  - np.asarray(r_ref))[agree])), 2e-2,
              "f32 sums of T=1024 losses, as for the regret kernel")


def _smart_x64(zs, ys, thresh, eta, n=1024):
    import jax

    from online_convex_optimization.models.smart import (
        simulate_smart_batch)

    with jax.enable_x64(), jax.default_device(jax.devices("cpu")[0]):
        res = simulate_smart_batch(
            np.asarray(zs[:n], np.float64), np.asarray(ys[:n], np.float64),
            np.asarray(thresh[:n], np.float64), float(eta))
        return np.asarray(res.regret), np.asarray(res.switch_t)


def phase_sweeps() -> None:
    import jax
    import jax.numpy as jnp

    from online_convex_optimization.data.device import random_game_batch
    from online_convex_optimization.models.smart import (
        simulate_smart_batch)
    from online_convex_optimization.models.sweep_api import (
        ftrl_eta_sweep, smart_threshold_sweep)
    from online_convex_optimization.ops.pallas_game import pack_sequences
    from online_convex_optimization.ops.pallas_smart import (
        smart_sweep_packed)

    B, T = SIZES["sweeps"]
    z, y = random_game_batch(jax.random.key(2), B, T)
    etas = jnp.linspace(0.25, 4.0, 64, dtype=jnp.float32)
    ths = jnp.linspace(0.5, math.sqrt(2.0 * T), 16, dtype=jnp.float32)
    runs = {
        "eta sweep (64)": lambda k: ftrl_eta_sweep(z, y, etas, use_kernel=k),
        "SMART threshold sweep (16)": lambda k: smart_threshold_sweep(
            z, y, ths, eta0=ETA, use_kernel=k),
    }
    for name, run in runs.items():
        t_k, r_k = timed(run, True)
        t_s, r_s = timed(run, False, repeats=3)
        n = r_k.size * T
        report_time(f"{name}, kernel route", t_k, f" = {n / t_k:.4e} steps/s")
        report_time(f"{name}, scan route", t_s, f" = {n / t_s:.4e} steps/s")
        if name.startswith("eta"):
            check(f"{name}, kernel vs scan route",
                  float(jnp.max(jnp.abs(r_k - r_s))), 2e-2,
                  "f32 sums of T=1000 losses")
    # SMART sweep values, with the switch rounds (see phase_smart): the
    # kernel's threshold grid axis vs the scan on the cross product.
    zp, yp, _ = pack_sequences(z, y)
    r_k, tau_k = smart_sweep_packed(zp, yp, ths, ETA)
    G = ths.shape[0]
    res = simulate_smart_batch(jnp.repeat(z, G, axis=0),
                               jnp.repeat(y, G, axis=0), jnp.tile(ths, B),
                               ETA)
    tau_s = np.asarray(res.switch_t).reshape(B, G).T
    agree = np.asarray(tau_k)[:, :B].astype(np.int64) == tau_s
    check("SMART threshold sweep: share of switch rounds that differ",
          float(1.0 - agree.mean()), 2e-2,
          "leads within ~1e-3 of the threshold (see the SMART phase)")
    dev = np.abs(np.asarray(r_k)[:, :B]
                 - np.asarray(res.regret).reshape(B, G).T)
    check("SMART threshold sweep, kernel vs scan where switch rounds agree",
          float(dev[agree].max()), 2e-2, "f32 sums of T=1000 losses")


def phase_streaming(out_dir: str) -> None:
    import jax
    import jax.numpy as jnp

    from online_convex_optimization.models.streaming import (
        StreamingGame, StreamingKernelGame)
    from online_convex_optimization.ops.pallas_game import regrets_fused
    from online_convex_optimization.utils.checkpointing import (
        load_pytree, save_pytree)

    B, CT, n_chunks, n_pre = SIZES["stream"]      # T = 2^20
    key = jax.random.key(3)

    def chunk(i):
        return _random_packed(jax.random.fold_in(key, i), CT, B)

    ckpt = os.path.join(out_dir, "stream_carry.npz")
    full = StreamingKernelGame(B, 5, eta0=ETA, dtype=jnp.bfloat16)
    part = StreamingKernelGame(B, 5, eta0=ETA, dtype=jnp.bfloat16)
    t_feed = 0.0
    for i in range(n_chunks):
        zc, yc = chunk(i)
        jax.block_until_ready((zc, yc))
        t0 = time.perf_counter()
        full.feed_packed(zc, yc)
        jax.block_until_ready(full.carry)
        t_feed += time.perf_counter() - t0
        part.feed_packed(zc, yc)
        if i == n_chunks // 2:
            save_pytree(ckpt, part.carry_state())
            part = StreamingKernelGame(B, 5, eta0=ETA, dtype=jnp.bfloat16)
            part.resume(load_pytree(ckpt, part.carry_state()))
    report_time("streaming kernel, T=2^20 x 16384 sequences (kernel time "
                "only)", t_feed, f" = {B * CT * n_chunks / t_feed:.4e} "
                "steps/s")
    r_full = np.asarray(full.result().regret)
    r_part = np.asarray(part.result().regret)
    assert full.t == part.t == CT * n_chunks
    check("streaming resume vs uninterrupted (T=2^20)",
          float(np.max(np.abs(r_full - r_part))), 0.0, "same kernel, bits")
    assert np.isfinite(r_full).all()

    # T = 2^16 prefix: chunked kernel vs one-shot kernel vs the scan.
    pre = StreamingKernelGame(B, 5, eta0=ETA, dtype=jnp.bfloat16)
    scan = StreamingGame(B, 5, eta0=ETA)
    zs_all, ys_all = [], []
    for i in range(n_pre):
        zc, yc = chunk(i)
        pre.feed_packed(zc, yc)
        zs_all.append(zc)
        ys_all.append(yc)
        scan.feed(jnp.transpose(zc, (0, 2, 1)).astype(jnp.float32),
                  yc.astype(jnp.float32))
    r_pre = np.asarray(pre.result().regret)
    z1 = jnp.concatenate(zs_all)
    y1 = jnp.concatenate(ys_all)
    r_one = np.asarray(regrets_fused(z1, y1, np.float32(ETA)))
    del z1, y1
    check("streaming kernel (8 chunks) vs one-shot kernel, T=2^16",
          float(np.max(np.abs(r_pre - r_one))), 1e-3,
          "same step algebra; only the chunk carry round-trips")
    # The scan's own input layout: time-major (CT, B, d) f32.
    zf_all = [jnp.transpose(zc, (0, 2, 1)).astype(jnp.float32)
              for zc in zs_all]
    yf_all = [yc.astype(jnp.float32) for yc in ys_all]
    r_scan = np.asarray(scan.result(zip(zf_all, yf_all)).regret)
    check("streaming kernel vs scan (StreamingGame), T=2^16",
          float(np.max(np.abs(r_pre - r_scan))), 1.0,
          "f32 sums of 2^16 losses, |cum| <= 2^17: ~sqrt(T) ulp at 2^17")

    # End to end over the same prefix, chunks already on the device: feed
    # every chunk, then the regrets (the scan needs its replay pass).
    def kernel_prefix():
        g = StreamingKernelGame(B, 5, eta0=ETA, dtype=jnp.bfloat16)
        for zc, yc in zip(zs_all, ys_all):
            g.feed_packed(zc, yc)
        return g.result().regret

    def scan_prefix():
        g = StreamingGame(B, 5, eta0=ETA)
        for zc, yc in zip(zf_all, yf_all):
            g.feed(zc, yc)
        return g.result(zip(zf_all, yf_all)).regret

    steps = B * CT * n_pre
    t_k, _ = timed(kernel_prefix)
    report_time(f"streaming kernel, T=2^16 x {B} sequences ({n_pre} chunks "
                "+ result)", t_k, f" = {steps / t_k:.4e} steps/s")
    t_s, _ = timed(scan_prefix)
    report_time(f"streaming scan (StreamingGame), T=2^16 x {B} sequences "
                f"({n_pre} chunks + replay)", t_s,
                f" = {steps / t_s:.4e} steps/s")


def phase_quadratic() -> None:
    import jax

    from online_convex_optimization.experiments.quadratic_study import (
        QuadraticConfig, evaluate_quadratic_stream)

    cfg = QuadraticConfig(t_max=SIZES["quadratic_T_max"])
    kw = dict(runs=cfg.runs, replicates=cfg.replicates,
              base_seed=cfg.base_seed, eta0=cfg.eta0, sigma=cfg.sigma,
              d=cfg.d)
    t0 = time.perf_counter()
    got = evaluate_quadratic_stream(cfg.T_grid, dtype=np.float32, **kw)
    report_time("quadratic track at quadratic_study defaults (f32)",
                time.perf_counter() - t0)
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(), jax.default_device(cpu):
        want = evaluate_quadratic_stream(cfg.T_grid, dtype=np.float64, **kw)
    for k in want:
        check(f"quadratic {k} mean regret, f32 card vs x64 CPU",
              max_rel(got[k][0], want[k][0]), 5e-2,
              "relative; f32 trust-region solves of ill-conditioned "
              "early prefixes")


def phase_entry() -> None:
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = np.asarray(jax.jit(fn)(*args))
    assert np.isfinite(out).all() and out.shape == (args[0].shape[0],)
    ge.dryrun_multichip(1)


def phase_four_cards() -> None:
    """The sharded sweeps on a (4, 1) and a (2, 2) mesh vs one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from online_convex_optimization.data.device import random_game_batch
    from online_convex_optimization.models.linear import (
        simulate_linear_batch)
    from online_convex_optimization.models.smart import (
        simulate_smart_batch)
    from online_convex_optimization.ops.pallas_game import (
        pack_sequences, play_packed_stream, regrets_fused, stream_result,
        zero_stream_carry)
    from online_convex_optimization.ops.pallas_smart import (
        smart_regrets_packed)
    from online_convex_optimization.parallel.mesh import make_mesh
    from online_convex_optimization.parallel.sweep import (
        sharded_max_regret, sharded_pallas_regrets, sharded_regret_stats,
        sharded_smart_pallas, sharded_smart_regrets, sharded_stream_step,
        sharded_synthetic_g)

    devs = jax.devices()[:4]
    one = make_mesh(1, 1)
    etas = [0.5, 1.0, ETA, 2.0]
    T, bs = SIZES["four_T"], SIZES["four_block"]
    for shape in ((4, 1), (2, 2)):
        mesh = Mesh(np.asarray(devs).reshape(shape), ("data", "hyper"))
        t0 = time.perf_counter()
        g = np.asarray(sharded_synthetic_g(mesh, T=T, eta_grid=etas,
                                           blocks_per_device=2,
                                           block_seqs=bs))
        report_time(f"sharded_synthetic_g warm-up+run, mesh {shape}",
                    time.perf_counter() - t0)
        t_m, g = timed(lambda: np.asarray(sharded_synthetic_g(
            mesh, T=T, eta_grid=etas, blocks_per_device=2, block_seqs=bs)),
            repeats=3)
        g1 = np.asarray(sharded_synthetic_g(
            one, T=T, eta_grid=etas, blocks_per_device=2 * shape[0],
            block_seqs=bs))
        report_time(f"sharded_synthetic_g, mesh {shape}, "
                    f"{len(etas)} etas x {2 * shape[0] * bs} sequences", t_m)
        check(f"sharded_synthetic_g mesh {shape} vs (1, 1) with "
              f"{shape[0]}x blocks", float(np.max(np.abs(g - g1))), 0.0,
              "max is exact; same seed blocks, same kernel")
    t_1, _ = timed(lambda: np.asarray(sharded_synthetic_g(
        one, T=T, eta_grid=etas, blocks_per_device=8, block_seqs=bs)),
        repeats=3)
    report_time("sharded_synthetic_g, one device, 4 etas x "
                f"{8 * bs} sequences", t_1)

    mesh = make_mesh(4, 1)
    B = SIZES["four_B"]
    z, y = random_game_batch(jax.random.key(5), B, 512)
    g = float(sharded_max_regret(mesh, z, y, ETA))
    want = simulate_linear_batch(z, y, 0, ETA).regret
    scan_why = ("the same scan per shard; a shard's batch shape may get "
                "another XLA reduction order")
    check("sharded_max_regret vs unsharded",
          max_rel(g, float(jnp.max(want))), 1e-5, scan_why)
    st = np.asarray(sharded_regret_stats(mesh, z, y, 0, ETA))
    w = np.asarray(want, np.float64)
    check("sharded_regret_stats vs unsharded",
          max_rel(st, [w.size, w.sum(), (w * w).sum()]), 1e-5,
          "relative; psum order of f32 partial sums")
    th = jnp.linspace(0.5, 30.0, B, dtype=jnp.float32)
    sm = np.asarray(sharded_smart_regrets(mesh, z, y, th, ETA))
    sm1 = np.asarray(simulate_smart_batch(z, y, th, ETA).regret)
    check("sharded_smart_regrets vs unsharded",
          float(np.max(np.abs(sm - sm1))), 1e-3,
          "f32 sums of T=512 losses in another reduction order for a "
          "shard's batch shape: 7.6e-5 seen on four H100s; a flipped "
          "switch round moves a regret by O(1)")
    zp, yp, _ = pack_sequences(z, y, jnp.bfloat16, y_dtype=jnp.int8)
    kr = np.asarray(sharded_pallas_regrets(mesh, zp, yp, np.float32(ETA)))
    kr1 = np.asarray(regrets_fused(zp, yp, np.float32(ETA)))
    check("sharded_pallas_regrets vs unsharded",
          float(np.max(np.abs(kr - kr1))), 0.0, "same kernel per shard")
    eta_b = jnp.full((B,), ETA, jnp.float32)
    ks, kt = sharded_smart_pallas(mesh, zp, yp, th, eta_b)
    ks1, kt1 = smart_regrets_packed(zp, yp, th, eta_b)
    check("sharded_smart_pallas vs unsharded",
          float(np.max(np.abs(np.asarray(ks) - np.asarray(ks1)))
                + np.max(np.abs(np.asarray(kt) - np.asarray(kt1)))), 0.0,
          "same kernel per shard")
    c_sh = zero_stream_carry(B, 5)
    c_lo = zero_stream_carry(B, 5)
    for c0 in range(0, 512, 128):
        c_sh = sharded_stream_step(mesh, zp[c0:c0 + 128], yp[c0:c0 + 128],
                                   np.float32(ETA), c0, c_sh)
        c_lo = play_packed_stream(zp[c0:c0 + 128], yp[c0:c0 + 128],
                                  np.float32(ETA), c0, c_lo)
    check("sharded_stream_step vs unsharded",
          float(np.max(np.abs(np.asarray(stream_result(c_sh)[0])
                              - np.asarray(stream_result(c_lo)[0])))), 0.0,
          "same kernel per shard, carry stays on its device")


PHASES = {
    "plain": phase_plain, "exact": phase_exact, "parity": phase_parity,
    "batched": phase_batched, "smart": phase_smart, "sweeps": phase_sweeps,
    "streaming": phase_streaming, "quadratic": phase_quadratic,
    "entry": phase_entry,
}
_NEEDS_OUT = ("plain", "exact", "streaming")


def main(argv=None) -> int:
    global CARD
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the sharded sweeps, on four GPUs")
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of the one-card phases")
    p.add_argument("--out", default=os.path.join(REPO, "smoke_out"),
                   help="directory for pipeline outputs")
    args = p.parse_args(argv)

    n_cards = 4 if args.four_cards else 1
    require_gpu(n_cards)
    import jax

    from online_convex_optimization.utils import compile_cache
    compile_cache.enable()
    CARD = card()
    os.makedirs(args.out, exist_ok=True)
    t_all = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        for name in args.phases.split(","):
            t0 = time.perf_counter()
            print(f"[phase] {name}", flush=True)
            fn = PHASES[name]
            fn(args.out) if name in _NEEDS_OUT else fn()
            print(f"[phase] {name} done in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            peak()
    print(f"[time] chip_smoke total: {time.perf_counter() - t_all:.1f} s",
          flush=True)
    print(CARD, flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
