"""Experiment layer: driver pipeline, g(T) checkpointing, aggregation parity.

The batched evaluator must reproduce the reference's loop-based aggregation
(mean over replicates per run, then mean +- 1.96*SEM across runs) exactly,
and the g(T) table must match the sequential golden estimator.
"""

import json
import math
import os

import numpy as np
import pytest

from online_convex_optimization.data.sequences import CASES
from online_convex_optimization.experiments.config import (
    ExperimentConfig,
    config_from_args,
)
from online_convex_optimization.experiments.evaluate import (
    evaluate_stream_with_stats,
)
from online_convex_optimization.experiments.gt import estimate_g
from online_convex_optimization.testing.golden import (
    golden_empirical_thresholds,
    golden_simulate_alg,
    golden_simulate_smart,
)
from online_convex_optimization.data.rng import run_seed_schedule


def test_estimate_g_matches_golden(tmp_path):
    grid = [60, 120]
    cache = str(tmp_path / "g.json")
    got = estimate_g(grid, runs=12, base_seed=0, cache_path=cache)
    want = golden_empirical_thresholds(grid, runs=12, base_seed=0)
    for T in grid:
        assert got[T] == pytest.approx(want[T], abs=1e-9)
    # Cache resume: a second call must not recompute (poison by editing).
    with open(cache) as f:
        data = json.load(f)
    data["60"] = 123.0
    with open(cache, "w") as f:
        json.dump(data, f)
    again = estimate_g(grid, runs=12, base_seed=0, cache_path=cache)
    assert again[60] == 123.0  # came from the checkpoint, not recompute


def test_evaluate_matches_reference_loop_aggregation():
    """Batched evaluator == explicit nested reference-style loops."""
    title = "Massart noise 10%"
    builder = CASES[title]
    T_grid = [50, 90]
    runs, reps = 3, 2
    g_emp = {50: 2.0, 90: 3.0}
    eta0 = math.sqrt(2.0)

    stats = evaluate_stream_with_stats(
        builder, T_grid, g_emp, runs=runs, replicates=reps, base_seed=0,
        progress=False)

    # Reference-style loops over the golden oracle.
    from online_convex_optimization.utils.stats import mean_ci
    by_T = {k: [[] for _ in T_grid] for k in ("FTRL", "FTL", "SMART", "EMP")}
    for run in range(runs):
        sampler = builder(run_seed=run_seed_schedule(0, run))
        for ti, T in enumerate(T_grid):
            vals = {k: [] for k in by_T}
            for rep in range(reps):
                z, y, _ = sampler(T, rep=rep)
                vals["FTRL"].append(golden_simulate_alg(z, y, 0, eta0))
                vals["FTL"].append(golden_simulate_alg(z, y, 1, eta0))
                vals["SMART"].append(
                    golden_simulate_smart(z, y, math.sqrt(2 * T), eta0))
                vals["EMP"].append(
                    golden_simulate_smart(z, y, g_emp[T], eta0))
            for k in by_T:
                by_T[k][ti].append(float(np.mean(vals[k])))

    for k in by_T:
        for ti in range(len(T_grid)):
            mu, ci = mean_ci(by_T[k][ti])
            assert stats[k][0][ti] == pytest.approx(mu, abs=1e-6), (k, ti)
            assert stats[k][1][ti] == pytest.approx(ci, abs=1e-6), (k, ti)


def test_driver_end_to_end(tmp_path):
    from online_convex_optimization.experiments.driver import run_experiment
    cfg = ExperimentConfig(t_min=50, t_max=100, t_step=50, g_runs=5,
                           runs_override=2, replicates_override=2,
                           out_dir=str(tmp_path), dpi=60)
    results = run_experiment(cfg)
    assert set(results["stats"]) == set(CASES)
    assert os.path.exists(tmp_path / "results.json")
    assert os.path.exists(tmp_path / "empirical_g_T.png")
    assert os.path.exists(tmp_path / "algorithm_comparison.png")


def test_driver_without_matplotlib(tmp_path, monkeypatch):
    """matplotlib is optional: without it the driver writes the JSON
    results, logs that the figures were skipped, and succeeds."""
    import logging

    from online_convex_optimization.experiments import plotting
    from online_convex_optimization.experiments.driver import run_experiment
    from online_convex_optimization.utils.logging_utils import get_logger
    monkeypatch.setattr(plotting, "pyplot", lambda: None)
    seen = []
    handler = logging.Handler(logging.INFO)
    handler.emit = lambda rec: seen.append(rec.getMessage())
    get_logger().addHandler(handler)
    cfg = ExperimentConfig(t_min=50, t_max=50, t_step=50, g_runs=3,
                           runs_override=1, replicates_override=1,
                           out_dir=str(tmp_path))
    try:
        results = run_experiment(cfg)
    finally:
        get_logger().removeHandler(handler)
    assert set(results["stats"]) == set(CASES)
    assert os.path.exists(tmp_path / "results.json")
    assert not list(tmp_path.glob("*.png"))
    assert sum("skipped figure" in m for m in seen) == 2
    assert results["device"]["platform"] == "cpu"
    assert results["device"]["device_count"] >= 1


def test_exact_driver_end_to_end(tmp_path):
    """--exact pipeline (exact_ftl_driver.py:268-293 equivalent) produces
    the reference's artifact set at small shapes."""
    from online_convex_optimization.experiments.driver import run_experiment
    cfg = ExperimentConfig(t_min=40, t_max=80, t_step=40, g_runs=4,
                           runs_override=2, replicates_override=2,
                           exact=True, exact_iters=1200,
                           out_dir=str(tmp_path), dpi=60)
    results = run_experiment(cfg)
    for title, stats in results["stats"].items():
        assert set(stats) == {"FTRL", "FTL (exact)"}
        for rec in stats.values():
            assert np.isfinite(np.asarray(rec["mean"], np.float64)).all()
    assert os.path.exists(tmp_path / "results_exact.json")
    assert os.path.exists(tmp_path / "empirical_g_T_exact.png")
    assert os.path.exists(tmp_path / "algorithm_comparison_exact.png")


def test_config_cli_round_trip():
    cfg = config_from_args(["--t-max", "300", "--g-runs", "7", "--exact",
                            "--cases", "Label flips"])
    assert cfg.t_max == 300 and cfg.g_runs == 7 and cfg.exact
    assert cfg.T_grid == (100, 200, 300)
    assert cfg.cases == ("Label flips",)
    # cache key is sensitive to the knobs that define g(T)
    assert cfg.g_cache_key() != ExperimentConfig().g_cache_key()


def test_check_default_resolves_by_backend():
    """--check defaults on, on every backend; explicit flags override
    both ways."""
    assert config_from_args([]).check is True
    assert ExperimentConfig().check is True
    assert config_from_args(["--check"]).check is True
    assert config_from_args(["--no-check"]).check is False


def test_deterministic_families_route_to_golden_f64():
    """On an f32 backend the 1x1 deterministic (tie-degenerate) families
    must be evaluated by the f64 golden oracle, matching it exactly."""
    import math

    from online_convex_optimization.data.sequences import CASES
    from online_convex_optimization.experiments.evaluate import (
        evaluate_stream_with_stats,
    )
    from online_convex_optimization.testing.golden import (
        golden_simulate_alg,
    )

    T_grid = [50, 100]
    g_emp = {50: 5.0, 100: 7.0}
    stats = evaluate_stream_with_stats(
        CASES["Switching leaders"], T_grid, g_emp,
        runs=1, replicates=1, dtype=np.float32)
    sampler = CASES["Switching leaders"](run_seed=2025)
    for ti, T in enumerate(T_grid):
        z, y = (np.asarray(a, np.float64) for a in sampler(T, 0)[:2])
        want = golden_simulate_alg(z, y, 0, math.sqrt(2.0))
        assert float(stats["FTRL"][0][ti]) == want


def test_g_padding_is_inert():
    """Zero-padding horizons to a shared shape (one compile for the whole
    T grid) must not change g(T)."""
    from online_convex_optimization.experiments.gt import _g_for_T

    a = _g_for_T(60, runs=6, base_seed=0, eta0=1.4, dtype=np.float64,
                 chunk=8)
    b = _g_for_T(60, runs=6, base_seed=0, eta0=1.4, dtype=np.float64,
                 chunk=8, T_pad=150)
    # bit-level reduction order over the padded tail differs; the values
    # are mathematically identical (zero rows are inert).
    assert a == pytest.approx(b, abs=1e-12)


@pytest.mark.parametrize("knob", [["--exact-iters", "500"],
                                  ["--norm", "linf"],
                                  ["--exact-solver", "xla"]])
def test_config_exact_knobs_cache_key(knob):
    cfg = config_from_args(["--exact", *knob])
    base = config_from_args(["--exact"])
    # The knob changes the exact solves, so it must change the cache key.
    assert cfg.g_cache_key() != base.g_cache_key()
    # ...but only in exact mode (the plain pipeline never touches it).
    assert (config_from_args(knob).g_cache_key()
            == config_from_args([]).g_cache_key())


def test_estimate_g_exact_cache_resume(tmp_path):
    """Partial exact-g tables resume from the JSON artifact: already-
    computed horizons are not re-solved (exact twin of the plain test)."""
    from online_convex_optimization.experiments.gt import estimate_g_exact

    cache = str(tmp_path / "g_exact.json")
    g1 = estimate_g_exact([30], runs=3, base_seed=0, iters=800,
                          cache_path=cache, progress=False)
    g2 = estimate_g_exact([30, 50], runs=3, base_seed=0, iters=800,
                          cache_path=cache, progress=False)
    assert g2[30] == g1[30]          # reused verbatim from the artifact
    assert set(g2) == {30, 50} and g2[50] > 0.0
    import json
    data = json.load(open(cache))
    assert data["_meta"]["key"]["kind"] == "g_exact"   # provenance
    on_disk = {int(k): v for k, v in data.items() if k != "_meta"}
    assert on_disk == g2


def test_warm_exact_fallback_compiles_the_band_program():
    """The driver's prewarm thread target must trace + run the fallback
    band program without error for both banding regimes (T >= 512 banded,
    small-T unbanded); an all-zero problem converges immediately."""
    from online_convex_optimization.experiments.evaluate import (
        warm_exact_fallback)
    warm_exact_fallback(40, norm="l2", iters=50, dtype=np.float64)
    warm_exact_fallback(520, norm="l2", iters=50, dtype=np.float64)


def test_g_cache_provenance_guard(tmp_path):
    """Round-2 ADVICE: a g(T) artifact records its value-determining
    config; resuming under a different config recomputes instead of
    silently mixing maxima from incompatible sweeps."""
    import json

    from online_convex_optimization.experiments.gt import estimate_g

    path = str(tmp_path / "g.json")
    g1 = estimate_g([10], runs=3, base_seed=0, cache_path=path,
                    progress=False)
    with open(path) as f:
        data = json.load(f)
    assert data["_meta"]["key"]["runs"] == 3
    assert data["10"] == g1[10]
    # Same config: resumes (value unchanged, no recompute of T=10).
    g2 = estimate_g([10], runs=3, base_seed=0, cache_path=path,
                    progress=False)
    assert g2 == g1
    # Different seed: provenance mismatch -> fresh table, new value
    # recorded under the new key.
    g3 = estimate_g([10], runs=3, base_seed=123, cache_path=path,
                    progress=False)
    with open(path) as f:
        data3 = json.load(f)
    assert data3["_meta"]["key"]["base_seed"] == 123
    assert g3[10] != g1[10]
    # Legacy artifact without _meta: accepted with a warning.
    with open(path, "w") as f:
        json.dump({"10": 7.5}, f)
    g4 = estimate_g([10], runs=3, base_seed=0, cache_path=path,
                    progress=False)
    assert g4[10] == 7.5


def test_exact_audit_counts(tmp_path):
    """results_exact.json auditability (VERDICT round-2 task 8): the
    exact evaluator reports how each cell was solved.  A contract stream
    certifies everywhere; an out-of-contract stream routes to the
    general solver (ssn under 'auto'); counts must be complete."""
    from online_convex_optimization.data.sequences import CASES
    from online_convex_optimization.experiments.evaluate import (
        evaluate_stream_exact)

    builder = dict(CASES)["Random i.i.d. (separable)"]
    audit = {}
    evaluate_stream_exact(builder, T_grid=[20, 30], runs=2, replicates=1,
                          iters=800, dtype=np.float64, progress=False,
                          audit_out=audit, stream_name="audit-cert")
    assert audit["cells"] == 4 and audit["cells_certified"] == 4
    assert audit["replicates_dropped"] == 0

    def ooc(run_seed=0):
        def sampler(T, rep=0):
            rng = np.random.default_rng(run_seed + rep)
            z = 2.0 * rng.normal(size=(T, 5))
            y = np.sign(rng.normal(size=T))
            y[y == 0] = 1.0
            return z, y
        return sampler

    audit2 = {}
    evaluate_stream_exact(ooc, T_grid=[20], runs=1, replicates=1,
                          iters=800, dtype=np.float64, progress=False,
                          audit_out=audit2, stream_name="audit-ooc")
    assert audit2["cells"] == 1 and audit2["cells_ssn"] == 1
    assert audit2["cells_certified"] == 0


def test_eval_chunk_program_matches_host_concat_formulation():
    """The r5 transfer path (single upload + on-device duplication) must
    be arithmetically IDENTICAL to the pre-r5 host-concatenate loop: the
    chunk program invokes the same two jitted simulators, so outputs are
    bit-equal.  (Merging both sims into one jit was measured to drift
    f32 reduction order ~1 ulp on an accelerator and is forbidden — this test pins
    the formulation.)"""
    import jax
    import numpy as np

    from online_convex_optimization.experiments.evaluate import (
        _eval_chunk_on_device)
    from online_convex_optimization.models.linear import (
        simulate_linear_batch)
    from online_convex_optimization.models.smart import (
        simulate_smart_batch)

    rng = np.random.default_rng(8)
    n, T = 24, 40
    z = rng.normal(size=(n, T, 5)).astype(np.float64)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((n, T)) < 0.5, -1.0, 1.0)
    lengths = rng.integers(10, T + 1, size=n)
    th_theory = np.sqrt(2.0 * lengths).astype(np.float64)
    th_emp = rng.uniform(1.0, 4.0, size=n)
    eta0 = float(np.sqrt(2.0))

    lin_new, sm_new = _eval_chunk_on_device(
        jax.device_put(z), jax.device_put(y), jax.device_put(lengths),
        jax.device_put(th_theory), jax.device_put(th_emp), eta0)

    z2 = np.concatenate([z, z])
    y2 = np.concatenate([y, y])
    len2 = np.concatenate([lengths, lengths])
    flags = np.concatenate([np.zeros(n, np.int32), np.ones(n, np.int32)])
    lin_old = simulate_linear_batch(z2, y2, flags, eta0, len2).regret
    th2 = np.concatenate([th_theory, th_emp])
    sm_old = simulate_smart_batch(z2, y2, th2, eta0, len2).regret

    np.testing.assert_array_equal(np.asarray(lin_new), np.asarray(lin_old))
    np.testing.assert_array_equal(np.asarray(sm_new), np.asarray(sm_old))
