"""Checkpointing, logging, and profiling utilities."""

import json
import os

import jax.numpy as jnp
import numpy as np

from online_convex_optimization.utils.checkpointing import (
    load_pytree,
    save_pytree,
)
from online_convex_optimization.utils.logging_utils import (
    get_logger,
    log_metrics,
)
from online_convex_optimization.utils.profiling import measure


def test_npz_pytree_roundtrip(tmp_path):
    tree = {"theta": jnp.arange(6.0).reshape(2, 3),
            "stats": (jnp.asarray(3.0), jnp.asarray([1.0, 2.0]))}
    path = str(tmp_path / "state.npz")
    save_pytree(path, tree)
    got = load_pytree(path, tree)
    np.testing.assert_array_equal(got["theta"], np.asarray(tree["theta"]))
    np.testing.assert_array_equal(got["stats"][1], [1.0, 2.0])


def test_orbax_pytree_roundtrip(tmp_path):
    tree = {"g": jnp.asarray([1.5, 2.5]), "n": jnp.asarray(7)}
    path = str(tmp_path / "ckpt_dir")
    save_pytree(path, tree)
    got = load_pytree(path, tree)
    np.testing.assert_array_equal(np.asarray(got["g"]), [1.5, 2.5])


def test_log_metrics_jsonl(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    log_metrics(path, {"metric": "x", "value": 1})
    log_metrics(path, {"metric": "y", "value": 2})
    lines = [json.loads(line) for line in open(path)]
    assert [r["metric"] for r in lines] == ["x", "y"]
    assert all("ts" in r for r in lines)
    get_logger().info("logger smoke")


def test_measure_counts_steps():
    timing = measure(lambda: jnp.sum(jnp.arange(100.0)), warmup=1, runs=2)
    assert timing.best_s > 0
    assert timing.steps_per_s(1000) == 1000 / timing.best_s
