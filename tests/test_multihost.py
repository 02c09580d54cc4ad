"""True multi-process distributed smoke test (2 simulated hosts on CPU).

Spawns two fresh Python processes that form a JAX distributed cluster over
a local coordinator with gloo CPU collectives, each owning 2 virtual
devices, and runs the pod-sweep worker.  Verifies both hosts agree on the
globally psum/pmax-reduced statistics and that they match a single-process
run of the same total workload.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(proc_id, port, n_proc, devs_per_proc, hyper=1, host_axis=False):
    env = {
        **os.environ,
        # A pure-CPU multi-device process, whatever accelerator the
        # parent environment would pick.
        "PYTHONPATH": REPO,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={devs_per_proc}",
    }
    return subprocess.Popen(
        [sys.executable, "-m",
         "online_convex_optimization.parallel.multihost",
         "--t", "128", "--per-device-batch", "64",
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n_proc), "--process-id", str(proc_id),
         "--hyper", str(hyper)] + (["--host-axis"] if host_axis else []),
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.mark.slow
def test_two_process_sweep_agrees():
    port = _free_port()
    procs = [_spawn(i, port, 2, 2) for i in range(2)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-2000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))

    a, b = outs
    assert a["n_global_devices"] == b["n_global_devices"] == 4
    assert a["n_local_devices"] == b["n_local_devices"] == 2
    assert a["total_scenarios"] == 4 * 64
    # Cross-host reductions gave identical global statistics.
    assert a["g_max"] == pytest.approx(b["g_max"], rel=1e-6)
    assert a["mean_regret"] == pytest.approx(b["mean_regret"], rel=1e-6)

    # A single process with the same 4 global devices reproduces the stats
    # (same per-device keys, no cross-process collectives involved).
    solo_proc = _spawn(0, _free_port(), 1, 4)
    stdout, stderr = solo_proc.communicate(timeout=300)
    assert solo_proc.returncode == 0, stderr[-2000:]
    solo = json.loads(stdout.strip().splitlines()[-1])
    assert solo["g_max"] == pytest.approx(a["g_max"], rel=1e-5)
    assert solo["mean_regret"] == pytest.approx(a["mean_regret"], rel=1e-5)


@pytest.mark.slow
def test_two_process_two_axis_sweep():
    """(data, hyper) 2-axis mesh across 2 processes: per-eta statistics
    reduced over the data axis agree across hosts and with a solo run."""
    port = _free_port()
    procs = [_spawn(i, port, 2, 2, hyper=2) for i in range(2)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-2000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))

    a, b = outs
    assert a["mesh"] == b["mesh"] == [2, 2]
    assert len(a["g_max_by_eta"]) == 2
    assert a["eta_grid"][1] == pytest.approx(2 * a["eta_grid"][0], rel=1e-6)
    np.testing.assert_allclose(a["g_max_by_eta"], b["g_max_by_eta"],
                               rtol=1e-6)
    np.testing.assert_allclose(a["mean_by_eta"], b["mean_by_eta"], rtol=1e-6)

    solo_proc = _spawn(0, _free_port(), 1, 4, hyper=2)
    stdout, stderr = solo_proc.communicate(timeout=300)
    assert solo_proc.returncode == 0, stderr[-2000:]
    solo = json.loads(stdout.strip().splitlines()[-1])
    np.testing.assert_allclose(solo["g_max_by_eta"], a["g_max_by_eta"],
                               rtol=1e-5)
    np.testing.assert_allclose(solo["mean_by_eta"], a["mean_by_eta"],
                               rtol=1e-5)


@pytest.mark.slow
def test_two_process_three_axis_host_mesh():
    """3-axis (host, data, hyper) mesh across 2 REAL processes (VERDICT
    r4 task 7): the process boundary is the leading mesh axis, per-host
    psum/pmax rides gloo while the intra-host reduction stays local.
    Per-eta statistics agree across hosts and with a solo 2-axis run
    (the key->device assignment is layout-invariant by construction)."""
    port = _free_port()
    procs = [_spawn(i, port, 2, 2, hyper=2, host_axis=True)
             for i in range(2)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-2000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))

    a, b = outs
    assert a["mesh"] == b["mesh"] == [2, 1, 2]
    assert a["axes"] == ["host", "data", "hyper"]
    np.testing.assert_allclose(a["g_max_by_eta"], b["g_max_by_eta"],
                               rtol=1e-6)
    np.testing.assert_allclose(a["mean_by_eta"], b["mean_by_eta"],
                               rtol=1e-6)

    solo_proc = _spawn(0, _free_port(), 1, 4, hyper=2)
    stdout, stderr = solo_proc.communicate(timeout=300)
    assert solo_proc.returncode == 0, stderr[-2000:]
    solo = json.loads(stdout.strip().splitlines()[-1])
    np.testing.assert_allclose(solo["g_max_by_eta"], a["g_max_by_eta"],
                               rtol=1e-5)
    np.testing.assert_allclose(solo["mean_by_eta"], a["mean_by_eta"],
                               rtol=1e-5)


def _spawn_handoff(proc_id, port, n_proc):
    env = {
        **os.environ,
        "PYTHONPATH": REPO,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=1",
    }
    return subprocess.Popen(
        [sys.executable, "-m",
         "online_convex_optimization.parallel.multihost",
         "--mode", "stream-handoff", "--t", "64", "--per-device-batch", "8",
         "--chunks", "8", "--split", "3",
         "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", str(n_proc), "--process-id", str(proc_id)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.mark.slow
def test_cross_process_streaming_handoff_bitwise():
    """Sequence parallelism over DCN (SURVEY §5): process 0 advances the
    streaming carry through chunks 0..2, ships it to process 1 over the
    gloo wire, process 1 finishes — and the result matches each host's
    own single-process run of the full stream BITWISE."""
    port = _free_port()
    procs = [_spawn_handoff(i, port, 2) for i in range(2)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-2000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    a, b = outs
    for o in (a, b):
        assert o["mode"] == "stream-handoff"
        assert o["bitwise_cum"], "hand-off cum_loss != single-process run"
        assert o["bitwise_regret"]
    assert a["cum_loss"] == b["cum_loss"]      # both hosts agree exactly
    assert a["regret"] == b["regret"]
