"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices (so multi-device
sharding is exercised without a multi-GPU host) and with x64 enabled (the
parity bar is against the reference's float64 Numba semantics).
Environment variables must be set before JAX initializes its backends,
hence this conftest.

Tests that need the GPU (compiled Triton kernels, which have no CPU
lowering) carry the ``gpu`` marker.  Whether a GPU is present is decided
inside the ``_gpu_gate`` fixture when such a test runs, never at import or
collection, so every worker collects the same tests.  On a GPU machine,
``OCO_TESTS_GPU=1 python -m pytest tests/ -m gpu`` leaves the platform to
JAX and runs them.
"""

import os
import sys

_USE_GPU = os.environ.get("OCO_TESTS_GPU") == "1"
if not _USE_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# The env write above can come too late when a pytest plugin imported jax
# first; the config update is authoritative.
if not _USE_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skipped elsewhere)")
    config.addinivalue_line(
        "markers", "slow: multi-process / long-running tests")


@pytest.fixture(autouse=True)
def _gpu_gate(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; run with OCO_TESTS_GPU=1 on a GPU machine")
