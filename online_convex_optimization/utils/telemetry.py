"""Run telemetry embedded in every timed artifact: which device ran it,
and how much of its wall time went to compiling.

- **Device identity**: platform, ``device_kind``, device count and (on
  a GPU) the power limit, so a number can never be read as coming from
  another machine.
- **Compile telemetry** (``install`` + ``compile_stats``): a
  ``jax.monitoring`` duration listener accumulates the count and
  cumulative seconds of backend compiles (plus tracing and lowering)
  seen by this process, so compile time is reported as set-up and not
  mistaken for compute.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional

_STATS = {"compile_count": 0, "compile_seconds": 0.0,
          "trace_seconds": 0.0, "lowering_seconds": 0.0}
_INSTALLED = False


def install() -> None:
    """Register the compile-duration listener (idempotent).

    Call before the first jit of a timed region; events compiled before
    installation are not counted.  The listener is process-global;
    accumulation is monotone, so callers diff snapshots.
    """
    global _INSTALLED
    if _INSTALLED:
        return
    import jax.monitoring as monitoring

    def _on_duration(name: str, dur: float, **kw) -> None:
        if name.endswith("backend_compile_duration"):
            _STATS["compile_count"] += 1
            _STATS["compile_seconds"] += dur
        elif name.endswith("jaxpr_trace_duration"):
            _STATS["trace_seconds"] += dur
        elif name.endswith("jaxpr_to_mlir_module_duration"):
            _STATS["lowering_seconds"] += dur

    monitoring.register_event_duration_secs_listener(_on_duration)
    _INSTALLED = True


def compile_stats() -> dict:
    """Cumulative compile telemetry since ``install`` (copy)."""
    return dict(_STATS)


def device_identity() -> dict:
    """Platform, device kind and count of the default backend, and on a
    GPU the card's power limit (a card below its maximum runs slower)."""
    import jax

    dev = jax.devices()[0]
    out = {"platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices())}
    if dev.platform == "gpu" and shutil.which("nvidia-smi"):
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    return out


def snapshot(since: Optional[dict] = None) -> dict:
    """One dict for embedding in a timed artifact.

    ``since``: a ``compile_stats()`` taken at the start of the timed
    region — compile fields are reported as the delta, so the record
    describes *this* run, not process history.
    """
    out = device_identity()
    base = since or {}
    for k, v in compile_stats().items():
        out[k] = v - base.get(k, 0)
    return out
