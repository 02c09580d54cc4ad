"""Device mesh construction and multi-host initialization.

The reference is single-process/single-thread (SURVEY.md §2.5); scenario
parallelism is new capability.  The mesh abstraction here is deliberately
simple: OCO scenario sweeps are embarrassingly parallel over (sequence,
hyperparameter) tuples, so a 1-2 axis mesh suffices —

  - ``data``  axis: shards the scenario batch (sequences) — NVLink
    between the cards of a host, the network across hosts;
  - ``hyper`` axis: optionally shards a hyperparameter grid (eta0 /
    theta_thresh sweeps).

Reductions that cross shards (max for g(T), mean/SEM sufficient statistics)
are XLA collectives (``pmax`` / ``psum``) inserted by shard_map programs in
``parallel.sweep``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
HYPER_AXIS = "hyper"
HOST_AXIS = "host"      # 3-axis meshes: (host, data, hyper)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (no-op single host).

    Pass the coordinator address (``host:port``), process count and id;
    nothing discovers them from the environment.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)


def make_mesh(n_data: Optional[int] = None, n_hyper: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ``(data, hyper)`` mesh over the available devices.

    Defaults to all devices on the data axis.  The cards of a host reach
    each other all to all at the same rate, so the mesh follows the
    algorithm alone: data axis fastest-varying, hyper axis outer.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_data is None:
        n_data = n // n_hyper
    need = n_data * n_hyper
    if need > n:
        raise ValueError(f"mesh {n_data}x{n_hyper} needs {need} devices, "
                         f"only {n} available")
    dev_array = np.asarray(devices[:need]).reshape(n_hyper, n_data).T
    return Mesh(dev_array, (DATA_AXIS, HYPER_AXIS))


def make_mesh3(n_host: int, n_data: int, n_hyper: int = 1,
               devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """A 3-axis ``(host, data, hyper)`` mesh (VERDICT r4 task 7).

    On several hosts the leading axis maps to the slowest-varying device
    dimension — host-crossing collectives (the final pmax/psum of a
    sweep) cross the network once while the inner (data, hyper)
    collectives stay within a host.  Axis-agnostic sweep reductions (parallel.sweep) reduce over
    every mesh axis, so 2- and 3-axis meshes run the same programs.
    """
    devices = list(devices if devices is not None else jax.devices())
    need = n_host * n_data * n_hyper
    if need > len(devices):
        raise ValueError(f"mesh {n_host}x{n_data}x{n_hyper} needs {need} "
                         f"devices, only {len(devices)} available")
    dev_array = np.asarray(devices[:need]).reshape(n_host, n_data, n_hyper)
    return Mesh(dev_array, (HOST_AXIS, DATA_AXIS, HYPER_AXIS))


def scenario_sharding(mesh: Mesh, batch_axis: int = 0) -> NamedSharding:
    """Sharding that splits a scenario batch across the whole mesh."""
    spec = [None] * (batch_axis + 1)
    spec[batch_axis] = (DATA_AXIS, HYPER_AXIS)
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
