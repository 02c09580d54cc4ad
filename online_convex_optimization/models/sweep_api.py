"""Hyperparameter sweep front-ends (BASELINE.json config 2: "FTRL with L2
regularization, learning-rate sweep over 64 settings via vmap").

The reference has no sweep machinery at all — eta0 and the SMART threshold
are constants (algorithms.py:123-125).  Here grids are first-class batch
axes: a sweep is ONE compiled program evaluating the (sequence x setting)
cross product, optionally sharded over a device mesh.
"""

from __future__ import annotations

from typing import Optional, Union

import jax.numpy as jnp
import numpy as np

from online_convex_optimization.models.linear import simulate_linear_batch
from online_convex_optimization.models.smart import simulate_smart_batch
from online_convex_optimization.ops.pallas_game import (
    eta_sweep_packed,
    kernel_envelope,
    pack_sequences,
    unpack_result,
    use_kernels,
)
from online_convex_optimization.ops.pallas_smart import smart_sweep_packed


def _cross(z, y, n_grid):
    """Tile B sequences n_grid times -> (B*n_grid, ...) cross product."""
    B = z.shape[0]
    z_rep = jnp.repeat(z, n_grid, axis=0)
    y_rep = jnp.repeat(y, n_grid, axis=0)
    return z_rep, y_rep, B


def _mask_tails(z, y, length):
    """Zero out padded tails so they are inert in the packed kernels."""
    if length is None:
        return z, y
    T = z.shape[1]
    valid = jnp.arange(T)[None, :] < jnp.asarray(length)[:, None]
    return (jnp.where(valid[..., None], z, 0.0),
            jnp.where(valid, y, 0.0))


def ftrl_eta_sweep(z, y, eta_grid, *, alg_flag: int = 0,
                   length: Optional[np.ndarray] = None,
                   use_kernel: Union[str, bool] = "auto",
                   interpret: bool = False) -> jnp.ndarray:
    """Regret of every (sequence, eta0) pair.

    Args:
      z: (B, T, d); y: (B, T); eta_grid: (E,).
      use_kernel: True / False / "auto" (the kernel on the GPU inside its
        feature-width envelope, FTRL only).  The kernel path runs the
        settings as the kernel grid's second axis (eta_sweep_packed), so
        the data is not duplicated E times as in the scan cross product.
    Returns: (B, E) regrets.
    """
    z = jnp.asarray(z)
    y = jnp.asarray(y)
    if use_kernel == "auto":
        use_kernel = (use_kernels() and alg_flag == 0
                      and kernel_envelope(z.shape[2]) is None)
    if use_kernel:
        assert alg_flag == 0, "kernel sweep path is FTRL-only"
        zm, ym = _mask_tails(z, y, length)
        z_pack, y_pack, B = pack_sequences(zm, ym)
        reg = eta_sweep_packed(z_pack, y_pack,
                               jnp.asarray(eta_grid, jnp.float32),
                               interpret=interpret)           # (E, Bp)
        return unpack_result(reg, B).T                        # (B, E)
    eta_grid = jnp.asarray(eta_grid, z.dtype)
    E = eta_grid.shape[0]
    z_rep, y_rep, B = _cross(z, y, E)
    etas = jnp.tile(eta_grid, B)
    len_rep = None if length is None else jnp.repeat(jnp.asarray(length), E)
    res = simulate_linear_batch(z_rep, y_rep, alg_flag, etas, len_rep)
    return res.regret.reshape(B, E)


def smart_threshold_sweep(z, y, thresh_grid, *, eta0: float,
                          length: Optional[np.ndarray] = None,
                          use_kernel: Union[str, bool] = "auto",
                          interpret: bool = False) -> jnp.ndarray:
    """Regret of every (sequence, theta_thresh) pair -> (B, G).

    The kernel path (auto on the GPU inside the width envelope) runs the
    thresholds as the kernel grid's second axis
    (ops/pallas_smart.py::smart_sweep_packed): no B x G data duplication,
    unlike the scan cross product below.
    """
    z = jnp.asarray(z)
    y = jnp.asarray(y)
    if use_kernel == "auto":
        use_kernel = use_kernels() and kernel_envelope(z.shape[2]) is None
    if use_kernel:
        zm, ym = _mask_tails(z, y, length)
        z_pack, y_pack, B = pack_sequences(zm, ym)
        reg, _ = smart_sweep_packed(z_pack, y_pack,
                                    jnp.asarray(thresh_grid, jnp.float32),
                                    float(eta0), interpret=interpret)
        return unpack_result(reg, B).T                        # (B, G)
    thresh_grid = jnp.asarray(thresh_grid, z.dtype)
    G = thresh_grid.shape[0]
    z_rep, y_rep, B = _cross(z, y, G)
    ths = jnp.tile(thresh_grid, B)
    etas = jnp.full((B * G,), eta0, z.dtype)
    len_rep = None if length is None else jnp.repeat(jnp.asarray(length), G)
    res = simulate_smart_batch(z_rep, y_rep, ths, etas, len_rep)
    return res.regret.reshape(B, G)
