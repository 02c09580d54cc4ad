"""Batched kernel evaluation + hyperparameter sweeps.

Evaluates thousands of sequences and full (eta / SMART-threshold) tuning
grids in single device programs.  On the GPU the sweeps run as the
kernel grid's second axis (no data duplication); elsewhere the same APIs
take the scan (or pass use_kernel=True + interpret=True for the kernel's
code path in the Pallas interpreter).

    PYTHONPATH=. JAX_PLATFORMS=cpu python examples/kernel_batch_sweep.py
"""

import numpy as np

from online_convex_optimization.data.device import random_game_batch
from online_convex_optimization.models.sweep_api import (
    ftrl_eta_sweep, smart_threshold_sweep)

import jax

B, T = 512, 128
z, y = random_game_batch(jax.random.key(0), B, T)

etas = np.linspace(0.1, 3.0, 16, dtype=np.float32)
reg_eta = np.asarray(ftrl_eta_sweep(z, y, etas))          # (B, 16)
best_eta = etas[np.argmin(reg_eta.mean(axis=0))]
print(f"eta sweep: mean regret per eta -> best eta0 = {best_eta:.3f}")

ths = np.asarray([2.0, 8.0, np.sqrt(2.0 * T), 1e9], np.float32)
reg_th = np.asarray(smart_threshold_sweep(z, y, ths, eta0=2**0.5))
print("SMART threshold sweep (mean regret):",
      dict(zip(np.round(ths, 1), np.round(reg_th.mean(axis=0), 3))))
