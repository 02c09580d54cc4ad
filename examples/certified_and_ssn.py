"""The two exact-FTL solver regimes side by side.

1. CERTIFIED LINEAR REGIME (models/linear_regime.py): on binary-label
   data whose predictions stay in [-1, 1] — checked per prefix by the
   optimality certificate, never assumed — the exact program is linear
   and every prefix minimizer is the closed form w_t/||w_t||.  Zero
   solver iterations; this is the production experiment path.
2. GENERAL REGIME: out-of-contract data (unclipped rows, the regime the
   reference's own smoke test uses) falls back to iterative solvers —
   the batched consensus ADMM, or the semismooth-Newton alternative
   (ExactFTL(method="ssn"), ~30-50 Newton steps where the ADMM needs
   thousands of iterations) — plus the host active-set polish.

    PYTHONPATH=. JAX_PLATFORMS=cpu python examples/certified_and_ssn.py
"""

import numpy as np

from online_convex_optimization.models.exact_ftl import (
    ExactFTL, run_ftl_exact)
from online_convex_optimization.data.sequences import (
    make_random_iid_stream)

# --- certified regime: production contract data -----------------------
z, y, _ = make_random_iid_stream(run_seed=3)(100)
solver = ExactFTL(d=5, T_max=100, norm="l2")
res = run_ftl_exact(z, y, solver=solver)
print(f"contract data : regret {res.regret:.6f} via "
      f"{solver.last_info.get('solver', 'admm')} "
      f"(residual {solver.last_info['residual']:.1e})")

# --- general regime: the reference smoke-test distribution ------------
rng = np.random.default_rng(0)
z2 = 2.0 * rng.normal(size=(100, 5))          # unclipped: ||z|| >> 1
y2 = np.sign(z2 @ rng.normal(size=5))
y2[y2 == 0] = 1.0

admm = ExactFTL(d=5, T_max=100, norm="l2", iters=8000)
r_admm = run_ftl_exact(z2, y2, solver=admm)
ssn = ExactFTL(d=5, T_max=100, norm="l2", method="ssn", iters=300)
r_ssn = run_ftl_exact(z2, y2, solver=ssn)
print(f"general (admm): regret {r_admm.regret:.6f} "
      f"(residual {admm.last_info['residual']:.1e})")
print(f"general (ssn) : regret {r_ssn.regret:.6f} "
      f"(duality gap {ssn.last_info['residual']:.1e})")
assert abs(r_admm.regret - r_ssn.regret) < 1e-4
