"""Exact leaders: hinge-loss exact FTL (batched ADMM + active-set polish)
and the quadratic-loss ball-constrained least-squares track.

    PYTHONPATH=. JAX_PLATFORMS=cpu python examples/exact_oracles.py
"""

import numpy as np

from online_convex_optimization.data.sequences import (
    make_random_iid_stream, make_regression_stream)
from online_convex_optimization.models.exact_ftl import (
    run_ftl_exact, run_ftrl)
from online_convex_optimization.models.quadratic import simulate_quadratic

z, y, _ = make_random_iid_stream(run_seed=7)(80)
exact = run_ftl_exact(z, y, norm="l2")       # all prefixes, one device ADMM
ftrl = run_ftrl(z, y, eta0=1.0)              # FTRL vs the exact comparator
print(f"hinge exact FTL: regret {exact.regret:.4f} "
      f"(FTRL vs same comparator: {ftrl.regret:.4f})")

zq, yq, _ = make_regression_stream(sigma=0.1, run_seed=7)(500)
q_ftl = simulate_quadratic(zq, yq, alg="ftl")
q_ftrl = simulate_quadratic(zq, yq, alg="ftrl", eta0=1.0)
print(f"quadratic exact FTL: regret {q_ftl.regret:.4f} "
      f"(FTRL: {q_ftrl.regret:.4f})")
