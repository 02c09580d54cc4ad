"""The reference's workflow on the drop-in API (algorithms.py surface).

Runs a miniature version of /root/reference/driver.py's pipeline: estimate
the empirical worst-case threshold table g(T), then compare FTRL / FTL /
SMART / SMART(empirical g) on one sequence family.

    PYTHONPATH=. JAX_PLATFORMS=cpu python examples/reference_workflow.py
"""

import numpy as np

import online_convex_optimization as oco
from online_convex_optimization.data import CASES

T_GRID = (100, 200, 300)
g_emp = oco.empirical_worst_case_thresholds(T_GRID, runs=20)
print("g(T):", {t: round(v, 3) for t, v in g_emp.items()})

sampler = CASES["Massart noise 10%"](run_seed=2025)
for T in T_GRID:
    z, y, _ = sampler(T, rep=0)
    print(f"T={T}: FTRL={oco.simulate_alg(z, y, 0, 2**0.5):7.3f}  "
          f"FTL={oco.simulate_alg(z, y, 1, 2**0.5):7.3f}  "
          f"SMART={oco.simulate_SMART(z, y):7.3f}  "
          f"EMP={oco.simulate_empirical_g_SMART(z, y, g_emp[T]):7.3f}")
