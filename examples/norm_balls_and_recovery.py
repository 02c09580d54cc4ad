"""Round-5 surfaces: non-l2 balls end to end, and preemption-safe sweeps.

1. NON-L2 EXACT FTL (the reference treats l2/linf/l1 as first-class,
   exact_ftl.py:95-102): on contract data the l1 ball certifies EVERY
   prefix a priori (|z_ij| <= ||z_i||_2 <= 1, models/linear_regime.py),
   the linf ball certifies the structured families via canonical
   selection, and general linf data can run either the banded ADMM (the
   production default — best certified coverage at the 2e-4 bar) or the
   accuracy-first linf semismooth Newton
   (ExactFTL(method="ssn", norm="linf"), x64).
2. PREEMPTION-SAFE SWEEP (parallel.sweep.resumable_synthetic_g): the
   per-device seed blocks process in checkpointed slices; a killed host
   resumes from the last slice and the final table is BIT-equal to the
   uninterrupted sweep.

    PYTHONPATH=. JAX_PLATFORMS=cpu python examples/norm_balls_and_recovery.py
"""

import os
import tempfile

import numpy as np

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from online_convex_optimization.data.sequences import (  # noqa: E402
    make_random_iid_stream)
from online_convex_optimization.models.exact_ftl import ExactFTL  # noqa: E402
from online_convex_optimization.models.linear_regime import (  # noqa: E402
    certified_prefix_actions)
from online_convex_optimization.parallel.mesh import make_mesh  # noqa: E402
from online_convex_optimization.parallel.sweep import (  # noqa: E402
    resumable_synthetic_g, sharded_synthetic_g)

# --- 1) l1 ball on contract data: certified a priori ------------------
z, y, _ = make_random_iid_stream(run_seed=7)(60)
acts_l1 = certified_prefix_actions(np.asarray(z, np.float64),
                                   np.asarray(y, np.float64), "l1")
print(f"l1 contract data : all 60 prefixes certified closed-form -> "
      f"{acts_l1 is not None} (zero solver iterations)")

# --- linf on general data: ADMM default vs accuracy-first SSN ---------
rng = np.random.default_rng(0)
zg = 1.5 * rng.normal(size=(40, 5))
yg = np.sign(zg @ rng.normal(size=5))
yg[yg == 0] = 1.0
admm = ExactFTL(d=5, T_max=40, norm="linf", fail_tol=1e-2)
ssn = ExactFTL(d=5, T_max=40, norm="linf", method="ssn", fail_tol=3e-2)
f = lambda x, t: 0.5 * np.abs(zg[:t] @ x - yg[:t]).sum()
a1 = admm.prefix_actions(zg, yg)
a2 = ssn.prefix_actions(zg, yg)
print(f"linf general data: ADMM f(40)={f(a1[40], 40):.6f}  "
      f"SSN f(40)={f(a2[40], 40):.6f}  (two solvers, one program)")

# --- 2) resumable sweep: slices reproduce one-shot bitwise ------------
def stand_in(seed, eta, *, T, block_seqs, alg_flag, interpret):
    key = jax.random.fold_in(jax.random.key(T),
                             jnp.asarray(seed, jnp.int32) >> 20)
    return jax.random.uniform(key, (block_seqs,), jnp.float32) * eta

mesh = make_mesh(1, 1)
with tempfile.TemporaryDirectory() as tmp:
    ck = os.path.join(tmp, "g.npz")
    g_sliced = resumable_synthetic_g(
        mesh, T=32, eta_grid=[1.0, 2.0], blocks_per_device=6,
        blocks_per_step=2, block_seqs=512, checkpoint_path=ck,
        regret_fn=stand_in)
g_once = np.asarray(sharded_synthetic_g(
    mesh, T=32, eta_grid=[1.0, 2.0], blocks_per_device=6, block_seqs=512,
    regret_fn=stand_in), np.float32)
print(f"resumable sweep  : sliced == one-shot bitwise -> "
      f"{bool((g_sliced == g_once).all())}  g={g_sliced}")
