"""Long-horizon streaming with checkpoint/resume.

Feeds an arbitrarily long sequence through the game in chunks; the O(B d)
carry checkpoints mid-run and resumes.  On the GPU the chunks advance
through the kernel (``StreamingKernelGame``, whose carry holds the
identity statistics, so the comparator needs no replay pass); elsewhere
through the XLA scan (``StreamingGame``, which replays for the
comparator).

    PYTHONPATH=. JAX_PLATFORMS=cpu python examples/streaming_long_horizon.py
"""

import os
import tempfile

import numpy as np

import jax

from online_convex_optimization.models.streaming import (
    StreamingGame, StreamingKernelGame)
from online_convex_optimization.ops.pallas_game import use_kernels
from online_convex_optimization.utils.checkpointing import (
    load_pytree, save_pytree)

B, d, CT, N = 128, 5, 64, 8          # total horizon T = 512
kernel = use_kernels()
game = (StreamingKernelGame(B, d, eta0=2**0.5) if kernel
        else StreamingGame(B, d, eta0=2**0.5))
rng = np.random.default_rng(0)
chunks = []
for i in range(N):
    z = rng.normal(size=(CT, B, d)).astype(np.float32)
    z /= np.maximum(1.0, np.linalg.norm(z, axis=-1, keepdims=True))
    y = np.where(rng.random((CT, B)) < 0.5, -1.0, 1.0).astype(np.float32)
    game.feed(z, y)
    chunks.append((z, y))
    if i == N // 2:                  # mid-run checkpoint round-trip
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "carry.npz")
            save_pytree(path, game.carry_state())
            game.resume(load_pytree(path, game.carry_state()))
res = game.result() if kernel else game.result(chunks)
print(f"{jax.default_backend()} T={CT * N}: mean regret {np.asarray(res.regret).mean():.3f} "
      f"(cum {np.asarray(res.cum_loss).mean():.1f}, "
      f"comp {np.asarray(res.comp_loss).mean():.1f})")
