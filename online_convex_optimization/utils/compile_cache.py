"""Persistent XLA compile cache, set up once at each entry point.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here.  Otherwise the cache lives at the fixed ``<repo>/.jax_cache``
(git-ignored): the directory is part of the cache key, so a path that
moved between runs would never hit.
"""

from __future__ import annotations

import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
