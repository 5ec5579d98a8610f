"""Persistent XLA compile cache for the entry points (CLI, bench, chip smoke).

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing is
set here. Otherwise the cache goes to `<checkout>/.jax_cache`: one fixed
path, because the directory is part of the cache's key and a moving one
never hits.
"""

from __future__ import annotations

import os

import jax

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
