"""JAX's persistent compilation cache at one fixed place.

A cold process compiles every jitted step and kernel again; with the cache
on, a later process with the same code and shapes loads them instead. The
cache key includes the directory, so the directory must not move between
runs.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    is set here. Otherwise the cache goes to ``<repo root>/.jax_cache``.
    Call before the first compilation.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
