"""Persistent XLA compilation cache, placed from outside the program.

The cache directory is part of the cache's key, so it must not move
between runs: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it,
otherwise one fixed directory inside the checkout (listed in .gitignore).
"""
from __future__ import annotations

import os
from pathlib import Path

#: checkout-local default, used when JAX_COMPILATION_CACHE_DIR is unset
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> Path:
    """The directory :func:`enable_compile_cache` uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_DIR


def enable_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`.

    Call before anything compiles. Failures propagate: a cache that cannot
    be created is an error of the deployment, not something to run past.
    """
    import jax

    path = compile_cache_dir()
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    return path
