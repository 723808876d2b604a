"""JAX's persistent compilation cache: one place that decides where it is.

Every entry point (bench.py, chip_smoke.py, tools/) calls
:func:`enable_compile_cache` before its first compile. When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads that directory itself and
nothing here names another; otherwise the cache lives at the fixed
``<repo>/.jax_cache`` (the path is part of the cache key, so it never
moves between runs).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> Path:
    """The directory the persistent compilation cache uses."""
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else REPO_CACHE


def enable_compile_cache() -> Path:
    """Point JAX's persistent cache at :func:`compile_cache_dir` and cache
    every compile that takes a second or more. Returns the directory."""
    import jax

    if ENV_VAR not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return compile_cache_dir()
