"""Persistent XLA compile cache for the entry points (CLI, bench.py,
chip_smoke.py) on the GPU.

JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is unset the cache goes
to a fixed directory in the checkout. The directory is part of the cache's
key, so it must not move between runs (no temporary names, pids or times).
CPU runs (the tests) keep no persistent cache: their programs are cheap to
compile and their executables large.
"""
from __future__ import annotations

import os
from typing import Optional

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(backend: Optional[str] = None) -> Optional[str]:
    """Point JAX's persistent compile cache at its directory on the gpu
    backend; returns the directory in use (None: no persistent cache)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    if (backend or jax.default_backend()) != "gpu":
        return None
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
