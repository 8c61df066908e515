"""Persistent XLA compilation cache.

Every entry point (bench, CLI, ``chip_smoke.py``) calls
:func:`enable_compile_cache` so a process reuses what earlier processes on
the same machine compiled.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and this module sets nothing; otherwise the cache lives at
the fixed ``<checkout>/.jax_cache`` (listed in ``.gitignore``).  A fixed
path matters: the directory is part of what a cache hit has to match.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    # cache every executable: the encoder and engine graphs are many small
    # compiles, each worth keeping
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return str(CHECKOUT_CACHE_DIR)
