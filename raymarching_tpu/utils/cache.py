"""Persistent XLA compile-cache placement, shared by every entry point.

Kernel compiles for the demo scene take seconds to minutes, so every
entry point (``cli.main``, ``serve.main``, ``bench.py``, ``chip_smoke.py``,
``benchmarks/ladder.py``, ``examples/*``) calls ``setup_compile_cache``
first.  A ``JAX_COMPILATION_CACHE_DIR`` in the environment wins and JAX
reads it itself; otherwise the cache lives at the fixed
``<checkout>/.jax_cache`` (listed in ``.gitignore``).  The path is part of
the cache's key, so it is never derived from a temporary directory, a
process id or the time.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"


def setup_compile_cache() -> str:
    """Place JAX's persistent compile cache; returns the directory used."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
