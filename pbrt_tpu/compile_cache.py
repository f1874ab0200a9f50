"""Where JAX keeps its persistent compile cache.

`JAX_COMPILATION_CACHE_DIR` wins when it is set. Otherwise the cache is
the fixed directory `<checkout>/.jax_cache` (git-ignored), so that a
later run from the same checkout finds what an earlier one compiled.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at `cache_dir()`; returns it."""
    import jax

    d = cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    return d
