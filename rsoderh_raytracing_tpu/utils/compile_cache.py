"""Where JAX keeps its persistent compilation cache.

A cache only hits when its path is the same from one run to the next
(the path is part of the key), so it is never derived from a temporary
name, a process id or the time.
"""

from __future__ import annotations

import os

CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when it is set, else `.jax_cache/` at
    the checkout root."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(). Call it
    before the first compilation: JAX decides once per process whether
    the cache is in use. Returns the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
