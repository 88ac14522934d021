"""Where JAX keeps its persistent compilation cache for this package's entry
points (the CLI, bench.py, chip_smoke.py and the tools).

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing here
overrides it (set to the empty string, it keeps the cache off). Otherwise
the cache goes to a fixed directory inside the checkout, `<repo>/.jax_cache`
(git-ignored): the path is part of what a cache hit needs, so it never
moves between runs.
"""

from __future__ import annotations

import os

__all__ = ["cache_dir", "enable_compile_cache"]

_ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def cache_dir() -> str:
    """The directory the persistent compilation cache uses ("" = off)."""
    if _ENV in os.environ:
        return os.environ[_ENV]
    return os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns it."""
    import jax

    path = cache_dir()
    if _ENV not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
