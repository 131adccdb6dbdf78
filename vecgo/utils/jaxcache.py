"""Persistent XLA compilation cache.

A cold process compiles every kernel configuration it meets (tens of
programs for a graph build). The persistent cache lets a later process on the
same machine load them instead.

Where the cache lives:
- `JAX_COMPILATION_CACHE_DIR` set: JAX reads it itself and this module sets
  nothing.
- otherwise: `.jax_cache/` at the root of the checkout (listed in
  `.gitignore`). The path is fixed: it is part of the cache key, so a path
  that changed between processes would never hit.
"""

import os

_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(_ENV) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = cache_dir()
    if os.environ.get(_ENV):
        return path
    import jax

    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
