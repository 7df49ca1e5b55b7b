"""Persistent XLA compilation cache.

A fresh process otherwise recompiles every jitted render and train step.
The cache keys on HLO + compiler version, so stale entries are never
reused. A directory that moves between runs never hits, so the path is
fixed:

  * ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it (and no
    other directory is configured);
  * otherwise ``.jax_cache/`` at the root of the checkout (listed in
    ``.gitignore``).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses in this environment."""
    return os.environ.get(ENV_VAR) or CHECKOUT_DIR


def enable() -> str:
    """Turn the persistent cache on; returns its directory."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
