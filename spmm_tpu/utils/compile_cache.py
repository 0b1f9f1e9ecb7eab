"""Persistent XLA compile cache location.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set this module
changes nothing.  Otherwise scripts keep their cache at one fixed path inside
the checkout, ``.jax_cache/`` (git-ignored): the path is part of the cache
key, so a directory that moves between runs never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at the fixed in-checkout path
    unless ``JAX_COMPILATION_CACHE_DIR`` is set; returns the directory in
    use."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
