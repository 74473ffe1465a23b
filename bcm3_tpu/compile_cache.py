"""Where compiled XLA programs are kept between processes."""

from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here. Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache`` (a fixed path, because the directory is part
    of the cache key)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
