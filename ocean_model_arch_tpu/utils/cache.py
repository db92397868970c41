"""Persistent XLA compilation cache setup.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and nothing is set here. Otherwise the cache lives at a fixed path
inside the checkout (``<checkout>/.jax_cache``, ignored by git): the path
is part of the cache key, so a fixed one lets later runs of the same
checkout find what earlier runs compiled."""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(CHECKOUT_CACHE, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return CHECKOUT_CACHE
