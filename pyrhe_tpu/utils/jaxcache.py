"""Persistent XLA compilation cache.

Where JAX_COMPILATION_CACHE_DIR is set, JAX itself keeps the cache there
and nothing here overrides it. Otherwise the cache lives in one fixed
directory inside the checkout (`<repo>/.jax_cache`, git-ignored): the
directory is part of the cache key, so a fixed path is what lets a
repeat run with identical graphs skip compilation.
"""
from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_done = False


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR


def enable_persistent_compilation_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
