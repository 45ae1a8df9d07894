"""Persistent compilation cache placement.

`JAX_COMPILATION_CACHE_DIR`, when set, decides where compiled programs are
kept; otherwise they go to `<checkout>/.jax_cache`, a fixed path (the path is
part of the cache key, so a moving directory never hits).  The live JAX
config is updated rather than the environment, so the call works even when
JAX was imported first.  Every compile is cached (threshold 0 s): the
north-star slot programs are large and a fresh process recompiles them all.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Point JAX's persistent compilation cache at `cache_dir`, else at
    $JAX_COMPILATION_CACHE_DIR, else at the checkout's `.jax_cache`."""
    import jax

    if cache_dir is None:
        cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return cache_dir
