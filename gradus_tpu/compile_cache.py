"""Where JAX keeps its persistent compilation cache for this checkout.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and nothing
here overrides it. Otherwise the cache lives in ``<checkout>/.jax_cache``
(listed in ``.gitignore``), found from this file's location, so every entry
point of one checkout shares one cache whatever the working directory.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["compile_cache_dir", "enable_compile_cache"]

_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` if set, else
    ``<checkout>/.jax_cache``."""
    env = os.environ.get(_ENV)
    if env:
        return env
    return str(Path(__file__).resolve().parent.parent / ".jax_cache")


def enable_compile_cache(min_compile_time_secs: float | None = None) -> str:
    """Turn the persistent cache on and return its directory. Sets the
    directory in JAX's config only when the environment does not name one.
    ``min_compile_time_secs`` (optional) is the least compile time worth
    writing an entry for."""
    import jax

    if not os.environ.get(_ENV):
        jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    if min_compile_time_secs is not None:
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
        )
    return compile_cache_dir()
