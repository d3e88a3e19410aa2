"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here sets another directory. Otherwise the cache lives at a fixed path
inside the checkout, ``.jax_cache/`` (listed in ``.gitignore``); a fixed
path is part of what lets a later run find the entries again.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _configured() -> str:
    return jax.config.jax_compilation_cache_dir or ""


def enable_compile_cache(subdir: str = "") -> str:
    """Turn on the persistent compile cache; returns its directory. A
    directory already placed (by the variable, or by an earlier call in
    this process) is kept. ``subdir`` only applies to the in-checkout
    default."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    if _configured():
        return _configured()
    path = os.path.normpath(os.path.join(CHECKOUT, ".jax_cache", subdir))
    jax.config.update("jax_compilation_cache_dir", path)
    return path
