"""One place that sets JAX's persistent compilation cache."""
from __future__ import annotations

import os

import jax

__all__ = ["compile_cache_dir", "enable_compile_cache"]

# Inside the checkout and listed in .gitignore. A fixed path: the cache key
# includes it, so a directory that moves between runs never hits.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def compile_cache_dir(environ=None):
    """``JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's
    ``.jax_cache``."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache():
    """Point JAX's compilation cache at ``compile_cache_dir()``.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and
    nothing is changed. Returns the directory in use.
    """
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
