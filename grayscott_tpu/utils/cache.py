"""Persistent compilation cache.

Analog of the reference's ``PersistentPipelineCache`` — compiled GPU
pipelines cached on disk (compute/shared/src/gpu/context/cache.rs:23-101).
Here XLA's persistent compilation cache takes that role: a later process
loads the compiled step instead of compiling it again.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR``, when set: JAX reads it by itself, and
  this module sets no other directory;
- otherwise the fixed ``.jax_cache/`` directory inside the checkout
  (listed in ``.gitignore``). The path is part of the cache's key, so it
  must not move between runs.
"""

from __future__ import annotations

import os

#: The cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)

_compilation_cache_enabled = False


def compilation_cache_dir() -> str:
    """The directory :func:`enable_compilation_cache` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Every executable is cached, however fast it compiled. The CPU test
    suite sets ``GRAYSCOTT_NO_PERSISTENT_CACHE=1`` (tests/conftest.py),
    which makes this a no-op that still returns the path: the suite's
    thousands of tiny executables do not belong in the checkout's cache.
    """
    global _compilation_cache_enabled
    path = compilation_cache_dir()
    if os.environ.get("GRAYSCOTT_NO_PERSISTENT_CACHE"):
        return path
    if not _compilation_cache_enabled:
        import jax

        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(path, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        _compilation_cache_enabled = True
    return path
