"""Persistent XLA compilation cache.

Large programs (the padded force at N=1M unrolls M2M/L2L over every tree
level) take minutes to compile; the persistent cache turns a re-run of an
identical program into a disk hit.  The cache lives where
JAX_COMPILATION_CACHE_DIR says when it is set, and otherwise at a fixed
path inside the checkout (`.jax_cache`, listed in .gitignore): the path is
part of the cache key, so a directory that moves never hits.  Source
paths under the checkout are written relative to it into compiled code
(the Pallas kernels embed them), so a checkout in another directory still
hits.  Call :func:`enable_compile_cache` before building engines; it is
idempotent.
"""

from __future__ import annotations

import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPO_CACHE_DIR = os.path.join(REPO, ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on at :func:`cache_dir`; returns it."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_hlo_source_file_canonicalization_regex",
                      "^" + re.escape(REPO + os.sep))
    return path
