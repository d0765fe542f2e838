"""Persistent XLA compilation cache placement for the entry points.

A cold 1M-row build compiles a few dozen programs; keeping them across
processes turns the next run's compiles into loads. The directory is part of
each entry's key, so it must not move between runs:

  - ``JAX_COMPILATION_CACHE_DIR`` set (or a directory already configured by
    the embedding program): JAX uses it and this module sets no other;
  - otherwise: ``<repo root>/.jax_cache`` (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on for every program that takes at least
    half a second to compile; returns the directory in use."""
    import jax

    path = os.environ.get(ENV_VAR) or jax.config.jax_compilation_cache_dir
    if not path:
        path = str(REPO_CACHE_DIR)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
