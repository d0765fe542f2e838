"""Test harness configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding paths
(parallel/) compile and execute without GPUs, per the reference test
strategy translated in SURVEY §4: multi-host tests runnable on CPU via
``XLA_FLAGS=--xla_force_host_platform_device_count``.

``jax.config.update("jax_platforms", "cpu")`` below pins the backend after
import, so the suite runs on the CPU even on a host with a GPU, and no test
process takes a card. What needs the card is a phase of ``chip_smoke.py``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache, one directory PER xdist worker: a program
# dropped from the in-memory caches (below) is loaded, not compiled, the
# next time a test needs it, and warm runs mostly load. Per-worker
# directories keep workers from ever touching one another's cache files —
# a shared directory measured MORE worker crashes, not fewer, under
# concurrent compile load.
_worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
_cache_dir = os.path.join(
    os.path.dirname(__file__), ".jax_test_cache", _worker
)
jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)

import gc

import numpy as np
import pytest

_MAPS = "/proc/self/maps"
# Half the kernel's default per-process limit (vm.max_map_count = 65,530);
# the heaviest single test maps about 12,000 regions.
_MAX_MAPPED_REGIONS = 32_000


def _mapped_regions() -> int:
    with open(_MAPS) as f:
        return sum(1 for _ in f)


@pytest.fixture(autouse=True)
def _bound_compiled_programs():
    """Every compiled XLA:CPU program keeps memory mappings of its code for
    as long as JAX caches it. A worker that runs the sharded test files one
    after another passes the kernel's per-process mapping limit and dies in
    its next compile (a segfault or abort inside compile or cache I/O).
    Past half that limit, drop the in-memory caches between tests."""
    yield
    if os.path.exists(_MAPS) and _mapped_regions() > _MAX_MAPPED_REGIONS:
        jax.clear_caches()
        gc.collect()


@pytest.fixture
def rng():
    return np.random.default_rng(0xD15CA)
