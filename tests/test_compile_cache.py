"""Compile-cache placement for the entry points (utils/compile_cache)."""

import jax
import pytest

from duckdb_lm_diskann_tpu.utils import compile_cache

_KEYS = (
    "jax_compilation_cache_dir",
    "jax_persistent_cache_min_entry_size_bytes",
    "jax_persistent_cache_min_compile_time_secs",
)


@pytest.fixture
def jax_cache_config():
    """Restore this worker's cache settings after the test."""
    saved = {k: getattr(jax.config, k) for k in _KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_var_wins_and_nothing_else_is_set(
    monkeypatch, tmp_path, jax_cache_config
):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_repo_cache_dir(monkeypatch, jax_cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    path = compile_cache.enable_compile_cache()
    repo_root = compile_cache.REPO_CACHE_DIR.parent
    assert path == str(repo_root / ".jax_cache")
    assert (repo_root / "duckdb_lm_diskann_tpu").is_dir()
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.5
