"""Compile-cache placement: JAX_COMPILATION_CACHE_DIR when set, else the
checkout's fixed `.jax_cache`."""

import os

import jax
import pytest

from srsran_projectvtlmo_tpu.utils import cache


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_environment_variable_wins(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_checkout_directory_without_the_variable(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = cache.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache") == jax.config.jax_compilation_cache_dir
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0
