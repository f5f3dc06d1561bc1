"""The persistent compilation cache's directory rule (utils/cache.py):
``JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's fixed
``.jax_cache/``."""

import os

import pytest

from grayscott_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_cache_config():
    """Restore JAX's cache settings after a test that changes them, so
    later compiles in this worker never write a test's cache."""
    import jax

    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield jax
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.compilation_cache_dir() == os.path.join(REPO, ".jax_cache")
    assert cache.CHECKOUT_CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_cache_dir_env_wins(monkeypatch, tmp_path, jax_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache
    and this module points JAX at no other one."""
    jax = jax_cache_config
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.delenv("GRAYSCOTT_NO_PERSISTENT_CACHE")
    monkeypatch.setattr(cache, "CHECKOUT_CACHE_DIR", str(tmp_path / "co"))
    monkeypatch.setattr(cache, "_compilation_cache_enabled", False)
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before
    assert not os.path.exists(tmp_path / "co")


def test_compilation_cache_enable(monkeypatch, tmp_path, jax_cache_config):
    jax = jax_cache_config
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(cache, "CHECKOUT_CACHE_DIR", str(tmp_path / "co"))
    monkeypatch.setattr(cache, "_compilation_cache_enabled", False)
    # the suite-wide kill switch must win: no jax config change, no dir
    monkeypatch.setenv("GRAYSCOTT_NO_PERSISTENT_CACHE", "1")
    before = jax.config.jax_compilation_cache_dir
    path = cache.enable_compilation_cache()
    assert path == str(tmp_path / "co")
    assert not os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == before
    # without the kill switch the checkout cache is enabled for real,
    # for every executable however fast it compiled
    monkeypatch.delenv("GRAYSCOTT_NO_PERSISTENT_CACHE")
    path = cache.enable_compilation_cache()
    assert os.path.isdir(path)
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


@pytest.mark.parametrize("pattern", [
    ".jax_cache/", "chiprun_out/", "grayscott_tpu/native/*.so",
])
def test_gitignore_lists_build_outputs(pattern):
    """Caches and build products are made at run time, never tracked."""
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert pattern in f.read().splitlines()
