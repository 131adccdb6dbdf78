"""Persistent compile cache location (vecgo/utils/jaxcache.py)."""

import os

import jax

from vecgo.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_honours_env_and_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert jaxcache.enable_compilation_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_cache_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jaxcache.cache_dir()
    assert path == jaxcache.cache_dir() == os.path.join(REPO, ".jax_cache")
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            assert f.read().strip() not in path
    except OSError:
        pass
    assert str(os.getpid()) not in os.path.relpath(path, REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
