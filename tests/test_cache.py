"""Compile-cache directory choice (raytpu.utils.cache)."""

import os

import jax

from raytpu.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_dir_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cache.cache_dir() == str(tmp_path / "c")


def test_default_is_fixed_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.cache_dir()
    assert path == os.path.join(ROOT, ".jax_cache") == cache.CHECKOUT_DIR
    assert cache.cache_dir() == path  # same path on every call
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_points_jax_at_the_env_dir(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert cache.enable() == str(tmp_path / "c")
        assert os.path.isdir(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
