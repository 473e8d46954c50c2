"""Where the persistent compile cache lives."""

import os

from coulomb_oscillators.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.cache_dir()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_sets_jax_config(monkeypatch, tmp_path):
    import re
    import jax
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_hlo_source_file_canonicalization_regex)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert cache.enable_compile_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert os.path.isdir(tmp_path / "c")
        # source paths in compiled code are made relative to the checkout
        pat = jax.config.jax_hlo_source_file_canonicalization_regex
        src = os.path.join(REPO, "coulomb_oscillators", "ops", "fmm",
                           "p2p_triton.py")
        assert re.sub(pat, "", src) == os.path.join(
            "coulomb_oscillators", "ops", "fmm", "p2p_triton.py")
    finally:
        jax.config.update("jax_compilation_cache_dir", old[0])
        jax.config.update("jax_hlo_source_file_canonicalization_regex",
                          old[1])
