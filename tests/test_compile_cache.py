"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins and nothing else is
set; without it the cache is the fixed .jax_cache/ at the checkout root."""

import os

import jax
import pytest

from stellar_rw_tpu.utils import compile_cache


@pytest.mark.parametrize("env_dir", ["/some/where/jax-cache", None])
def test_configure_compile_cache(monkeypatch, env_dir):
    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_dir)
    try:
        got = compile_cache.configure_compile_cache()
        if env_dir is None:
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(root, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            assert got == env_dir
            # JAX reads the variable itself; the helper sets no other path
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
