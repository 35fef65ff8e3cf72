"""The one rule for where JAX keeps its persistent compilation cache."""
import jax
import pytest

from dsrc_tpu.utils import jax_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_follows_environment_variable(monkeypatch, tmp_path,
                                            restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jax_cache.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_cache_defaults_to_fixed_path_in_checkout(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = jax_cache.use_compile_cache()
    root = __file__.rsplit("/tests/", 1)[0]
    assert path == root + "/.jax_cache"
    assert jax.config.jax_compilation_cache_dir == path
    assert jax_cache.use_compile_cache() == path      # same every call
