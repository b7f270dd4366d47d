"""The environment every port test module runs in: one module fixture,
``_torch_test_env``, that each ``tests/test_torch_*.py`` imports (importing
an autouse fixture applies it to the importing module).

- One intra-op thread: the port's tests hold small tensors, and a thread
  pool's spin waits slow them, and the other test workers, many times over
  when workers share the cores.
- JAX's persistent compilation cache, in one folder shared by the
  session's test workers: the JAX package's programs that several port
  modules compile for the same shapes (the ``conftest`` world's engine,
  populator and commit steps) are compiled once a session and loaded from
  the folder after. A loaded executable is the compiled program itself,
  so every result is the same. The cache is switched off again when the
  module ends, so the JAX package's own test modules run as they would
  without it.
"""

import contextlib
import os

import jax
import pytest
import torch

_CACHE_CONFIG = {"jax_compilation_cache_dir": None,
                 "jax_persistent_cache_min_compile_time_secs": 0,
                 "jax_persistent_cache_min_entry_size_bytes": -1}


def _cache_dir(tmp_path_factory):
    """A folder all workers of this session share (xdist gives each worker
    a base folder of its own under one session folder)."""
    base = tmp_path_factory.getbasetemp()
    return (base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base) / "jax_cache"


def _set_cache(values):
    from jax._src import compilation_cache

    for name, value in values.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()  # the cache is set up at the next compile


@contextlib.contextmanager
def torch_test_env(tmp_path_factory):
    """One intra-op thread and the shared cache while open; both as they
    were after."""
    prev = {name: getattr(jax.config, name) for name in _CACHE_CONFIG}
    _set_cache(dict(_CACHE_CONFIG, jax_compilation_cache_dir=str(_cache_dir(tmp_path_factory))))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        _set_cache(prev)


@pytest.fixture(autouse=True, scope="module")
def _torch_test_env(tmp_path_factory):
    with torch_test_env(tmp_path_factory):
        yield


def test_the_environment_holds_inside_the_module(tmp_path_factory):
    assert torch.get_num_threads() == 1
    assert jax.config.jax_compilation_cache_dir == str(_cache_dir(tmp_path_factory))
    f = jax.jit(lambda x: x * 3 + 1)
    assert int(f(jax.numpy.int32(4))) == 13
    assert any(_cache_dir(tmp_path_factory).iterdir())


def test_the_environment_is_restored_after_a_module(tmp_path_factory):
    with torch_test_env(tmp_path_factory):  # a nested module's
        torch.set_num_threads(3)
        jax.config.update("jax_compilation_cache_dir", None)
    assert jax.config.jax_compilation_cache_dir == str(_cache_dir(tmp_path_factory))
    assert torch.get_num_threads() == 1
