"""Persistent compilation cache location (utils/compile_cache.py)."""

import os

import jax
import pytest

from platanus3_tpu.utils import compile_cache
from platanus3_tpu.utils.hostid import cpu_cache_tag

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_dir_is_fixed_inside_checkout():
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")


@pytest.mark.parametrize("env,platforms,want", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, None,
     "/elsewhere/cache"),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "cpu",
     "/elsewhere/cache"),
    ({}, None, "DEFAULT"),
    ({}, "", "DEFAULT"),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, "cuda", "DEFAULT"),
    ({}, "cpu", "CPU"),
])
def test_cache_dir(env, platforms, want):
    want = {"DEFAULT": compile_cache.DEFAULT_DIR,
            "CPU": os.path.join(compile_cache.DEFAULT_DIR,
                                f"cpu-{cpu_cache_tag()}")}.get(want, want)
    assert compile_cache.cache_dir(platforms, env) == want


def test_process_uses_env_or_checkout_cache():
    got = jax.config.jax_compilation_cache_dir
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        assert got == env
    else:
        assert got == os.path.join(compile_cache.DEFAULT_DIR,
                                   f"cpu-{cpu_cache_tag()}")
