"""Where the persistent XLA compilation cache lives.

``JAX_COMPILATION_CACHE_DIR``, when set, is the only cache directory: JAX
reads it itself and nothing here overrides it.  Otherwise the cache is one
fixed directory inside the checkout, ``<repo>/.jax_cache`` (git-ignored),
so every process run from the same checkout finds what an earlier one
compiled.  A process pinned to the CPU backend (``jax_platforms == "cpu"``)
keeps its executables in a subdirectory keyed by the host's CPU features
(utils/hostid.py): XLA:CPU code compiled on another host can crash when
loaded.  Accelerator executables are not host-keyed.

The location is decided without initializing a backend, so importing the
pipeline stays safe before ``jax.distributed.initialize``.
"""

from __future__ import annotations

import os

__all__ = ["DEFAULT_DIR", "cache_dir", "configure"]

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir(platforms: str | None, env=None) -> str:
    """Cache directory for a process whose ``jax_platforms`` setting is
    ``platforms`` (None or "" = JAX picks the backend)."""
    env = os.environ if env is None else env
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return env["JAX_COMPILATION_CACHE_DIR"]
    if platforms == "cpu":
        from platanus3_tpu.utils.hostid import cpu_cache_tag
        return os.path.join(DEFAULT_DIR, f"cpu-{cpu_cache_tag()}")
    return DEFAULT_DIR


def configure(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent cache at :func:`cache_dir` unless a
    directory is configured already; returns the directory in use."""
    import jax
    if not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir",
                          cache_dir(jax.config.jax_platforms))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return jax.config.jax_compilation_cache_dir
