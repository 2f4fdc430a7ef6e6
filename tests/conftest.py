"""Test harness: force a virtual 8-device CPU platform.

The suite runs on the CPU backend (``JAX_PLATFORMS=cpu``); the platform
is also pinned through ``jax.config`` before any backend is initialized,
so a machine with an accelerator still runs the tests on the CPU.  Unit +
sharding tests run on 8 virtual CPU devices (SURVEY.md §4 test plan, item
3).  Tests that need a GPU carry the ``gpu`` marker and skip without one;
``python chip_smoke.py`` drives the main path on the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache for the test suite: the shard_map pipeline
# programs dominate suite wall-clock (~60 s/compile set); with the cache
# warm a full run is minutes faster.  Threshold is aggressive (0.5 s)
# because these are many medium-sized compiles, not a few huge ones.
# JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed in-checkout
# directory, host-keyed for CPU executables (utils/compile_cache.py).
from platanus3_tpu.utils import compile_cache  # noqa: E402

compile_cache.configure(min_compile_secs=0.5)

import pytest  # noqa: E402

_TEST_COUNT = {"n": 0}


@pytest.fixture(autouse=True)
def _periodic_jax_cache_clear():
    """Clear jax's in-process executable caches every ~30 tests.

    A single pytest process accumulates hundreds of compiled XLA:CPU
    executables over the full suite; past ~150 tests XLA:CPU segfaults
    inside compile (observed twice, different tests, always late in the
    run; every file passes in isolation).  Dropping live executables
    periodically keeps the process well under the crash region; the
    persistent on-disk cache (host-keyed, above) makes the recompiles
    cheap loads.
    """
    yield
    _TEST_COUNT["n"] += 1
    if _TEST_COUNT["n"] % 30 == 0:
        jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA GPU is present (decided here, at test time,
    never while test modules are imported)."""
    import shutil
    import subprocess
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU: nvidia-smi not found")
    r = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True)
    if r.returncode != 0 or "GPU" not in r.stdout:
        pytest.skip("needs an NVIDIA GPU: nvidia-smi lists none")
