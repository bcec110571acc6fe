"""Test harness configuration.

Tests run on the CPU with 8 virtual devices so sharded/multi-device code
paths are exercised without accelerator hardware (mirrors the reference's
thread-count sweep testing technique, reference
qmf/test/WALSEngineTest.cpp:113, extended to device counts). Must run
before the first jax import.

Card-only tests carry the ``gpu`` marker and take the ``gpu`` fixture,
which skips them when the backend is not a GPU; chip_smoke.py runs them on
the card with JAX_PLATFORMS=cuda.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Keep tests hermetic: CLI tests invoke main() in-process, which would
# otherwise enable the persistent XLA compilation cache for the whole
# pytest session — shared, non-atomic cache state across concurrent
# processes has produced segfaults in jax's cache deserialization.
os.environ["QMF_TPU_NO_COMPILE_CACHE"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Enable x64 so float64 oracle paths can run on the CPU test backend
# (library code pins dtypes explicitly, so float32 paths are unaffected).
jax.config.update("jax_enable_x64", True)

import pytest


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run by chip_smoke.py)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables + tracing caches at module boundaries.

    The full suite compiles hundreds of XLA:CPU programs in one process;
    with all of them held live, late large compiles (the fused WALS
    programs in test_wals.py) have segfaulted inside LLVM. Releasing the
    executables between modules keeps process state close to what each
    module sees when run alone.
    """
    yield
    jax.clear_caches()
