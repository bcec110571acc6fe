"""Shared CLI helpers."""

from __future__ import annotations

import os

# Fixed, checkout-relative default for the persistent compilation cache
# (listed in .gitignore): a fixed path keeps cache keys stable across runs.
_REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_COMPILE_CACHE_DIR = os.path.join(_REPO, ".jax_cache")


def configure_platform() -> None:
    """Apply QMF_TPU_X64: full float64 mode, used for golden cross-checks
    against the reference's f64 math (the fast device paths are f32). The
    backend itself is chosen by JAX_PLATFORMS."""
    if os.environ.get("QMF_TPU_X64"):
        import jax

        jax.config.update("jax_enable_x64", True)


def compilation_cache_dir() -> str | None:
    """Where the persistent compilation cache lives, or None for none.

    JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and wins: no
    other directory is set in code. Otherwise the cache sits at a fixed
    directory inside the checkout. QMF_TPU_NO_COMPILE_CACHE=1 opts out.
    """
    if os.environ.get("QMF_TPU_NO_COMPILE_CACHE"):
        return None
    return (
        os.environ.get("JAX_COMPILATION_CACHE_DIR")
        or DEFAULT_COMPILE_CACHE_DIR
    )


def enable_compilation_cache() -> None:
    """Enable jax's persistent compilation cache for fast repeat runs (the
    first compile of each program shape can take tens of seconds)."""
    cache_dir = compilation_cache_dir()
    if cache_dir is None:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
