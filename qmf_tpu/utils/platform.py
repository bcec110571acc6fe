"""Which code path each JAX backend gets: the one explicit policy.

The engines' ``"auto"`` knobs (solver, device-side packing, hot/cold split
width) resolve here, keyed on ``jax.default_backend()``. Two backends are
supported: ``"gpu"`` (the NVIDIA card the hot paths are tuned for) and
``"cpu"`` (tests and float64 golden runs). Any other backend raises rather
than inheriting either policy.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

SUPPORTED_BACKENDS = ("gpu", "cpu")


def backend() -> str:
    """The default JAX backend, checked against the supported set."""
    name = jax.default_backend()
    if name not in SUPPORTED_BACKENDS:
        raise RuntimeError(
            f"unsupported JAX backend {name!r}: qmf_tpu runs on "
            f"{' or '.join(SUPPORTED_BACKENDS)}"
        )
    return name


def _accelerated(dtype) -> bool:
    """f32 on the GPU: the configuration the device-side paths serve (f64
    golden runs keep the plain paths, which are the correctness oracle)."""
    return backend() == "gpu" and jnp.dtype(dtype) == jnp.float32


def auto_solver(dtype) -> str:
    """solver="auto": for f32 on the GPU, XLA's own batched Cholesky
    (cuSOLVER factor + two triangular solves), the fastest solve per ml20m
    epoch on the card (PERF.md, "Solve kernel vs XLA"); the unrolled
    blocked Cholesky everywhere else (the CPU tests' and f64 golden path)."""
    return "cholesky_xla" if _accelerated(dtype) else "cholesky"


def auto_device_pack(dtype) -> bool:
    """device_pack="auto": pack on the device for f32 GPU runs, where the
    raw COO transfer plus an on-device sort beats shipping padded arrays;
    on the CPU there is no transfer to save."""
    return _accelerated(dtype)


def auto_hot_split(dtype) -> bool:
    """Whether hot_width="auto" may pick a nonzero hot width (the cost
    model in ops/hot.py is measured on the GPU)."""
    return _accelerated(dtype)
