"""Batched SPD solve: every XLA formulation the WALS engine can pick.

Times each solver alone on stacked WALS normal equations at the ml20m
shapes (user side 138,496 systems, item side 26,744; k=64, plus the user
side at k=32 and k=128):

  blocked<nb>      ops/linalg.solve_spd, the unrolled blocked Cholesky,
                   at block size nb (8/16/32 at k=64: the _BLOCK sweep)
  cholesky_xla     jnp.linalg.cholesky + two triangular solves (cuSOLVER)
  lu               jnp.linalg.solve (batched LU)

A is built on the device as YtY + lam*I + sum_d w_d y_d y_d^T from random
factors (precision HIGHEST), so it is conditioned like the engine's own.
Every solver's result on the first systems is compared with float64
numpy; the line reports max |x - x64| / max |x64|.

Also checks that jax.block_until_ready waits for a program whose input
was donated (the sync every timing in this repo relies on).

Usage: python benchmarks/solver_micro.py [--quick]
  --quick: k=64 user side only.
Needs a GPU; prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from qmf_tpu.cli.common import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmf_tpu.ops import als_ops, linalg  # noqa: E402

N_USER = 138_496  # ml20m user side as the packer pads it (multiple of 8)
N_ITEM = 26_744
N_COLS = 26_744
D = 32  # observed entries per system in the synthetic build
ALPHA, LAM = 40.0, 0.05
REPS = 10
CHECK = 2048  # systems compared with float64


def normal_equations(n: int, k: int, seed: int = 0):
    """WALS-like (A, b): YtY + lam I + sum_d alpha r y y^T, on device."""
    key = jax.random.PRNGKey(seed)
    ky, kc, kr = jax.random.split(key, 3)

    @jax.jit
    def build(ky, kc, kr):
        y = 0.1 * jax.random.normal(ky, (N_COLS, k), jnp.float32)
        col = jax.random.randint(kc, (n, D), 0, N_COLS)
        r = jax.random.randint(kr, (n, D), 1, 11).astype(jnp.float32) * 0.5
        w = ALPHA * r
        yg = y[col]
        hp = jax.lax.Precision.HIGHEST
        a = (
            jnp.matmul(y.T, y, precision=hp)[None]
            + jnp.einsum("bdk,bd,bdl->bkl", yg, w, yg, precision=hp)
            + LAM * jnp.eye(k, dtype=jnp.float32)
        )
        b = jnp.einsum("bd,bdk->bk", 1.0 + w, yg, precision=hp)
        return a, b

    return build(ky, kc, kr)


def timed(fn, *args):
    out = jax.block_until_ready(fn(*args))  # compile + first run
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / REPS, out


def rel_err(x, a64, b64):
    x64 = np.linalg.solve(a64, b64[..., None])[..., 0]
    return float(np.abs(np.asarray(x[:CHECK], np.float64) - x64).max()
                 / np.abs(x64).max())


def solvers(k: int):
    out = {}
    blocks = (8, 16, 32) if k == 64 else (16,)
    for nb in blocks:
        out[f"blocked{nb}"] = jax.jit(
            lambda a, b, nb=nb: linalg.solve_spd(a, b, block=nb)
        )
    out["cholesky_xla"] = jax.jit(als_ops._solve_spd_xla)
    out["lu"] = jax.jit(als_ops._solve_lu)
    return out


def check_block_until_ready():
    """Time a donated-input program chain by block_until_ready and by a
    scalar read-back; equal times mean block_until_ready really waits."""
    f = jax.jit(lambda x: jnp.tanh(x @ x) * 0.5, donate_argnums=0)
    x = jnp.ones((8192, 8192), jnp.float32) * 1e-3
    x = jax.block_until_ready(f(x))
    t0 = time.perf_counter()
    for _ in range(20):
        x = f(x)
    t_enqueue = time.perf_counter() - t0
    jax.block_until_ready(x)
    t_bur = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(20):
        x = f(x)
    float(x[0, 0])
    t_read = time.perf_counter() - t0
    print(
        f"# sync check (20 donated 8192^2 matmuls): enqueue {t_enqueue:.4f}s"
        f" block_until_ready {t_bur:.4f}s scalar read-back {t_read:.4f}s",
        flush=True,
    )


def main():
    quick = "--quick" in sys.argv[1:]
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"# device {dev.device_kind}; nvidia-smi: {card}", flush=True)
    check_block_until_ready()
    shapes = [(N_USER, 64), (N_ITEM, 64)] if not quick else [(N_USER, 64)]
    if not quick:
        shapes += [(N_USER, 32), (N_USER, 128)]
    for n, k in shapes:
        a, b = normal_equations(n, k)
        a64 = np.asarray(a[:CHECK], np.float64)
        b64 = np.asarray(b[:CHECK], np.float64)
        gb = n * k * k * 4 / 1e9
        print(f"--- {n} systems, k={k} (A = {gb:.2f} GB f32)", flush=True)
        for name, fn in solvers(k).items():
            try:
                t, x = timed(fn, a, b)
            except Exception as e:  # noqa: BLE001 — report, try the next
                print(f"  {name:14s} FAILED {type(e).__name__}: {e}"[:400],
                      flush=True)
                continue
            print(
                f"  {name:14s} {t * 1e3:9.3f} ms  {gb / t:7.1f} GB/s of A  "
                f"rel err {rel_err(x, a64, b64):.2e}",
                flush=True,
            )
        del a, b


if __name__ == "__main__":
    main()
