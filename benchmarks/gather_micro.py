"""Row-gather idiom sweep: find the per-row cost floor on the card.

An ml20m WALS epoch gathers ~2*nnz (40M) factor rows of 128-512 B. The
"base" line's ns/row is ops/hot.py's _GATHER_NS_PER_ROW, the per-row cost
the hot/cold split's cost model charges the cold stream. This sweep times
the production idiom ``y.astype(bf16)[col]`` and alternatives on
representative class shapes:

  base      y_bf16[col]                     (production build idiom)
  f32       y[col] then cast                (gather wider rows)
  flat      y_bf16[col.ravel()].reshape     (collapse batch dims)
  take      jnp.take(y_bf16, col, axis=0)
  split4    four independent gathers of n/4 rows each, concatenated
            (tests whether XLA issues concurrent DMA queues)
  sorted    gather with per-row sorted indices (pure locality probe —
            result is permuted, NOT equivalent; timing only)

Usage: python -u benchmarks/gather_micro.py [N D ...]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "benchmarks")
from qmf_tpu.cli.common import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

K = 64
N_ITEMS = 26744
REPS = 10


def timed(fn, *args):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / REPS


def main():
    rest = sys.argv[1:]
    specs = [(int(rest[i]), int(rest[i + 1])) for i in range(0, len(rest), 2)]
    specs = specs or [(14336, 64), (11520, 256)]

    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.normal(0, 0.1, (N_ITEMS, K)), jnp.float32)
    yb = y.astype(jnp.bfloat16)

    for n, d in specs:
        col = jnp.asarray(rng.integers(0, N_ITEMS, (n, d)), jnp.int32)
        rows = n * d
        print(f"--- ({n}, {d}): {rows/1e6:.2f}M rows", flush=True)

        def report(name, fn, *args):
            try:
                t = timed(jax.jit(fn), *args)
            except Exception as e:  # noqa: BLE001
                print(f"  {name:10s} FAILED: {type(e).__name__}: {e}"[:200],
                      flush=True)
                return
            print(
                f"  {name:10s} {t*1e3:8.2f} ms  {t/rows*1e9:6.2f} ns/row  "
                f"{rows*K*2/t/1e9:7.1f} GB/s(bf16)",
                flush=True,
            )

        report("base", lambda y, c: y.astype(jnp.bfloat16)[c], y, col)
        report("f32", lambda y, c: y[c], y, col)
        report(
            "flat",
            lambda y, c: y.astype(jnp.bfloat16)[c.ravel()].reshape(
                c.shape + (K,)
            ),
            y,
            col,
        )
        report("take", lambda y, c: jnp.take(y, c, axis=0), yb, col)

        def split4(y, c):
            q = c.shape[0] // 4
            parts = [y.astype(jnp.bfloat16)[c[i * q:(i + 1) * q]]
                     for i in range(4)]
            return jnp.concatenate(parts, axis=0)

        report("split4", split4, y, col)

        col_sorted = jnp.sort(col.ravel()).reshape(col.shape)
        report("sorted", lambda y, c: y.astype(jnp.bfloat16)[c], y,
               col_sorted)


if __name__ == "__main__":
    main()
