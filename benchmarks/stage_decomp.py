"""Honest WALS stage decomposition at ml20m k=64 (no DCE traps).

Usage: python -u benchmarks/stage_decomp.py [solver ...]

Stage 1 (build): jit program that returns the SIDE-stacked (A, b) normal
equations for the user side — A is a real output, so nothing is dead-code
eliminated (the `identity`-solver sweep underestimated build cost because
XLA narrowed the A einsum to the single column the fake solve consumed).
Stage 2 (solve): jit program x = solve(A, b) per requested solver, timed
on the materialized stage-1 outputs.

Prints per-stage times; build + both sides' solve + scatter approximates
the fused epoch (cross-checked against solver_sweep.py numbers).
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

import datagen  # noqa: E402
from qmf_tpu.config import WALSConfig  # noqa: E402
from qmf_tpu.data.dataset import Dataset  # noqa: E402
from qmf_tpu.models.wals import WALSEngine  # noqa: E402
from qmf_tpu.ops import als_ops  # noqa: E402

REPS = 5


def timed(fn, *args):
    out = fn(*args)
    jax.tree_util.tree_map(
        lambda x: float(jnp.asarray(x).ravel()[0]), out
    )
    t0 = time.time()
    for _ in range(REPS):
        out = fn(*args)
    jax.tree_util.tree_map(lambda x: float(jnp.asarray(x).ravel()[0]), out)
    return (time.time() - t0) / REPS, out


def main():
    solvers = sys.argv[1:] or ["cholesky", "schur"]
    users, items, values = datagen.load_npz("ml20m")
    ds = Dataset(users, items, values)
    cfg = WALSConfig(
        nepochs=1, nfactors=64, init_seed=0, matmul_precision="default"
    )
    eng = WALSEngine(cfg)
    t0 = time.time()
    eng.init(ds)
    print(f"init {time.time()-t0:.1f}s", flush=True)

    ub = eng._user_buckets
    u_arrays = [
        (ub.row_ids[i], ub.col_idx[i], ub.values[i], ub.mask[i])
        for i in range(len(ub))
    ]
    alpha = jnp.asarray(cfg.confidence_weight, dtype=eng.dtype)
    lam = jnp.asarray(cfg.regularization_lambda, dtype=eng.dtype)
    chunks = tuple(eng._user_chunks)

    def build_side(y):
        yty = als_ops.gramian(y)
        parts = [
            als_ops._scan_class_build(
                y, yty, col_idx, vals, mask, alpha, lam, cb,
                cfg.matmul_precision,
            )
            for (_, col_idx, vals, mask), cb in zip(u_arrays, chunks)
        ]
        a = jnp.concatenate([p[0] for p in parts], axis=0)
        b = jnp.concatenate([p[1] for p in parts], axis=0)
        return a, b

    t0 = time.time()
    build_j = jax.jit(build_side)
    dt, (a, b) = timed(build_j, eng.item_factors)
    print(
        f"user-side BUILD (A {a.shape}, b {b.shape}): {dt*1e3:.1f} ms "
        f"(first call {time.time()-t0:.1f}s)",
        flush=True,
    )

    if "build2" in sys.argv:
        # variant: pre-scale yg by w so the A einsum is a clean two-operand
        # batched GEMM (bdk,bdl->bkl) that must hit the tensor cores
        prec = als_ops._PRECISION_BY_NAME["default"]

        def build2_class(y, yty, col_idx, vals, mask, chunk_b):
            n_chunks = col_idx.shape[0] // chunk_b
            d = col_idx.shape[1]
            col_c = col_idx.reshape(n_chunks, chunk_b, d)
            val_c = vals.reshape(n_chunks, chunk_b, d)
            mask_c = mask.reshape(n_chunks, chunk_b, d)

            def body(_, inp):
                col, val, m = inp
                yg = y[col]
                maskf = m.astype(y.dtype)
                w = alpha * val * maskf
                conf = maskf + w
                bb = jnp.einsum("bd,bdk->bk", conf, yg, precision=prec)
                ygw = yg * w[..., None]
                aa = yty[None] + jnp.einsum(
                    "bdk,bdl->bkl", ygw, yg, precision=prec
                ) + lam * jnp.eye(y.shape[1], dtype=y.dtype)
                return None, (aa, bb)

            _, (a_s, b_s) = jax.lax.scan(body, None, (col_c, val_c, mask_c))
            kk = y.shape[1]
            return a_s.reshape(-1, kk, kk), b_s.reshape(-1, kk)

        def build_side2(y):
            yty = als_ops.gramian(y)
            parts = [
                build2_class(y, yty, col_idx, vals, mask, cb)
                for (_, col_idx, vals, mask), cb in zip(u_arrays, chunks)
            ]
            return (
                jnp.concatenate([p[0] for p in parts], axis=0),
                jnp.concatenate([p[1] for p in parts], axis=0),
            )

        t0 = time.time()
        dt, _ = timed(jax.jit(build_side2), eng.item_factors)
        print(
            f"user-side BUILD2 (pre-scaled GEMM): {dt*1e3:.1f} ms "
            f"(first call {time.time()-t0:.1f}s)",
            flush=True,
        )

    from qmf_tpu.ops import linalg

    custom = {
        "cholesky16": lambda aa, bb: linalg.solve_spd(aa, bb, block=16),
        "cholesky4": lambda aa, bb: linalg.solve_spd(aa, bb, block=4),
        "cholesky32": lambda aa, bb: linalg.solve_spd(aa, bb, block=32),
    }
    for solver in solvers:
        if solver in custom:
            solve_j = jax.jit(custom[solver])
        else:
            solve_j = jax.jit(
                lambda aa, bb, s=solver: als_ops._solve_dispatch(aa, bb, s)
            )
        t0 = time.time()
        dt, _ = timed(solve_j, a, b)
        print(
            f"user-side SOLVE [{solver}] @ {a.shape[0]} rows: {dt*1e3:.1f} ms"
            f" (first call {time.time()-t0:.1f}s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
