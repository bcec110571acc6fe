"""Hot/cold split feasibility micro: is head-dense + tail-gather faster?

The WALS build pays per gathered factor row (benchmarks/gather_micro.py).
Item popularity is Zipf: the top-H hottest
columns of a side cover a large share of nnz (ml20m synthetic: top-1024
items = 59%, top-4096 = 78%). This micro times the two halves of the
proposed split build for one side:

  cold  — the existing class-scan gather+einsum build, on the dataset with
          hot columns REMOVED (fewer gathered rows AND less padding);
  hot   — per scan chunk, A += W_a (B,H) @ Z (H,k^2) and b += W_b @ Y_hot
          (dense GEMMs over a static weight matrix; the alpha*r weights
          never change across epochs so W is built once at init).

Usage: python -u benchmarks/hot_micro.py [user|item] [H ...]
       python -u benchmarks/hot_micro.py gemm [H ...]
The "gemm" form times only the hot GEMM at the ml20m user side's padded
row count and prints its rate: ops/hot.py's _GEMM_FLOPS.
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

K = 64
REPS = 5
BATCH_ROWS = 8192


def timed(fn, *args):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / REPS


def hot_gemm_fn(h):
    def hot_gemm(w_a, w_b, y_hot):
        yh = y_hot.astype(jnp.bfloat16)
        z = (yh[:, :, None] * yh[:, None, :]).reshape(h, K * K)

        def body(_, inp):
            wa, wb = inp
            a = jnp.matmul(wa, z, preferred_element_type=jnp.float32)
            b = jnp.matmul(wb, yh, preferred_element_type=jnp.float32)
            # row-sum keeps every GEMM output live without writing the
            # (B, k^2) block to device memory — in production A_hot is added
            # into the cold A accumulation in-fusion, so no extra A write
            return None, (a.sum(axis=-1), b)

        _, (a0, b) = jax.lax.scan(body, None, (w_a, w_b))
        return a0, b

    return jax.jit(hot_gemm)


def gemm_only(hs):
    """Rate of the hot GEMM alone at the ml20m user side's row count."""
    n_rows = 138_496
    steps = -(-n_rows // BATCH_ROWS)
    key = jax.random.PRNGKey(0)
    for h in hs:
        w_a = jax.random.uniform(key, (steps, BATCH_ROWS, h), jnp.bfloat16)
        w_b = w_a + 1
        y_hot = 0.1 * jax.random.normal(key, (h, K), jnp.float32)
        t = timed(hot_gemm_fn(h), w_a, w_b, y_hot)
        flops = steps * BATCH_ROWS * h * (K * K + K) * 2
        print(f"H={h:6d} hot gemm {t * 1e3:8.3f} ms  "
              f"{flops / t / 1e12:7.2f} TFLOP/s", flush=True)


def build_side_fn(eng, side="user"):
    bk = eng._user_buckets if side == "user" else eng._item_buckets
    chunks = tuple(
        eng._user_chunks if side == "user" else eng._item_chunks
    )
    arrays = [
        (bk.row_ids[i], bk.col_idx[i], bk.values[i], bk.mask[i])
        for i in range(len(bk))
    ]
    alpha = jnp.asarray(eng.config.confidence_weight, dtype=eng.dtype)
    lam = jnp.asarray(eng.config.regularization_lambda, dtype=eng.dtype)

    def build(y):
        yty = als_ops.gramian(y)
        parts = [
            als_ops._scan_class_build(
                y, yty, col_idx, vals, mask, alpha, lam, cb, "default"
            )
            for (_, col_idx, vals, mask), cb in zip(arrays, chunks)
        ]
        # full A is a real output (as in production's side solve) so the
        # einsum cannot be DCE-narrowed (see stage_decomp.py)
        a = jnp.concatenate([p[0] for p in parts], axis=0)
        b = jnp.concatenate([p[1] for p in parts], axis=0)
        return a, b

    return build


def main():
    side = sys.argv[1] if len(sys.argv) > 1 else "user"
    if side == "gemm":
        gemm_only([int(h) for h in sys.argv[2:]] or [1024, 2048, 4096])
        return
    hs = [int(h) for h in sys.argv[2:]] or (
        [1024, 2048, 4096] if side == "user" else [4096, 8192, 16384]
    )
    users, items, values = datagen.load_npz("ml20m")
    if side == "item":
        users, items = items, users  # solve items: gather user rows
    nnz = len(users)
    n_rows = int(users.max()) + 1
    n_cols = int(items.max()) + 1
    print(f"side={side}: {n_rows} rows x {n_cols} cols, {nnz} nnz")

    cfg = WALSConfig(
        nepochs=1, nfactors=K, init_seed=0, matmul_precision="default",
        batch_rows=BATCH_ROWS,
    )

    # --- baseline: full build (no split) ---
    eng = WALSEngine(cfg)
    eng.init(Dataset(users, items, values))
    y = (
        eng.item_factors
        if side == "user"
        else jnp.asarray(
            np.random.default_rng(0).normal(0, 0.1, (n_cols, K)), jnp.float32
        )
    )
    dt = timed(jax.jit(build_side_fn(eng, "user")), y)
    print(f"FULL build: {dt*1e3:.1f} ms", flush=True)
    del eng

    cnt = np.bincount(items, minlength=n_cols)
    order = np.argsort(cnt)[::-1]

    rng = np.random.default_rng(0)
    for h in hs:
        hot = order[:h]
        is_hot = np.zeros(n_cols, bool)
        is_hot[hot] = True
        cold_mask = ~is_hot[items]
        cov = 1 - cold_mask.mean()
        # --- cold build on the filtered stream ---
        eng = WALSEngine(cfg)
        eng.init(Dataset(users[cold_mask], items[cold_mask],
                         values[cold_mask]))
        yc = jnp.asarray(rng.normal(0, 0.1, (n_cols, K)), jnp.float32)
        t_cold = timed(jax.jit(build_side_fn(eng, "user")), yc)

        # --- hot GEMM: scan over row chunks, z invariant ---
        n_pad = ((n_rows + BATCH_ROWS - 1) // BATCH_ROWS) * BATCH_ROWS
        steps = n_pad // BATCH_ROWS
        w_a = jnp.asarray(
            rng.random((steps, BATCH_ROWS, h)), jnp.bfloat16
        )
        w_b = jnp.asarray(
            rng.random((steps, BATCH_ROWS, h)), jnp.bfloat16
        )
        y_hot = yc[jnp.asarray(hot)]

        t_hot = timed(hot_gemm_fn(h), w_a, w_b, y_hot)
        print(
            f"H={h:6d} cov={cov*100:5.1f}%  cold build {t_cold*1e3:7.1f} ms"
            f"  hot gemm {t_hot*1e3:6.1f} ms  total {(t_cold+t_hot)*1e3:7.1f}"
            f" ms",
            flush=True,
        )
        del eng


if __name__ == "__main__":
    main()
