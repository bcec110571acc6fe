"""Device-side batched weighted-ALS math.

This is the batched device replacement for the reference's hot loop
(qmf/wals/WALSEngine.cpp:266-310): for each row u with observed signals
(j, r_uj), solve the Hu-Koren normal equations

    A_u x = b_u,   A_u = YtY + sum_j alpha r_uj y_j y_j^T + lambda I
                   b_u = sum_j (1 + alpha r_uj) y_j

The reference builds A_u with scalar loops and calls LAPACK ``dsysv_`` per
row; here a whole degree-bucket of rows is processed at once:

- the Gramian ``YtY`` is one k x k matmul (replacing the
  deliberately racy OpenMP accumulation, reference WALSEngine.cpp:246-264,
  with an exact reduction);
- per-row A build is a batched einsum (batched matmul);
- all solves in a bucket run as one batched Cholesky (or LU) factorization.

The per-row loss matches the reference exactly (WALSEngine.cpp:289-304):
    loss_u = sum_j (1 + alpha r_uj) - 2 x^T b + x^T B x,   B = A_u - lambda I
evaluated here through the algebraic identity x^T B x = x.b - lambda |x|^2
(valid because A x = b at the solution), which removes the O(B k^2)
quadratic form. The epoch loss is sum over rows / (nusers * nitems)
(WALSEngine.cpp:214-215).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qmf_tpu.ops.packing import Bucket

# Matmul precision for f32 inputs. HIGHEST = full f32 (no TF32 rounding on
# the GPU); needed for loss/AUC parity with the reference's f64 CPU math.
_PRECISION = jax.lax.Precision.HIGHEST


def gramian(y: jax.Array) -> jax.Array:
    """YtY as one matmul (exact; replaces reference computeXtX)."""
    return jnp.matmul(y.T, y, precision=_PRECISION)


def _solve_spd(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched SPD solve via the unrolled blocked Cholesky (ops/linalg.py):
    solver="cholesky", the CPU and float64 path."""
    from qmf_tpu.ops import linalg

    return linalg.solve_spd(a, b)


def _solve_spd_xla(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched SPD solve via XLA's own Cholesky + triangular solves
    (cuSOLVER on the GPU): solver="cholesky_xla", the GPU default."""
    chol = jnp.linalg.cholesky(a)
    z = jax.lax.linalg.triangular_solve(
        chol, b[..., None], left_side=True, lower=True
    )
    x = jax.lax.linalg.triangular_solve(
        chol, z, left_side=True, lower=True, transpose_a=True
    )
    return x[..., 0]


def _solve_lu(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched general solve (tolerates indefinite A like dsysv_)."""
    return jnp.linalg.solve(a, b[..., None])[..., 0]


@functools.partial(jax.jit, static_argnames=("solver",))
def solve_bucket(
    y: jax.Array,  # (n_cols, k) fixed-side factors
    yty: jax.Array,  # (k, k) Gramian of y
    col_idx: jax.Array,  # (B, D) int32
    values: jax.Array,  # (B, D)
    mask: jax.Array,  # (B, D) bool
    alpha: jax.Array,  # scalar confidence weight
    lam: jax.Array,  # scalar regularization
    solver: str = "cholesky",
) -> Tuple[jax.Array, jax.Array]:
    """Solve one padded bucket of rows. Returns (x (B,k), loss (B,))."""
    if solver not in (
        "cholesky", "cholesky_matmul", "schur", "cholesky_xla", "lu",
    ):
        raise ValueError(f"unknown solver: {solver}")
    return _solve_bucket_body(y, yty, col_idx, values, mask, alpha, lam, solver)


_PRECISION_BY_NAME = {
    # full f32 products and sums (no TF32)
    "highest": jax.lax.Precision.HIGHEST,
    # the builds cast their operands to bf16 explicitly (see
    # _build_bucket): bf16 products, f32 accumulation, ~1e-3 relative
    # error on A/b — ALS is robust to it
    "default": jax.lax.Precision.DEFAULT,
}


def hot_tables(y_hot: jax.Array, precision: str):
    """Per-side precompute for the hot-column dense build: the rank-1
    "outer-product table" Z (H, k*k) with Z[h] = vec(y_h y_h^T), plus the
    cast fixed-side hot rows. One tiny elementwise pass per half-epoch; the
    GEMM ``W_a @ Z`` then reconstructs every row's hot normal-equation term
    entirely on the tensor cores (see _build_bucket)."""
    if precision == "default" and y_hot.dtype == jnp.float32:
        yh = y_hot.astype(jnp.bfloat16)
    else:
        yh = y_hot
    h, k = yh.shape
    z = (yh[:, :, None] * yh[:, None, :]).reshape(h, k * k)
    return yh, z


def _flat_gather(y: jax.Array, col_idx: jax.Array) -> jax.Array:
    """Row-gather ``y[col_idx]`` through raveled indices: one flat (B*D,)
    gather + reshape instead of a batched (B, D) gather (measurably faster
    per row at wide D; benchmarks/gather_micro.py)."""
    return y[col_idx.ravel()].reshape(col_idx.shape + y.shape[1:])


def _build_bucket(y, yty, col_idx, values, mask, alpha, lam, precision,
                  hot=None, y_hot=None, z=None):
    """Normal-equation build for one padded bucket: (A (B,k,k), b (B,k),
    conf_sum (B,)) — the gather + einsum stage, no solve.

    When ``hot`` is given, the bucket's rows additionally carry dense
    weights over the side's H hottest fixed columns (the power-law head):
    ``hot = (w_a (B,H), w_b (B,H), conf_hot (B,))`` with w_a = alpha*r,
    w_b = 1 + alpha*r (0 where unobserved; both static across epochs), and
    the hot contribution is two GEMMs — A += (w_a @ Z).reshape(B,k,k) and
    b += w_b @ y_hot — instead of per-entry factor-row gathers. Random row
    gathers cost per gathered row (benchmarks/gather_micro.py), so moving
    the nnz-heavy head onto the tensor cores trades the head's gathers for
    dense GEMM work (ops/hot.py's cost model decides how much).
    """
    prec = _PRECISION_BY_NAME.get(precision, jax.lax.Precision.HIGHEST)
    dtype = y.dtype
    maskf = mask.astype(dtype)
    w = alpha * values * maskf
    conf = maskf + w
    if precision == "default" and dtype == jnp.float32:
        # "default" builds take bf16 operands; casting BEFORE the gather
        # halves the build's largest device-memory stream — the (B, D, k)
        # gathered-factor rows. Accumulation stays f32. Indices are raveled
        # before the gather: one flat 1-D row gather instead of a batched
        # (B, D) one (benchmarks/gather_micro.py "flat" idiom).
        yg = _flat_gather(y.astype(jnp.bfloat16), col_idx)
        b = jnp.einsum(
            "bd,bdk->bk",
            conf.astype(jnp.bfloat16),
            yg,
            precision=prec,
            preferred_element_type=dtype,
        )
        ygw = yg * w.astype(jnp.bfloat16)[..., None]
        a = (
            yty[None]
            + jnp.einsum(
                "bdk,bdl->bkl",
                ygw,
                yg,
                precision=prec,
                preferred_element_type=dtype,
            )
            + lam * jnp.eye(yty.shape[0], dtype=dtype)
        )
    else:
        yg = _flat_gather(y, col_idx)
        b = jnp.einsum("bd,bdk->bk", conf, yg, precision=prec)
        a = (
            yty[None]
            + jnp.einsum("bdk,bd,bdl->bkl", yg, w, yg, precision=prec)
            + lam * jnp.eye(yty.shape[0], dtype=dtype)
        )
    conf_sum = jnp.sum(conf, axis=1)
    if hot is not None:
        w_a, w_b, conf_hot = hot
        k = yty.shape[0]
        a = a + jnp.matmul(
            w_a, z, precision=prec, preferred_element_type=dtype
        ).reshape(-1, k, k)
        b = b + jnp.matmul(
            w_b, y_hot, precision=prec, preferred_element_type=dtype
        )
        conf_sum = conf_sum + conf_hot
    return a, b, conf_sum


def _solve_dispatch(a, b, solver):
    if solver == "cholesky":
        return _solve_spd(a, b)
    if solver == "cholesky_matmul":
        from qmf_tpu.ops import linalg

        return linalg.solve_spd_matmul(a, b)
    if solver == "schur":
        from qmf_tpu.ops import linalg

        return linalg.solve_spd_schur(a, b)
    if solver == "cholesky_xla":
        return _solve_spd_xla(a, b)
    if solver == "identity":
        # DEBUG-ONLY: x = b + A[:,0] (keeps A alive, skips the solve).
        # Exists so stage-decomposition benchmarks can isolate solve cost
        # (benchmarks/wals_micro.py); never a correct training config.
        return b + a[:, 0, :]
    if solver == "lu":
        return _solve_lu(a, b)
    raise ValueError(f"unknown WALS solver {solver!r}")


def _loss_from_solution(x, b, conf_sum, lam):
    # Reference loss (WALSEngine.cpp:289-304):
    #   loss = sum(conf) - 2 x.b + x^T A0 x
    # Since A x = b exactly at the solution, x^T A0 x = x.b - lam |x|^2, so
    #   loss = sum(conf) - x.b - lam |x|^2
    # — same value, without the O(B k^2) quadratic-form einsum.
    return (
        conf_sum
        - jnp.einsum("bk,bk->b", x, b, precision=_PRECISION)
        - lam * jnp.sum(x * x, axis=1)
    )


def _solve_bucket_body(
    y, yty, col_idx, values, mask, alpha, lam, solver, precision="highest",
    hot=None, y_hot=None, z=None,
):
    """Untraced body of solve_bucket (shared by the fused half-epoch)."""
    a, b, conf_sum = _build_bucket(
        y, yty, col_idx, values, mask, alpha, lam, precision, hot, y_hot, z
    )
    x = _solve_dispatch(a, b, solver)
    return x, _loss_from_solution(x, b, conf_sum, lam)


def half_epoch_impl(
    y: jax.Array,
    bucket_arrays,  # list of (row_ids, col_idx, values, mask) tuples
    alpha: jax.Array,
    lam: jax.Array,
    solver: str,
    n_rows: int,
) -> Tuple[jax.Array, jax.Array]:
    """One fused half-epoch: Gramian + every bucket solve + scatter, as ONE
    device program (single dispatch; XLA schedules/overlaps the buckets).

    Replaces reference WALSEngine::iterate (WALSEngine.cpp:165-218). Returns
    (new factors (n_rows, k), summed un-normalized loss).

    Sharded callers jit this with row-sharded bucket inputs and explicit
    out_shardings; GSPMD then partitions the solves across the mesh and
    inserts the fixed-side all-gather / Gramian psum automatically.
    """
    yty = gramian(y)
    k = y.shape[1]
    x_out = jnp.zeros((n_rows, k), dtype=y.dtype)
    total_loss = jnp.zeros((), dtype=y.dtype)
    for row_ids, col_idx, values, mask in bucket_arrays:
        x, loss = _solve_bucket_body(
            y, yty, col_idx, values, mask, alpha, lam, solver
        )
        # padding rows carry row_id == n_rows -> dropped
        x_out = x_out.at[row_ids].set(x, mode="drop")
        total_loss = total_loss + jnp.sum(loss)
    return x_out, total_loss


half_epoch = functools.partial(jax.jit, static_argnames=("solver", "n_rows"))(
    half_epoch_impl
)


def _chunk_hot(hot_cls, n_chunks, chunk_b):
    """Reshape one class's hot arrays into lax.scan operands."""
    if hot_cls is None:
        return None
    w_a, w_b, conf_hot = hot_cls
    h = w_a.shape[1]
    return (
        w_a.reshape(n_chunks, chunk_b, h),
        w_b.reshape(n_chunks, chunk_b, h),
        conf_hot.reshape(n_chunks, chunk_b),
    )


def _scan_class(y, yty, row_ids, col_idx, values, mask, alpha, lam, x_out,
                loss_in, solver, chunk_b, precision, hot_cls=None,
                y_hot=None, z=None):
    """Scan one width class's chunks into (x_out, loss). Shared body."""
    n_chunks = row_ids.shape[0] // chunk_b
    d = col_idx.shape[1]
    ids_c = row_ids.reshape(n_chunks, chunk_b)
    col_c = col_idx.reshape(n_chunks, chunk_b, d)
    val_c = values.reshape(n_chunks, chunk_b, d)
    mask_c = mask.reshape(n_chunks, chunk_b, d)
    hot_c = _chunk_hot(hot_cls, n_chunks, chunk_b)

    def body(carry, inp):
        x_acc, loss = carry
        ids, col, val, m, hot = inp
        x, l = _solve_bucket_body(
            y, yty, col, val, m, alpha, lam, solver, precision, hot, y_hot,
            z,
        )
        x_acc = x_acc.at[ids].set(x, mode="drop")
        return (x_acc, loss + jnp.sum(l)), None

    (x_out, loss), _ = jax.lax.scan(
        body, (x_out, loss_in), (ids_c, col_c, val_c, mask_c, hot_c)
    )
    return x_out, loss


def _scan_class_build(y, yty, col_idx, values, mask, alpha, lam, chunk_b,
                      precision, hot_cls=None, y_hot=None, z=None):
    """Scan one width class's chunks through the BUILD stage only, stacking
    the per-row normal equations: returns (A (N,k,k), b (N,k), conf (N,))."""
    n_chunks = col_idx.shape[0] // chunk_b
    d = col_idx.shape[1]
    col_c = col_idx.reshape(n_chunks, chunk_b, d)
    val_c = values.reshape(n_chunks, chunk_b, d)
    mask_c = mask.reshape(n_chunks, chunk_b, d)
    hot_c = _chunk_hot(hot_cls, n_chunks, chunk_b)

    def body(_, inp):
        col, val, m, hot = inp
        return None, _build_bucket(
            y, yty, col, val, m, alpha, lam, precision, hot, y_hot, z
        )

    _, (a_s, b_s, conf_s) = jax.lax.scan(
        body, None, (col_c, val_c, mask_c, hot_c)
    )
    k = y.shape[1]
    return (
        a_s.reshape(-1, k, k),
        b_s.reshape(-1, k),
        conf_s.reshape(-1),
    )


def _solve_side(y, class_arrays, chunk_sizes, n_rows, alpha, lam, solver,
                precision, class_solve=True, hot=None, x_init=None):
    """All width classes of one side inside a single trace.

    class_solve=True (default) runs the three stages at SIDE granularity:
    per width class, a chunked BUILD scan (bounds gather/einsum working-set
    size) stacks that class's normal equations; the stacked (A, b) of ALL
    classes are then concatenated and factored+solved by ONE wide batched
    Cholesky, and written back by ONE scatter. The XLA solves' long serial
    dependency chains are latency-bound, so they run once per half-epoch on
    a maximal-width batch, not once per scan step on narrow ones.
    """
    yty = gramian(y)
    # callers may pass a pre-placed accumulator (e.g. row-sharded zeros) so
    # donated next-epoch programs keep their compiled layout
    x_out = (
        x_init if x_init is not None
        else jnp.zeros((n_rows, y.shape[1]), dtype=y.dtype)
    )
    loss = jnp.zeros((), dtype=y.dtype)
    if hot is not None:
        hot_ids, hot_classes = hot
        y_hot, z = hot_tables(y[hot_ids], precision)
    else:
        hot_classes = [None] * len(class_arrays)
        y_hot = z = None
    if class_solve:
        parts = [
            _scan_class_build(
                y, yty, col_idx, values, mask, alpha, lam, chunk_b, precision,
                hot_cls, y_hot, z,
            )
            for (_, col_idx, values, mask), chunk_b, hot_cls in zip(
                class_arrays, chunk_sizes, hot_classes
            )
        ]
        a = jnp.concatenate([p[0] for p in parts], axis=0)
        b = jnp.concatenate([p[1] for p in parts], axis=0)
        conf_sum = jnp.concatenate([p[2] for p in parts], axis=0)
        row_ids = jnp.concatenate([c[0] for c in class_arrays], axis=0)
        x = _solve_dispatch(a, b, solver)
        loss = loss + jnp.sum(_loss_from_solution(x, b, conf_sum, lam))
        x_out = x_out.at[row_ids].set(x, mode="drop")
    else:
        for (row_ids, col_idx, values, mask), chunk_b, hot_cls in zip(
            class_arrays, chunk_sizes, hot_classes
        ):
            x_out, loss = _scan_class(
                y, yty, row_ids, col_idx, values, mask, alpha, lam, x_out,
                loss, solver, chunk_b, precision, hot_cls, y_hot, z,
            )
    return x_out, loss


def train_epoch_impl(
    user_factors: jax.Array,  # (U, k) — donated
    item_factors: jax.Array,  # (I, k) — donated
    user_arrays,  # list of (row_ids, col_idx, values, mask), user side
    item_arrays,  # same, item side
    alpha: jax.Array,
    lam: jax.Array,
    solver: str,
    precision: str,
    n_users: int,
    n_items: int,
    user_chunks: Tuple[int, ...],
    item_chunks: Tuple[int, ...],
    class_solve: bool = True,
    user_hot=None,  # (hot_ids, [per-class (w_a, w_b, conf_hot)]) or None
    item_hot=None,
):
    """One FULL WALS epoch (both half-epochs) as a single device program.

    One dispatch + one host sync per epoch: through high-latency runtimes
    (or at small k) per-program round-trips otherwise dominate — fusing the
    ~22 width-class scans of both sides cuts epoch latency by ~5x here.
    Matches reference WALSEngine::optimize epoch order (WALSEngine.cpp:82-96):
    users solved against items, then items against new users; the returned
    item-side loss is the one the reference logs.
    """
    del user_factors  # recomputed from scratch each epoch (reference zeroes)
    u_new, loss_u = _solve_side(
        item_factors, user_arrays, user_chunks, n_users, alpha, lam, solver,
        precision, class_solve, user_hot,
    )
    v_new, loss_v = _solve_side(
        u_new, item_arrays, item_chunks, n_items, alpha, lam, solver,
        precision, class_solve, item_hot,
    )
    return u_new, v_new, loss_u, loss_v


train_epoch = functools.partial(
    jax.jit,
    static_argnames=(
        "solver",
        "precision",
        "n_users",
        "n_items",
        "user_chunks",
        "item_chunks",
        "class_solve",
    ),
    donate_argnums=(0, 1),
)(train_epoch_impl)


def train_epochs_impl(
    user_factors: jax.Array,  # (U, k) — donated
    item_factors: jax.Array,  # (I, k) — donated
    user_arrays,
    item_arrays,
    alpha: jax.Array,
    lam: jax.Array,
    solver: str,
    precision: str,
    n_users: int,
    n_items: int,
    user_chunks: Tuple[int, ...],
    item_chunks: Tuple[int, ...],
    nepochs: int,
    class_solve: bool = True,
    user_hot=None,
    item_hot=None,
):
    """The WHOLE training run (``nepochs`` full epochs) as ONE device program.

    A ``lax.scan`` over epochs around :func:`train_epoch_impl`'s body: when no
    per-epoch host work is requested (no always-compute metrics, no
    checkpointing) there is nothing an epoch boundary needs the host for, so
    the per-epoch dispatch + sync round-trips can be removed entirely. This is
    what makes small datasets (ml100k-scale) fast through high-latency
    runtimes: one dispatch per RUN instead of one per epoch.

    Returns (u_final, v_final, loss_v_per_epoch (nepochs,)) — the same
    item-side losses the reference logs each epoch (WALSEngine.cpp:82-96).
    """
    def body(carry, _):
        _, v = carry
        u_new, _ = _solve_side(
            v, user_arrays, user_chunks, n_users, alpha, lam, solver,
            precision, class_solve, user_hot,
        )
        v_new, loss_v = _solve_side(
            u_new, item_arrays, item_chunks, n_items, alpha, lam, solver,
            precision, class_solve, item_hot,
        )
        return (u_new, v_new), loss_v

    (u_final, v_final), losses = jax.lax.scan(
        body, (user_factors, item_factors), None, length=nepochs
    )
    return u_final, v_final, losses


train_epochs = functools.partial(
    jax.jit,
    static_argnames=(
        "solver",
        "precision",
        "n_users",
        "n_items",
        "user_chunks",
        "item_chunks",
        "nepochs",
        "class_solve",
    ),
    donate_argnums=(0, 1),
)(train_epochs_impl)


def width_class_solve_impl(
    y: jax.Array,  # (n_cols, k) fixed factors
    yty: jax.Array,  # (k, k)
    row_ids: jax.Array,  # (N_w,) int32, N_w % chunk_b == 0
    col_idx: jax.Array,  # (N_w, D)
    values: jax.Array,  # (N_w, D)
    mask: jax.Array,  # (N_w, D)
    alpha: jax.Array,
    lam: jax.Array,
    x_out: jax.Array,  # (n_rows, k) — donated accumulator
    loss_in: jax.Array,  # () — running loss
    solver: str,
    chunk_b: int,
    precision: str = "highest",
    hot_cls=None,
    y_hot=None,
    z=None,
) -> Tuple[jax.Array, jax.Array]:
    """Solve one width class by lax.scan over fixed-size chunks.

    One small compiled module per (D, chunk_b) shape regardless of how many
    rows the class holds — the scan body (gather + einsum A-build + batched
    Cholesky + scatter) is compiled once and iterated. This is what keeps
    MovieLens-20M at ~17 programs per side instead of ~450 unrolled solves.
    """
    return _scan_class(
        y, yty, row_ids, col_idx, values, mask, alpha, lam, x_out, loss_in,
        solver, chunk_b, precision, hot_cls, y_hot, z,
    )


width_class_solve = functools.partial(
    jax.jit,
    static_argnames=("solver", "chunk_b", "precision"),
    donate_argnums=(8,),
)(width_class_solve_impl)


def iterate_side_classes(
    y: jax.Array,
    classes,  # list of (row_ids, col_idx, values, mask) device tuples
    chunk_sizes: List[int],
    n_rows: int,
    alpha,
    lam,
    solver: str = "cholesky",
    dtype=jnp.float32,
    solve_fn=None,
    x_init=None,
    precision: str = "highest",
    hot=None,
) -> Tuple[jax.Array, float]:
    """One half-epoch over width classes (one dispatch per class)."""
    if solve_fn is None:
        solve_fn = width_class_solve
    yty = gramian(y)
    k = y.shape[1]
    # callers may pass a pre-placed accumulator (e.g. sharded zeros) so the
    # donate-into-sharded-output chain starts without a layout copy
    x_out = (
        x_init if x_init is not None else jnp.zeros((n_rows, k), dtype=y.dtype)
    )
    loss = jnp.zeros((), dtype=y.dtype)
    alpha = jnp.asarray(alpha, dtype=dtype)
    lam = jnp.asarray(lam, dtype=dtype)
    if hot is not None:
        hot_ids, hot_classes = hot
        y_hot, z = hot_tables(y[hot_ids], precision)
    else:
        hot_classes = [None] * len(classes)
        y_hot = z = None
    for (row_ids, col_idx, values, mask), chunk_b, hot_cls in zip(
        classes, chunk_sizes, hot_classes
    ):
        x_out, loss = solve_fn(
            y,
            yty,
            row_ids,
            col_idx,
            values,
            mask,
            alpha,
            lam,
            x_out,
            loss,
            solver=solver,
            chunk_b=chunk_b,
            precision=precision,
            hot_cls=hot_cls,
            y_hot=y_hot,
            z=z,
        )
    return x_out, float(loss)


def iterate_side(
    y: jax.Array,
    buckets: List[Bucket],
    n_rows: int,
    nfactors: int,
    alpha: float,
    lam: float,
    solver: str = "cholesky",
    dtype=jnp.float32,
) -> Tuple[jax.Array, float]:
    """Convenience wrapper over :func:`half_epoch` for host-side buckets."""
    del nfactors
    arrays = [
        (
            jnp.asarray(b.row_ids),
            jnp.asarray(b.col_idx),
            jnp.asarray(b.values, dtype=dtype),
            jnp.asarray(b.mask),
        )
        for b in buckets
    ]
    alpha_arr = jnp.asarray(alpha, dtype=dtype)
    lam_arr = jnp.asarray(lam, dtype=dtype)
    x_out, total_loss = half_epoch(
        y, arrays, alpha_arr, lam_arr, solver, n_rows
    )
    return x_out, float(total_loss)


def compute_scores(
    user_factors: jax.Array,
    item_factors: jax.Array,
    item_biases: jax.Array | None = None,
    user_idx: jax.Array | None = None,
) -> jax.Array:
    """Dense score matrix: scores[t, i] = bias_i + <p_u(t), q_i>.

    Replaces the reference's per-test-user scoring loop
    (qmf/Engine.cpp:73-96) with one matmul over all test users x items.
    """
    u = user_factors if user_idx is None else user_factors[user_idx]
    scores = jnp.matmul(u, item_factors.T, precision=_PRECISION)
    if item_biases is not None:
        scores = scores + item_biases[None, :]
    return scores


def naive_reference_solve(
    y: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    alpha: float,
    lam: float,
) -> Tuple[np.ndarray, float]:
    """Float64 numpy oracle of the reference per-row update, for tests.

    Direct transcription of the math in WALSEngine.cpp:266-310 (loops and
    all), used as the numeric ground truth the batched path must match.
    """
    k = y.shape[1]
    a = y.T @ y
    b = np.zeros(k)
    loss = 0.0
    for c, v in zip(cols, vals):
        yj = y[c]
        b += yj * (1.0 + alpha * v)
        a += np.outer(yj, yj) * (alpha * v)
        loss += 1.0 + alpha * v
    b_mat = a.copy()
    a = a + lam * np.eye(k)
    x = np.linalg.solve(a, b)
    loss += x @ b_mat @ x - 2.0 * x @ b
    return x, loss
