"""Hot/cold split WALS build ("head-dense" normal equations).

Ratings data is power-law: the top-H hottest columns of a side cover a
large share of the nonzeros (synthetic ml20m: top-1024 items cover 59% of
entries, top-4096 cover 78%). The normal-equation build pays per gathered
factor row (benchmarks/gather_micro.py), so the head's gathers are a large
share of a WALS epoch's build.

The split moves the head onto the tensor cores. At init, per side:

- entries whose column is in the top-H hot set are removed from the
  degree-packed stream (ops/packing.py, ops/device_pack.py pack the COLD
  entries only; rows left with zero cold entries keep a fully-masked slot
  in the min-width class), and
- the hot entries become STATIC dense per-packed-row weight matrices

      W_a[row, rank] = alpha * r        (A's confidence weight)
      W_b[row, rank] = 1 + alpha * r    (b's preference weight)
      conf_hot[row]  = sum_hot (1 + alpha * r)   (loss bookkeeping)

  with zeros where unobserved. The alpha * r weights never change across
  epochs, so W is built once.

Per half-epoch the fixed side's hot rows y_hot (H, k) yield the rank-1
table Z (H, k*k) with Z[h] = vec(y_h y_h^T) (ops/als_ops.hot_tables), and
every build chunk adds

    A += (W_a @ Z).reshape(B, k, k),      b += W_b @ y_hot

— two dense GEMMs carrying the head's exact contribution (same math
as the reference's per-signal accumulation, qmf/wals/WALSEngine.cpp:
266-310, just summed in a different order).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Cost-model constants for auto hot-width selection, measured on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit: the per-row cost of the bf16 row
# gather (benchmarks/gather_micro.py "base": 0.23 ns/row at (14336, 64),
# 0.10 at (11520, 256)) and the bf16 rate of the (N, H) @ (H, k^2) hot
# GEMM at the ml20m user side (benchmarks/hot_micro.py gemm: 334-584
# TFLOP/s for H = 1024-8192).
_GATHER_NS_PER_ROW = 0.2
_GEMM_FLOPS = 4.5e14
_AUTO_CANDIDATES = (256, 512, 1024, 2048, 4096, 8192)
# Cap W_a+W_b memory (bytes per element decided by the caller's store
# dtype; the cap below assumes 2-byte bf16 storage).
_W_BUDGET_BYTES = 2 << 30


def top_hot_columns(col_degrees: np.ndarray, h: int) -> np.ndarray:
    """Ids of the ``h`` highest-degree columns (stable ties)."""
    h = int(min(h, len(col_degrees)))
    if h <= 0:
        return np.zeros((0,), dtype=np.int64)
    # argpartition then sort the head: O(n + h log h)
    part = np.argpartition(col_degrees, len(col_degrees) - h)[-h:]
    return part[np.argsort(col_degrees[part], kind="stable")[::-1]]


def rank_lookup(hot_ids: np.ndarray, n_cols: int) -> np.ndarray:
    """(n_cols,) int32: column id -> rank in the hot set, or ``h`` if cold."""
    h = len(hot_ids)
    out = np.full(n_cols, h, dtype=np.int32)
    out[hot_ids] = np.arange(h, dtype=np.int32)
    return out


def auto_hot_width(
    col_degrees: np.ndarray,
    n_build_rows: int,
    k: int,
    fill: float = 0.8,
    store_bytes: int = 2,
) -> int:
    """Pick H minimizing modeled build time: cold gathers + hot GEMM.

    cold(H) ~ (nnz - coverage(H)) / fill * _GATHER_NS_PER_ROW
    hot(H)  ~ n_build_rows * H * (k^2 + k) * 2 / _GEMM_FLOPS

    Returns 0 when no candidate beats the unsplit build (e.g. a flat,
    non-power-law degree distribution) or when W would blow the memory
    budget. The model is intentionally coarse — it only needs to find the
    knee of the Zipf curve, and every constant is overridable by passing an
    explicit hot width in the engine config.
    """
    nnz = int(col_degrees.sum())
    if nnz == 0 or n_build_rows == 0:
        return 0
    deg_sorted = np.sort(col_degrees)[::-1]
    cum = np.cumsum(deg_sorted)
    best_h, best_t = 0, nnz / fill * _GATHER_NS_PER_ROW * 1e-9
    for h in _AUTO_CANDIDATES:
        if h > len(deg_sorted):
            break
        if 2 * n_build_rows * h * store_bytes > _W_BUDGET_BYTES:
            break
        cold = (nnz - int(cum[h - 1])) / fill * _GATHER_NS_PER_ROW * 1e-9
        hot = n_build_rows * h * (k * k + k) * 2 / _GEMM_FLOPS
        if cold + hot < best_t:
            best_h, best_t = h, cold + hot
    return best_h


@functools.partial(
    jax.jit, static_argnames=("n_slots", "h", "compute_dtype", "store_dtype")
)
def _build_w_impl(
    hot_rows: jax.Array,  # (nh,) int32 build-side row ids
    hot_ranks: jax.Array,  # (nh,) int32 in [0, h)
    hot_vals: jax.Array,  # (nh,) ratings
    pos_lookup: jax.Array,  # (n_rows + 1,) int32 row -> packed slot (or n_slots)
    alpha: jax.Array,
    n_slots: int,
    h: int,
    compute_dtype,
    store_dtype,
):
    pos = pos_lookup[hot_rows]
    idx = pos * h + hot_ranks
    vals = hot_vals.astype(compute_dtype)
    aw = alpha.astype(compute_dtype) * vals
    size = (n_slots + 1) * h  # slot n_slots is the scatter dump
    w_a = jnp.zeros((size,), compute_dtype).at[idx].add(aw, mode="drop")
    obs = jnp.zeros((size,), compute_dtype).at[idx].add(1, mode="drop")
    conf = (
        jnp.zeros((n_slots + 1,), compute_dtype)
        .at[pos]
        .add(1 + aw, mode="drop")
    )
    w_b = (w_a + obs).astype(store_dtype).reshape(n_slots + 1, h)[:n_slots]
    w_a = w_a.astype(store_dtype).reshape(n_slots + 1, h)[:n_slots]
    return w_a, w_b, conf[:n_slots]


def build_hot_classes(
    hot_rows: jax.Array,
    hot_cols: jax.Array,
    hot_vals: jax.Array,
    col_rank: jax.Array,  # (n_cols,) int32 device (see rank_lookup)
    class_row_ids: Sequence[np.ndarray],  # packed row ids per width class
    n_rows: int,
    h: int,
    alpha: float,
    compute_dtype,
    store_dtype,
) -> List[Tuple[jax.Array, jax.Array, jax.Array]]:
    """Per-width-class (W_a, W_b, conf_hot) device arrays in packed order.

    ``class_row_ids`` is each class's host-side packed row-id vector
    (padding rows hold ``n_rows``); the W rows line up 1:1 so the epoch
    scan slices W chunks alongside the class's (col_idx, values, mask).
    """
    sizes = [len(ids) for ids in class_row_ids]
    n_slots = int(sum(sizes))
    if (n_slots + 1) * h > np.iinfo(np.int32).max:
        # the flat scatter index is int32 (jax x64 is off); auto selection
        # never gets here (memory budget), explicit widths must not either
        raise ValueError(
            f"hot width {h} with {n_slots} packed rows overflows the int32 "
            "scatter index; lower the hot width"
        )
    pos = np.full(n_rows + 1, n_slots, dtype=np.int32)
    off = 0
    for ids in class_row_ids:
        real = ids[ids < n_rows]
        pos[real] = off + np.nonzero(ids < n_rows)[0].astype(np.int32)
        off += len(ids)
    w_a, w_b, conf = _build_w_impl(
        hot_rows,
        col_rank[hot_cols],
        hot_vals,
        jnp.asarray(pos),
        jnp.asarray(alpha),
        n_slots=n_slots,
        h=h,
        compute_dtype=jnp.dtype(compute_dtype),
        store_dtype=jnp.dtype(store_dtype),
    )
    out = []
    off = 0
    for s in sizes:
        out.append((w_a[off : off + s], w_b[off : off + s],
                    conf[off : off + s]))
        off += s
    return out
