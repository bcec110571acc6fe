"""Device-side degree-class packing: COO sort + padded gathers on device.

The host-side path (ops/packing.py) sorts 20M-element COO arrays in numpy
and builds ~520 MB of padded (col_idx, values, mask) arrays before
transferring them to the device (the device-side replacement for the
reference's ``groupSignals``, qmf/wals/WALSEngine.cpp:130-163). Through
slow host<->device links that transfer dominates engine init.

This module moves the heavy part onto the device: the raw COO triple
(rows, cols, vals — 12 bytes per rating) is transferred ONCE, then

- both sides' (row, col)-sorted CSR arrays are built with one stable
  two-key ``lax.sort`` each (duplicate (row, col) pairs keep their input
  order, matching numpy's stable radix sort on the host path), and
- every width class's padded (col_idx, values, mask) arrays are produced by
  one fused gather program per side.

Only per-row degrees are needed on the host (one ``np.bincount`` per side)
to plan the static class shapes; the plan is metadata-only and matches
``pack_width_classes``'s class splitting exactly, so device-packed and
host-packed engines produce identical buckets (asserted in
tests/test_device_pack.py).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qmf_tpu.ops.packing import (
    _next_pow2,
    _round_up,
    coalesce_widths,
    pad_widths,
    width_class_chunk,
)


@dataclasses.dataclass
class ClassPlan:
    """Host-side metadata for one width class (static shapes only)."""

    row_ids: np.ndarray  # (n_pad,) int32; padding rows hold n_rows
    d_width: int
    chunk_b: int


def plan_width_classes(
    degrees: np.ndarray,
    n_rows: int,
    batch_rows: int = 4096,
    min_width: int = 8,
    row_multiple: int = 8,
    width_grid: str = "pow2",
    active_mask: np.ndarray | None = None,
    max_classes: int = 0,
    min_class_nnz_frac: float = 0.0,
) -> List[ClassPlan]:
    """Plan width classes from per-row degrees alone (no COO sort needed).

    Replicates ``pack_width_classes``'s splitting: active rows stable-sorted
    by padded width, split at width boundaries, row count padded to a chunk
    multiple with the ``n_rows`` sentinel.

    ``active_mask`` overrides which rows must appear in some class: the
    hot/cold split build (ops/hot.py) packs only COLD entries, but a row
    whose entries are all hot (cold degree 0) still needs its solve slot —
    it lands in the min-width class with a fully-masked signal list.
    """
    active = np.nonzero(
        degrees > 0 if active_mask is None else active_mask
    )[0]
    if len(active) == 0:
        return []
    widths = pad_widths(degrees[active], min_width, width_grid)
    widths = coalesce_widths(
        widths, degrees[active], max_classes, min_class_nnz_frac
    )
    order = np.argsort(widths, kind="stable")
    active, widths = active[order], widths[order]

    plans: List[ClassPlan] = []
    boundaries = np.nonzero(np.diff(widths))[0] + 1
    for cls_rows, d_width in zip(
        np.split(active, boundaries),
        widths[np.concatenate([[0], boundaries])],
    ):
        d_width = int(d_width)
        chunk_b = width_class_chunk(
            d_width, batch_rows, min_width, row_multiple, n_rows=len(cls_rows)
        )
        n_pad = _round_up(len(cls_rows), chunk_b)
        row_ids = np.full(n_pad, n_rows, dtype=np.int32)
        row_ids[: len(cls_rows)] = cls_rows
        plans.append(ClassPlan(row_ids, d_width, chunk_b))
    return plans


def plan_stats(plans: List[ClassPlan], nnz: int) -> dict:
    """Padding-efficiency stats from the metadata plan (mirrors
    packing.packed_stats without touching device arrays)."""
    padded = sum(len(p.row_ids) * p.d_width for p in plans)
    shapes = sorted({(len(p.row_ids), p.d_width) for p in plans})
    return {
        "nnz": nnz,
        "padded_elems": padded,
        "fill_ratio": nnz / max(padded, 1),
        "num_buckets": len(plans),
        "distinct_shapes": shapes,
    }


@functools.partial(jax.jit, static_argnames=("n_rows",))
def sorted_csr(
    rows: jax.Array,  # (nnz,) int32 dense row indices
    cols: jax.Array,  # (nnz,) int32 dense col indices
    vals: jax.Array,  # (nnz,) f32/f64
    n_rows: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Stable (row, col) sort + CSR indptr, all on device.

    Returns (cols_sorted, vals_sorted, indptr (n_rows+1,)). Matches the host
    ``group_rows`` ordering (reference sortDataset order,
    qmf/wals/WALSEngine.cpp:152-163) including duplicate-pair stability.
    """
    rows_s, cols_s, vals_s = jax.lax.sort(
        (rows, cols, vals), num_keys=2, is_stable=True
    )
    indptr = jnp.searchsorted(
        rows_s, jnp.arange(n_rows + 1, dtype=rows.dtype), side="left"
    )
    return cols_s, vals_s, indptr


@functools.partial(jax.jit, static_argnames=("n_rows", "cold_nnz"))
def split_sorted_csr(
    rows: jax.Array,  # (nnz,) int32 dense row indices
    cols: jax.Array,  # (nnz,) int32 dense col indices
    vals: jax.Array,  # (nnz,) f32/f64
    is_hot: jax.Array,  # (nnz,) bool — entry's column is in the hot set
    n_rows: int,
    cold_nnz: int,  # host-counted size of the cold block (static shape)
) -> Tuple[Tuple[jax.Array, jax.Array, jax.Array],
           Tuple[jax.Array, jax.Array, jax.Array]]:
    """One sort that yields BOTH halves of the hot/cold split (ops/hot.py).

    Folding the hot flag into the row key (row + n_rows * is_hot) makes a
    single stable (key, col) sort produce the cold entries as a
    (row, col)-sorted prefix — sliced at the host-known ``cold_nnz`` — and
    the hot entries as a suffix, with no second device sort or host-side
    filtering/transfer. Returns ``((cold cols_s, vals_s, indptr),
    (hot rows, cols, vals))``; the cold triple feeds
    ``pack_width_classes_device(presorted=...)`` unchanged.
    """
    key = rows + jnp.where(is_hot, jnp.int32(n_rows), jnp.int32(0))
    key_s, cols_s, vals_s = jax.lax.sort(
        (key, cols, vals), num_keys=2, is_stable=True
    )
    cold_cols, cold_vals = cols_s[:cold_nnz], vals_s[:cold_nnz]
    indptr = jnp.searchsorted(
        key_s[:cold_nnz], jnp.arange(n_rows + 1, dtype=key_s.dtype),
        side="left",
    )
    hot_rows = key_s[cold_nnz:] - jnp.int32(n_rows)
    return (cold_cols, cold_vals, indptr), (
        hot_rows, cols_s[cold_nnz:], vals_s[cold_nnz:]
    )


def _gather_classes_body(cols_s, vals_s, indptr_ext, degrees_ext, row_ids_list,
                         widths):
    """Build every width class's padded arrays in one traced program.

    ``indptr_ext``/``degrees_ext`` carry one extra sentinel entry at index
    ``n_rows`` (degree 0) so padding row ids gather a fully-masked row.
    """
    nnz = cols_s.shape[0]
    outs = []
    for row_ids, d_width in zip(row_ids_list, widths):
        deg = degrees_ext[row_ids]  # (B,)
        offsets = jnp.arange(d_width, dtype=jnp.int32)[None, :]
        mask = offsets < deg[:, None]
        flat = jnp.clip(
            indptr_ext[row_ids][:, None] + offsets, 0, max(nnz - 1, 0)
        )
        col_idx = jnp.where(mask, cols_s[flat], 0)
        values = jnp.where(mask, vals_s[flat], 0)
        outs.append((col_idx, values, mask))
    return outs


def pack_width_classes_device(
    rows: jax.Array,
    cols: jax.Array,
    vals: jax.Array,
    n_rows: int,
    degrees: np.ndarray,  # host (n_rows,) — from np.bincount
    batch_rows: int = 4096,
    min_width: int = 8,
    row_multiple: int = 8,
    width_grid: str = "pow2",
    active_mask: np.ndarray | None = None,
    presorted=None,  # optional (cols_s, vals_s, indptr) from split_sorted_csr
    max_classes: int = 0,
    min_class_nnz_frac: float = 0.0,
):
    """Device-packed equivalent of ``packing.pack_width_classes``.

    Returns ``(class_arrays, plans)``: per class a (row_ids, col_idx,
    values, mask) tuple of device arrays laid out identically to the host
    packer's output, plus the host-side plans (for chunk sizes / stats).
    """
    plans = plan_width_classes(
        degrees, n_rows, batch_rows, min_width, row_multiple, width_grid,
        active_mask=active_mask, max_classes=max_classes,
        min_class_nnz_frac=min_class_nnz_frac,
    )
    if not plans:
        return [], plans
    if presorted is not None:
        cols_s, vals_s, indptr = presorted
    else:
        cols_s, vals_s, indptr = sorted_csr(rows, cols, vals, n_rows)
    if cols_s.shape[0] == 0:
        # every entry was hot: keep one masked sentinel so the padded
        # gathers below have a valid (fully ignored) source element
        cols_s = jnp.zeros((1,), dtype=cols_s.dtype)
        vals_s = jnp.zeros((1,), dtype=vals_s.dtype)
    indptr_ext = indptr[:-1]  # start offsets, (n_rows,)
    # append sentinel entries at index n_rows: degree 0, start 0
    indptr_ext = jnp.concatenate(
        [indptr_ext, jnp.zeros((1,), dtype=indptr.dtype)]
    )
    degrees_ext = jnp.concatenate(
        [
            jnp.asarray(degrees, dtype=jnp.int32),
            jnp.zeros((1,), dtype=jnp.int32),
        ]
    )
    row_ids_dev = [jnp.asarray(p.row_ids) for p in plans]
    widths = tuple(p.d_width for p in plans)
    gather = jax.jit(
        functools.partial(_gather_classes_body, widths=widths),
        static_argnames=(),
    )
    outs = gather(cols_s, vals_s, indptr_ext, degrees_ext, row_ids_dev)
    return [
        (row_ids_dev[i], outs[i][0], outs[i][1], outs[i][2])
        for i in range(len(plans))
    ], plans
