"""SPMD sharded WALS over a device mesh.

This module is the SPMD answer to the reference's entire distributed
layer (reference distributed/: Scheduler + Labor + hand-rolled TCP wire
protocol). The mapping (SURVEY.md section 2.6 P4, 5.8):

- kPushRate (dataset broadcast to every labor, Scheduler.cpp:225-266)
  -> bucket tensors are laid out ONCE with their row axis sharded over the
  mesh; each device holds only its shard (better than the reference, which
  replicates the whole dataset on every labor).
- kPushFixed (fixed-factor broadcast each half-epoch, Scheduler.cpp:268-326)
  -> factor matrices live ROW-SHARDED between epochs; when one side becomes
  the fixed side of a solve, GSPMD inserts one all-gather over NVLink.
- kCalc / kCalcRsp (dynamic 10k-row bucket scatter + row gather-back,
  RunOneTask.cpp:160-243) -> static row sharding of each degree-bucket;
  solves run where the rows live and the solved factors STAY sharded (the
  gather-back disappears). Because rows inside a degree bucket have
  near-identical cost, static sharding is load-balanced by construction —
  no dynamic work stealing needed.
- YtY Gramian: computable from a row-sharded Y as per-shard k x k matmuls
  + one psum over NVLink (sharded_gramian below; replaces each labor's full
  OpenMP computeXtX over the whole fixed matrix, Labor.cpp:297-307).

The per-bucket compute itself is the SAME fused program as single-chip
(qmf_tpu.ops.als_ops.half_epoch_impl) — distribution is purely jit
in/out_shardings, the opposite of the reference where distribution was a
second 2,600-LoC codebase.

Multi-host deployment uses jax.distributed (see qmf_tpu.distributed); this
module is agnostic to whether mesh devices live on one host or many.
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qmf_tpu.ops import als_ops
from qmf_tpu.ops.packing import Bucket


def sharded_gramian(y: jax.Array, mesh: Mesh, axis_name: str = "d") -> jax.Array:
    """YtY with the item axis sharded: local k x k matmul + psum over NVLink.

    Rows are zero-padded up to a mesh multiple (zero rows add nothing to
    YtY), so any factor-matrix height shards evenly.
    """
    n = y.shape[0]
    pad = (-n) % mesh.size
    if pad:
        y = jnp.concatenate([y, jnp.zeros((pad, y.shape[1]), dtype=y.dtype)])

    def local(y_blk):
        g = jnp.matmul(
            y_blk.T, y_blk, precision=jax.lax.Precision.HIGHEST
        )
        return jax.lax.psum(g, axis_name)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis_name, None),
        out_specs=P(),
    )(y)


class ShardedBuckets:
    """Degree buckets with the row axis sharded over the mesh."""

    def __init__(self, buckets: List[Bucket], mesh: Mesh, dtype, axis_name="d"):
        row = NamedSharding(mesh, P(axis_name))
        row2 = NamedSharding(mesh, P(axis_name, None))
        self.row_ids = [jax.device_put(b.row_ids, row) for b in buckets]
        self.col_idx = [jax.device_put(b.col_idx, row2) for b in buckets]
        self.values = [
            jax.device_put(b.values.astype(dtype), row2) for b in buckets
        ]
        self.mask = [jax.device_put(b.mask, row2) for b in buckets]

    def arrays(self):
        return [
            (self.row_ids[i], self.col_idx[i], self.values[i], self.mask[i])
            for i in range(len(self.row_ids))
        ]

    def __len__(self):
        return len(self.row_ids)


def make_sharded_width_class_solve(mesh: Mesh, axis_name: str = "d"):
    """jit of the width-class scan solve with sharded in/outputs.

    Output factors come back row-sharded over the mesh (they feed the next
    half-epoch as the fixed side, where GSPMD all-gathers them); the loss is
    replicated. The scan chunks shard on their row axis, so solves run
    where the rows live.
    """
    out_shardings = (
        NamedSharding(mesh, P(axis_name, None)),
        NamedSharding(mesh, P()),
    )
    return jax.jit(
        als_ops.width_class_solve_impl,
        static_argnames=("solver", "chunk_b", "precision"),
        donate_argnums=(8,),
        out_shardings=out_shardings,
    )


def make_sharded_train_epoch(mesh: Mesh, axis_name: str = "d"):
    """jit of the fused whole-epoch program with EXPLICIT output shardings.

    Both factor matrices come back row-sharded over the mesh (the layout the
    next epoch's all-gather analysis depends on); losses are replicated.
    Inputs (width-class chunk arrays) are already row-sharded by
    ShardedBuckets, so GSPMD partitions every solve across the mesh and the
    fixed-side all-gather + Gramian psum are inserted automatically.
    """
    row = NamedSharding(mesh, P(axis_name, None))
    rep = NamedSharding(mesh, P())
    return jax.jit(
        als_ops.train_epoch_impl,
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
        out_shardings=(row, row, rep, rep),
    )


def make_sharded_train_epochs(mesh: Mesh, axis_name: str = "d"):
    """jit of the fused whole-RUN program (lax.scan over epochs) with
    explicit sharded outputs — the multi-chip analog of
    als_ops.train_epochs. Factors stay row-sharded across every epoch of
    the scan; per-epoch losses are replicated."""
    row = NamedSharding(mesh, P(axis_name, None))
    rep = NamedSharding(mesh, P())
    return jax.jit(
        als_ops.train_epochs_impl,
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
        out_shardings=(row, row, rep),
    )


def pad_rows(n: int, mesh: Mesh) -> int:
    """Smallest mesh-divisible height >= n."""
    return n + ((-n) % mesh.size)


def iterate_side_sharded(
    y: jax.Array,
    buckets: ShardedBuckets,
    chunk_sizes,
    n_rows: int,
    nfactors: int,
    alpha,
    lam,
    mesh: Mesh,
    solver: str = "cholesky",
    dtype=jnp.float32,
    axis_name: str = "d",
    solve_fn=None,
    precision: str = "highest",
    hot=None,
) -> Tuple[jax.Array, float]:
    """One sharded half-epoch; returns (row-sharded new factors, loss sum)."""
    if solve_fn is None:
        solve_fn = make_sharded_width_class_solve(mesh, axis_name)
    x_init = jax.device_put(
        jnp.zeros((n_rows, y.shape[1]), dtype=y.dtype),
        NamedSharding(mesh, P(axis_name, None)),
    )
    return als_ops.iterate_side_classes(
        y,
        buckets.arrays(),
        chunk_sizes,
        n_rows,
        alpha,
        lam,
        solver=solver,
        dtype=dtype,
        solve_fn=solve_fn,
        x_init=x_init,
        precision=precision,
        hot=hot,
    )
