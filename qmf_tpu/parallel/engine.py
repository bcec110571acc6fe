"""ShardedWALSEngine: WALS training SPMD-sharded over a device mesh.

Drop-in WALSEngine with the solve-row axis of every degree bucket sharded
over a ``jax.sharding.Mesh``. Functionally identical to the single-chip
engine (same math, same loss; tested for equality on a virtual multi-device
CPU mesh) — the distribution is purely a data-layout annotation, the
opposite of the reference where distribution was a second codebase
(reference distributed/, ~2,600 LoC of sockets and buckets).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qmf_tpu.config import WALSConfig
from qmf_tpu.models.wals import WALSEngine
from qmf_tpu.parallel.mesh import make_mesh
from qmf_tpu.parallel.sharded_wals import iterate_side_sharded


class _ShardedClassArrays:
    """Per-width-class device tuples with the row axis mesh-sharded
    (same .arrays() interface as sharded_wals.ShardedBuckets)."""

    def __init__(self, arrays):
        self._arrays = arrays

    def arrays(self):
        return self._arrays

    def __len__(self):
        return len(self._arrays)

    @property
    def row_ids(self):
        return [a[0] for a in self._arrays]

    @property
    def col_idx(self):
        return [a[1] for a in self._arrays]

    @property
    def values(self):
        return [a[2] for a in self._arrays]

    @property
    def mask(self):
        return [a[3] for a in self._arrays]


class ShardedWALSEngine(WALSEngine):
    def __init__(
        self,
        config: WALSConfig,
        metrics_engine=None,
        mesh: Optional[Mesh] = None,
        n_devices: Optional[int] = None,
    ):
        super().__init__(config, metrics_engine)
        self.mesh = mesh if mesh is not None else make_mesh(n_devices)
        self.axis_name = self.mesh.axis_names[0]
        from qmf_tpu.parallel.sharded_wals import (
            make_sharded_train_epoch,
            make_sharded_width_class_solve,
        )

        from qmf_tpu.parallel.sharded_wals import make_sharded_train_epochs

        self._solve_fn = make_sharded_width_class_solve(self.mesh, self.axis_name)
        self._train_epoch_fn = make_sharded_train_epoch(self.mesh, self.axis_name)
        self._train_epochs_fn = make_sharded_train_epochs(self.mesh, self.axis_name)

    def _use_device_pack(self) -> bool:
        # device-side packing builds global (sort + padded gather) programs;
        # with multiple processes the raw COO would itself need a global
        # layout first, so multi-host runs keep the host packer
        if jax.process_count() > 1:
            return False
        return super()._use_device_pack()

    def _shard_classes(self, arrays):
        """Re-place per-class (row_ids, col_idx, values, mask) with the row
        axis sharded over the mesh (device-to-device over NVLink when the
        source is the device packer's output)."""
        row = NamedSharding(self.mesh, P(self.axis_name))
        row2 = NamedSharding(self.mesh, P(self.axis_name, None))
        return [
            (
                jax.device_put(r, row),
                jax.device_put(c, row2),
                jax.device_put(v, row2),
                jax.device_put(m, row2),
            )
            for (r, c, v, m) in arrays
        ]

    def _shard_hot(self, hot_state):
        """Row-shard the per-class static hot weights alongside their class
        arrays; the hot id vector stays replicated (every shard's build
        reads the same fixed-side head)."""
        if hot_state is None:
            return None
        hot_ids, hot_classes = hot_state
        rep = NamedSharding(self.mesh, P())
        row = NamedSharding(self.mesh, P(self.axis_name))
        row2 = NamedSharding(self.mesh, P(self.axis_name, None))
        return (
            jax.device_put(hot_ids, rep),
            [
                (
                    jax.device_put(w_a, row2),
                    jax.device_put(w_b, row2),
                    jax.device_put(conf, row),
                )
                for (w_a, w_b, conf) in hot_classes
            ],
        )

    # init itself is inherited from WALSEngine — the pack/stats/chunks logic
    # lives exactly once there; the three hooks below re-place its outputs
    # over the mesh (the whole difference between the two engines).

    def _row_multiple(self) -> int:
        # every scan chunk's row count divides the mesh so shards are even
        return 8 * self.mesh.size

    def _place_side(self, side: str, arrays, hot, chunks) -> None:
        sharded = _ShardedClassArrays(self._shard_classes(arrays))
        setattr(self, f"_{side}_buckets", sharded)
        setattr(self, f"_{side}_chunks", chunks)
        setattr(self, f"_{side}_hot", self._shard_hot(hot))

    def _install_factors(self, item_factors_np: np.ndarray) -> None:
        # factors live row-sharded across the mesh between half-epochs (the
        # fixed side is all-gathered inside the solve program); sharded
        # layouts need mesh-divisible heights, so device factor matrices are
        # zero-padded and sliced back at the framework boundary (the base
        # engine slices [:nusers]/[:nitems] before eval/save).
        cfg = self.config
        from qmf_tpu.parallel.sharded_wals import pad_rows

        self._pad_users = pad_rows(self.nusers, self.mesh)
        self._pad_items = pad_rows(self.nitems, self.mesh)
        item_f = np.zeros((self._pad_items, cfg.nfactors))
        item_f[: self.nitems] = item_factors_np
        row = NamedSharding(self.mesh, P(self.axis_name, None))
        self.item_factors = jax.device_put(
            jnp.asarray(item_f, dtype=self.dtype), row
        )
        self.user_factors = jax.device_put(
            jnp.zeros((self._pad_users, cfg.nfactors), dtype=self.dtype), row
        )

    def _fused_run(self, nepochs):
        """Whole run as ONE sharded device program: lax.scan over epochs
        with explicit row-sharded factor outputs, so multi-chip
        small-dataset runs get the same one-dispatch-per-run behavior as
        single-chip (factors never leave their shards between epochs)."""
        cfg = self.config
        ub, ib = self._user_buckets, self._item_buckets
        u_new, v_new, losses = self._train_epochs_fn(
            self.user_factors,
            self.item_factors,
            ub.arrays(),
            ib.arrays(),
            jnp.asarray(cfg.confidence_weight, dtype=self.dtype),
            jnp.asarray(cfg.regularization_lambda, dtype=self.dtype),
            solver=self._solver,
            precision=cfg.matmul_precision,
            n_users=self._pad_users,
            n_items=self._pad_items,
            user_chunks=tuple(self._user_chunks),
            item_chunks=tuple(self._item_chunks),
            nepochs=nepochs,
            class_solve=cfg.class_solve,
            user_hot=self._user_hot,
            item_hot=self._item_hot,
        )
        self.user_factors = u_new
        self.item_factors = v_new
        return [
            float(l) / self.nusers / self.nitems for l in np.asarray(losses)
        ]

    def _place_factors(self) -> None:
        row = NamedSharding(self.mesh, P(self.axis_name, None))
        self.user_factors = jax.device_put(self.user_factors, row)
        self.item_factors = jax.device_put(self.item_factors, row)

    def _put_row_sharded(self, host_arr: np.ndarray) -> jax.Array:
        """Place a full host array row-sharded over the mesh; works when the
        mesh spans multiple processes (each process feeds its own shards)."""
        row = NamedSharding(self.mesh, P(self.axis_name, None))
        arr = np.asarray(host_arr, dtype=self.dtype)
        if jax.process_count() > 1:
            return jax.make_array_from_callback(
                arr.shape, row, lambda idx: arr[idx]
            )
        return jax.device_put(jnp.asarray(arr), row)

    def _restore_factors(self, arrays) -> None:
        """Re-pad checkpointed (unpadded) factors to this mesh's divisible
        heights and pin the row shardings (checkpoints are mesh-agnostic, so
        a resumed run may use a different device/process count)."""
        k = self.config.nfactors
        u = np.zeros((self._pad_users, k), dtype=self.dtype)
        u[: self.nusers] = arrays["user_factors"][: self.nusers]
        v = np.zeros((self._pad_items, k), dtype=self.dtype)
        v[: self.nitems] = arrays["item_factors"][: self.nitems]
        self.user_factors = self._put_row_sharded(u)
        self.item_factors = self._put_row_sharded(v)

    def _checkpoint_arrays(self):
        """Multi-process-safe snapshot: replicate the sharded factors (a
        collective every process must execute — _maybe_checkpoint runs at
        the same point in every worker), then read them host-side. Only
        process 0 writes the file (see _maybe_checkpoint)."""
        if not hasattr(self, "_replicate_fn"):
            # built once: a fresh jax.jit object per epoch would retrace
            self._replicate_fn = jax.jit(
                lambda u, v: (u, v),
                out_shardings=NamedSharding(self.mesh, P()),
            )
        rep = self._replicate_fn(self.user_factors, self.item_factors)
        return {
            "user_factors": np.asarray(rep[0])[: self.nusers],
            "item_factors": np.asarray(rep[1])[: self.nitems],
        }

    def _maybe_checkpoint(self, epoch: int) -> None:
        import jax as _jax

        directory = getattr(self, "_ckpt_dir", None)
        if not directory or epoch % getattr(self, "_ckpt_every", 1) != 0:
            return
        arrays = self._checkpoint_arrays()  # collective: all processes
        if _jax.process_index() == 0:
            from qmf_tpu.utils import checkpoint as ckpt

            ckpt.save_checkpoint(
                directory,
                epoch,
                arrays,
                meta={"nfactors": self.config.nfactors, "engine": "wals"},
            )

    def _fused_epoch(self) -> float:
        """One fused whole-epoch dispatch with explicit sharded outputs
        (padded heights; factors stay row-sharded between epochs)."""
        import jax.numpy as jnp

        cfg = self.config
        ub, ib = self._user_buckets, self._item_buckets
        u_new, v_new, _, loss_v = self._train_epoch_fn(
            self.user_factors,
            self.item_factors,
            ub.arrays(),
            ib.arrays(),
            jnp.asarray(cfg.confidence_weight, dtype=self.dtype),
            jnp.asarray(cfg.regularization_lambda, dtype=self.dtype),
            solver=self._solver,
            precision=cfg.matmul_precision,
            n_users=self._pad_users,
            n_items=self._pad_items,
            user_chunks=tuple(self._user_chunks),
            item_chunks=tuple(self._item_chunks),
            class_solve=cfg.class_solve,
            user_hot=self._user_hot,
            item_hot=self._item_hot,
        )
        self.user_factors = u_new
        self.item_factors = v_new
        return float(loss_v) / self.nusers / self.nitems

    def _iterate(self, side: str) -> float:
        cfg = self.config
        if side == "user":
            fixed, buckets = self.item_factors, self._user_buckets
            chunks, n_pad = self._user_chunks, self._pad_users
            hot = self._user_hot
        else:
            fixed, buckets = self.user_factors, self._item_buckets
            chunks, n_pad = self._item_chunks, self._pad_items
            hot = self._item_hot
        new_factors, total_loss = iterate_side_sharded(
            fixed,
            buckets,
            chunks,
            n_pad,
            cfg.nfactors,
            cfg.confidence_weight,
            cfg.regularization_lambda,
            self.mesh,
            solver=self._solver,
            dtype=self.dtype,
            axis_name=self.axis_name,
            solve_fn=self._solve_fn,
            precision=cfg.matmul_precision,
            hot=hot,
        )
        if side == "user":
            self.user_factors = new_factors
        else:
            self.item_factors = new_factors
        return total_loss / self.nusers / self.nitems
