"""WALS training engine (weighted ALS, Hu/Koren/Volinsky implicit feedback).

Device-side re-design of the reference ``WALSEngine``
(qmf/wals/WALSEngine.{h,cpp}):

- ``init``: builds sorted-id indices and degree-bucketed padded batches for
  both sides (replacing per-user SignalGroup vectors,
  reference WALSEngine.cpp:37-69 + 130-163); initializes item factors
  uniform(+-bound) or from a distribution file; user factors start at zero
  (overwritten in the first half-epoch, same as the reference).
- ``optimize``: per epoch, solve users given items, then items given users;
  the logged train loss comes from the item half-epoch, normalized by
  nusers*nitems — matching reference WALSEngine.cpp:82-96.
- Each half-epoch runs as batched einsum + Cholesky device programs
  (see qmf_tpu/ops/als_ops.py) instead of per-row LAPACK dsysv_ calls.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from qmf_tpu.config import WALSConfig
from qmf_tpu.data.dataset import Dataset
from qmf_tpu.data.factor_io import FactorData
from qmf_tpu.data.id_index import IdIndex
from qmf_tpu.models.engine import Engine
from qmf_tpu.ops import als_ops
from qmf_tpu.ops import hot as hot_ops
from qmf_tpu.ops.packing import (
    chunks_for_classes,
    pack_width_classes,
    packed_stats,
)
from qmf_tpu.utils import platform
from qmf_tpu.utils.logging import log


@dataclasses.dataclass
class DeviceBuckets:
    """Degree-bucketed ratings resident on device (transferred once)."""

    row_ids: List[jax.Array]
    col_idx: List[jax.Array]
    values: List[jax.Array]
    mask: List[jax.Array]

    def __len__(self) -> int:
        return len(self.row_ids)


class WALSEngine(Engine):
    def __init__(
        self,
        config: WALSConfig,
        metrics_engine=None,
    ):
        self.config = config
        self.metrics_engine = metrics_engine
        self.dtype = jnp.dtype(config.dtype)
        self.user_index: Optional[IdIndex] = None
        self.item_index: Optional[IdIndex] = None
        self.user_factors: Optional[jax.Array] = None  # (U, k) device
        self.item_factors: Optional[jax.Array] = None  # (I, k) device
        self._user_buckets: Optional[DeviceBuckets] = None
        self._item_buckets: Optional[DeviceBuckets] = None
        # hot/cold split state per side: (hot_col_ids, per-class
        # (W_a, W_b, conf_hot)) or None (ops/hot.py). The sharded engine
        # row-shards the per-class W arrays alongside their class arrays.
        self._user_hot = None
        self._item_hot = None
        self.test_users: Optional[np.ndarray] = None
        self.test_labels: Optional[np.ndarray] = None
        # optional per-epoch progress hook: fn(epoch, loss, wall_s). The
        # distributed worker uses it for mid-task observability (the analog
        # of the reference's per-bucket progress logs, RunOneTask.cpp:208-212).
        self.progress_cb = None
        if (
            metrics_engine is not None
            and metrics_engine.test_avg_metrics
            and metrics_engine.config.num_test_users == 0
        ):
            log.warning(
                "computing average test metrics on all users can be slow! "
                "Set num_test_users > 0 to sample some of them"
            )

    @property
    def nusers(self) -> int:
        return self.user_index.size if self.user_index else 0

    @property
    def nitems(self) -> int:
        return self.item_index.size if self.item_index else 0

    def _auto_solver(self) -> str:
        """Resolve solver="auto" through the backend policy
        (utils/platform.py); the sharded engine resolves the same way."""
        return platform.auto_solver(self.dtype)

    def _use_device_pack(self) -> bool:
        """Resolve the device_pack="auto" knob (utils/platform.py)."""
        dp = self.config.device_pack
        if dp == "auto":
            return platform.auto_device_pack(self.dtype)
        return bool(dp)

    def _resolve_hot_width(self, col_degrees: np.ndarray,
                           n_build_rows: int) -> int:
        """Resolve the hot_width knob for one side's build (0 = no split)."""
        hw = self.config.hot_width
        if hw == "auto":
            if not platform.auto_hot_split(self.dtype):
                return 0
            return hot_ops.auto_hot_width(
                col_degrees, n_build_rows, self.config.nfactors,
                store_bytes=2 if self._hot_store_dtype() == jnp.bfloat16
                else self.dtype.itemsize,
            )
        return int(hw)

    def _hot_store_dtype(self):
        """Storage dtype for the static hot weight matrices W_a/W_b: bf16
        when the build matmuls run single-pass bf16 anyway, else the
        engine dtype (exact for golden/highest runs)."""
        if (
            self.dtype == jnp.float32
            and self.config.matmul_precision == "default"
        ):
            return jnp.bfloat16
        return self.dtype

    def _pack_side_device(self, r32, c32, vals_d, rows_np, cols_np,
                          n_rows, n_cols, deg_rows, deg_cols, h,
                          row_multiple=8):
        """Device-pack one side's build arrays, optionally hot/cold split.

        Returns (class_arrays, plans, hot_state). With ``h > 0`` the side's
        packed stream carries only entries whose column is OUTSIDE the top-h
        hot set; the hot entries become static dense per-row weight matrices
        (ops/hot.py) and ride GEMMs in the build instead of gathers.
        """
        from qmf_tpu.ops import device_pack

        cfg = self.config
        if h <= 0:
            arrays, plans = device_pack.pack_width_classes_device(
                r32, c32, vals_d, n_rows, deg_rows, cfg.batch_rows,
                row_multiple=row_multiple, width_grid=cfg.width_grid,
                max_classes=cfg.max_width_classes,
                min_class_nnz_frac=cfg.min_class_nnz_frac,
            )
            return arrays, plans, None
        hot_ids = hot_ops.top_hot_columns(deg_cols, h)
        h = len(hot_ids)
        col_rank = hot_ops.rank_lookup(hot_ids, n_cols)
        is_hot_np = col_rank[cols_np] < h
        cold_deg = np.bincount(rows_np[~is_hot_np], minlength=n_rows)
        cold_nnz = int((~is_hot_np).sum())
        col_rank_dev = jnp.asarray(col_rank)
        presorted, hot_coo = device_pack.split_sorted_csr(
            r32, c32, vals_d, col_rank_dev[c32] < h, n_rows, cold_nnz
        )
        arrays, plans = device_pack.pack_width_classes_device(
            r32, c32, vals_d, n_rows, cold_deg, cfg.batch_rows,
            row_multiple=row_multiple, width_grid=cfg.width_grid,
            active_mask=deg_rows > 0, presorted=presorted,
            max_classes=cfg.max_width_classes,
            min_class_nnz_frac=cfg.min_class_nnz_frac,
        )
        hot_classes = hot_ops.build_hot_classes(
            hot_coo[0], hot_coo[1], hot_coo[2], col_rank_dev,
            [p.row_ids for p in plans], n_rows, h,
            cfg.confidence_weight, self.dtype, self._hot_store_dtype(),
        )
        return arrays, plans, (
            jnp.asarray(hot_ids.astype(np.int32)), hot_classes
        )

    def _pack_side_host(self, rows_np, cols_np, vals_np, n_rows, n_cols,
                        deg_rows, deg_cols, h, row_multiple=8):
        """Host-pack one side (optionally hot/cold split) — the CPU/f64
        golden path, and the correctness oracle for the split build."""
        cfg = self.config
        if h <= 0:
            classes = pack_width_classes(
                rows_np, cols_np, vals_np, n_rows, cfg.batch_rows,
                row_multiple=row_multiple, width_grid=cfg.width_grid,
                max_classes=cfg.max_width_classes,
                min_class_nnz_frac=cfg.min_class_nnz_frac,
            )
            return classes, None
        hot_ids = hot_ops.top_hot_columns(deg_cols, h)
        h = len(hot_ids)
        col_rank = hot_ops.rank_lookup(hot_ids, n_cols)
        is_hot = col_rank[cols_np] < h
        classes = pack_width_classes(
            rows_np[~is_hot], cols_np[~is_hot], np.asarray(vals_np)[~is_hot],
            n_rows, cfg.batch_rows, row_multiple=row_multiple,
            width_grid=cfg.width_grid, active_mask=deg_rows > 0,
            max_classes=cfg.max_width_classes,
            min_class_nnz_frac=cfg.min_class_nnz_frac,
        )
        hot_classes = hot_ops.build_hot_classes(
            jnp.asarray(rows_np[is_hot].astype(np.int32)),
            jnp.asarray(cols_np[is_hot].astype(np.int32)),
            jnp.asarray(np.asarray(vals_np)[is_hot], dtype=self.dtype),
            jnp.asarray(col_rank),
            [b.row_ids for b in classes], n_rows, h,
            cfg.confidence_weight, self.dtype, self._hot_store_dtype(),
        )
        return classes, (
            jnp.asarray(hot_ids.astype(np.int32)), hot_classes
        )

    # --- lifecycle -----------------------------------------------------------
    # init is shared with ShardedWALSEngine (parallel/engine.py) through
    # three placement hooks — _row_multiple, _place_side, _install_factors —
    # so the pack/stats/chunks logic exists exactly once and the two engines
    # cannot drift bucket-incompatible.
    def _row_multiple(self) -> int:
        """Row-count multiple every scan chunk must divide into (the sharded
        engine raises it to 8 * mesh.size so shards stay even)."""
        return 8

    def _place_side(self, side: str, arrays, hot, chunks) -> None:
        """Install one packed side. ``arrays`` is a list of per-class
        (row_ids, col_idx, values, mask) device tuples; ``hot`` is the
        optional hot-split state; ``chunks`` the per-class scan chunk
        sizes. The sharded engine overrides this to row-shard everything."""
        buckets = DeviceBuckets(
            row_ids=[a[0] for a in arrays],
            col_idx=[a[1] for a in arrays],
            values=[a[2] for a in arrays],
            mask=[a[3] for a in arrays],
        )
        setattr(self, f"_{side}_buckets", buckets)
        setattr(self, f"_{side}_chunks", chunks)
        setattr(self, f"_{side}_hot", hot)

    def _install_factors(self, item_factors_np: np.ndarray) -> None:
        """Place the initial factor matrices on device (sharded engine:
        pad to mesh-divisible heights and pin row shardings)."""
        self.item_factors = jnp.asarray(item_factors_np, dtype=self.dtype)
        self.user_factors = jnp.zeros(
            (self.nusers, self.config.nfactors), dtype=self.dtype
        )

    def init(self, dataset: Dataset) -> None:
        if self.user_factors is not None or self.item_factors is not None:
            raise RuntimeError("engine was already initialized with train data")
        cfg = self.config
        # Reject typos (and the debug-only "identity" solver) up front: the
        # fused epoch paths call _solve_dispatch directly, bypassing
        # solve_bucket's whitelist.
        if cfg.solver not in (
            "auto", "cholesky", "cholesky_matmul", "schur", "cholesky_xla",
            "lu",
        ):
            raise ValueError(f"unknown WALS solver {cfg.solver!r}")
        if cfg.matmul_precision not in ("highest", "default"):
            # als_ops silently falls back to HIGHEST for unknown names and
            # every `== "default"` fast-path stays off — reject typos so a
            # benchmark can't mislabel the config it actually ran
            raise ValueError(
                f"unknown WALS matmul_precision {cfg.matmul_precision!r} "
                "(expected 'highest' or 'default')"
            )
        self._solver = (
            self._auto_solver() if cfg.solver == "auto" else cfg.solver
        )
        # index + full-stream lookup from ONE unique pass per side (the
        # inverse of the sorted-unique IS the lookup)
        self.user_index, rows = IdIndex.from_sorted_ids_with_lookup(
            dataset.user_ids
        )
        self.item_index, cols = IdIndex.from_sorted_ids_with_lookup(
            dataset.item_ids
        )

        t0 = time.time()
        row_multiple = self._row_multiple()
        deg_u = np.bincount(rows, minlength=self.nusers)
        deg_i = np.bincount(cols, minlength=self.nitems)
        h_user = self._resolve_hot_width(deg_i, int((deg_u > 0).sum()))
        h_item = self._resolve_hot_width(deg_u, int((deg_i > 0).sum()))
        if self._use_device_pack():
            from qmf_tpu.ops import device_pack

            rows32 = jnp.asarray(rows.astype(np.int32))
            cols32 = jnp.asarray(cols.astype(np.int32))
            vals_d = jnp.asarray(dataset.values, dtype=self.dtype)
            u_arrays, u_plans, user_hot = self._pack_side_device(
                rows32, cols32, vals_d, rows, cols, self.nusers, self.nitems,
                deg_u, deg_i, h_user, row_multiple=row_multiple,
            )
            i_arrays, i_plans, item_hot = self._pack_side_device(
                cols32, rows32, vals_d, cols, rows, self.nitems, self.nusers,
                deg_i, deg_u, h_item, row_multiple=row_multiple,
            )
            u_stats = device_pack.plan_stats(u_plans, len(dataset))
            i_stats = device_pack.plan_stats(i_plans, len(dataset))
            u_chunks = [p.chunk_b for p in u_plans]
            i_chunks = [p.chunk_b for p in i_plans]
            pack_kind = "device-packed"
        else:
            user_classes, user_hot = self._pack_side_host(
                rows, cols, dataset.values, self.nusers, self.nitems,
                deg_u, deg_i, h_user, row_multiple=row_multiple,
            )
            item_classes, item_hot = self._pack_side_host(
                cols, rows, dataset.values, self.nitems, self.nusers,
                deg_i, deg_u, h_item, row_multiple=row_multiple,
            )
            u_stats = packed_stats(user_classes)
            i_stats = packed_stats(item_classes)
            u_arrays = [
                (jnp.asarray(b.row_ids), jnp.asarray(b.col_idx),
                 jnp.asarray(b.values, dtype=self.dtype),
                 jnp.asarray(b.mask))
                for b in user_classes
            ]
            i_arrays = [
                (jnp.asarray(b.row_ids), jnp.asarray(b.col_idx),
                 jnp.asarray(b.values, dtype=self.dtype),
                 jnp.asarray(b.mask))
                for b in item_classes
            ]
            u_chunks = chunks_for_classes(
                user_classes, cfg.batch_rows, row_multiple=row_multiple
            )
            i_chunks = chunks_for_classes(
                item_classes, cfg.batch_rows, row_multiple=row_multiple
            )
            pack_kind = "packed"
        self._place_side("user", u_arrays, user_hot, u_chunks)
        self._place_side("item", i_arrays, item_hot, i_chunks)
        log.info(
            "%s %d ratings: users %s, items %s hot=(%d,%d) (%.2fs)",
            pack_kind, len(dataset), u_stats, i_stats, h_user, h_item,
            time.time() - t0,
        )

        # item factors init: uniform or deterministic file; user factors zero
        # (overwritten in the first user half-epoch) — WALSEngine.cpp:55-68.
        item_init = FactorData(self.nitems, cfg.nfactors)
        if cfg.distribution_file:
            item_init.set_factors_from_file(cfg.distribution_file)
        else:
            item_init.set_factors_uniform(
                cfg.init_distribution_bound, np.random.default_rng(cfg.init_seed)
            )
        self._install_factors(item_init.factors)

    def init_test(self, test_dataset: Dataset) -> None:
        if self.test_users is not None:
            raise RuntimeError("engine was already initialized with test data")
        if self.metrics_engine is not None and self.metrics_engine.test_avg_metrics:
            self.test_users, self.test_labels = self.init_avg_test_data(
                test_dataset,
                self.user_index,
                self.item_index,
                self.metrics_engine.config.num_test_users,
                self.metrics_engine.config.seed,
            )

    def _iterate(self, side: str) -> float:
        """One half-epoch. side='user': fix items, solve users; vice versa."""
        cfg = self.config
        if side == "user":
            fixed, buckets, n = self.item_factors, self._user_buckets, self.nusers
            chunks, hot = self._user_chunks, self._user_hot
        else:
            fixed, buckets, n = self.user_factors, self._item_buckets, self.nitems
            chunks, hot = self._item_chunks, self._item_hot
        arrays = [
            (buckets.row_ids[i], buckets.col_idx[i], buckets.values[i],
             buckets.mask[i])
            for i in range(len(buckets))
        ]
        # one scan-based device program per width class
        new_factors, total_loss = als_ops.iterate_side_classes(
            fixed,
            arrays,
            chunks,
            n,
            cfg.confidence_weight,
            cfg.regularization_lambda,
            solver=self._solver,
            dtype=self.dtype,
            precision=cfg.matmul_precision,
            hot=hot,
        )
        if side == "user":
            self.user_factors = new_factors
        else:
            self.item_factors = new_factors
        return total_loss / self.nusers / self.nitems

    def _fused_epoch(self) -> float:
        """One dispatch for the whole epoch (see als_ops.train_epoch)."""
        cfg = self.config
        ub, ib = self._user_buckets, self._item_buckets
        u_arrays = [
            (ub.row_ids[i], ub.col_idx[i], ub.values[i], ub.mask[i])
            for i in range(len(ub))
        ]
        i_arrays = [
            (ib.row_ids[i], ib.col_idx[i], ib.values[i], ib.mask[i])
            for i in range(len(ib))
        ]
        u_new, v_new, _, loss_v = als_ops.train_epoch(
            self.user_factors,
            self.item_factors,
            u_arrays,
            i_arrays,
            jnp.asarray(cfg.confidence_weight, dtype=self.dtype),
            jnp.asarray(cfg.regularization_lambda, dtype=self.dtype),
            solver=self._solver,
            precision=cfg.matmul_precision,
            n_users=self.nusers,
            n_items=self.nitems,
            user_chunks=tuple(self._user_chunks),
            item_chunks=tuple(self._item_chunks),
            class_solve=cfg.class_solve,
            user_hot=self._user_hot,
            item_hot=self._item_hot,
        )
        self.user_factors = u_new
        self.item_factors = v_new
        return float(loss_v) / self.nusers / self.nitems

    def _fused_run(self, nepochs: int) -> List[float]:
        """ALL remaining epochs as ONE device program (als_ops.train_epochs).

        Used when nothing needs the host between epochs (no always-compute
        metrics, no checkpointing): removes the per-epoch dispatch + sync
        round-trips that dominate small datasets through high-latency
        runtimes. Returns the per-epoch train losses (reference-normalized).
        """
        cfg = self.config
        ub, ib = self._user_buckets, self._item_buckets
        u_arrays = [
            (ub.row_ids[i], ub.col_idx[i], ub.values[i], ub.mask[i])
            for i in range(len(ub))
        ]
        i_arrays = [
            (ib.row_ids[i], ib.col_idx[i], ib.values[i], ib.mask[i])
            for i in range(len(ib))
        ]
        u_new, v_new, losses = als_ops.train_epochs(
            self.user_factors,
            self.item_factors,
            u_arrays,
            i_arrays,
            jnp.asarray(cfg.confidence_weight, dtype=self.dtype),
            jnp.asarray(cfg.regularization_lambda, dtype=self.dtype),
            solver=self._solver,
            precision=cfg.matmul_precision,
            n_users=self.nusers,
            n_items=self.nitems,
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

    def _can_fuse_run(self) -> bool:
        """True when no per-epoch host work is required between epochs."""
        me = self.metrics_engine
        per_epoch_eval = (
            me is not None
            and me.test_avg_metrics
            and self.test_users is not None
            and len(self.test_users)
            and me.config.always_compute
        )
        return (
            self.config.fuse_epoch
            and not per_epoch_eval
            and not getattr(self, "_ckpt_dir", None)
        )

    def enable_checkpointing(self, directory: str, every: int = 1) -> None:
        """Per-epoch checkpoint + auto-resume (see qmf_tpu/utils/checkpoint).

        The recovery-semantics replacement for the reference's per-bucket
        reassignment fault tolerance (RunOneTask.cpp:177-240).
        """
        self._ckpt_dir = directory
        self._ckpt_every = max(1, every)

    def _maybe_resume(self) -> int:
        """Returns the first epoch to run (1 if no checkpoint)."""
        from qmf_tpu.utils import checkpoint as ckpt

        directory = getattr(self, "_ckpt_dir", None)
        if not directory:
            return 1
        path = ckpt.latest_checkpoint(directory)
        if path is None:
            return 1
        epoch, arrays, _ = ckpt.load_checkpoint(path)
        self._restore_factors(arrays)
        log.info("resumed from %s at epoch %d", path, epoch)
        return epoch + 1

    def _restore_factors(self, arrays) -> None:
        """Load checkpointed (unpadded) factors; the sharded engine
        overrides this to re-pad to mesh-divisible heights and re-pin
        row shardings."""
        self.user_factors = jnp.asarray(arrays["user_factors"], dtype=self.dtype)
        self.item_factors = jnp.asarray(arrays["item_factors"], dtype=self.dtype)

    def _place_factors(self) -> None:
        """Placement hook; the sharded engine re-pins loaded factors."""

    def _checkpoint_arrays(self):
        """UNPADDED factor snapshot (shapes independent of any mesh, so a
        resumed run may use a different device count than the writer)."""
        return {
            "user_factors": np.asarray(self.user_factors)[: self.nusers],
            "item_factors": np.asarray(self.item_factors)[: self.nitems],
        }

    def _maybe_checkpoint(self, epoch: int) -> None:
        from qmf_tpu.utils import checkpoint as ckpt

        directory = getattr(self, "_ckpt_dir", None)
        if directory and epoch % getattr(self, "_ckpt_every", 1) == 0:
            ckpt.save_checkpoint(
                directory,
                epoch,
                self._checkpoint_arrays(),
                meta={"nfactors": self.config.nfactors, "engine": "wals"},
            )

    @staticmethod
    def _check_finite(loss: float, epoch: int) -> None:
        """Divergence guard (the WALS analog of the reference BPR's
        CHECK(isfinite), qmf/bpr/BPREngine.cpp:184-185; reference WALS
        never needs one because it computes in f64).

        The f32/bf16 path can lose positive-definiteness of the normal
        equations on pathologically conditioned inputs — e.g. massive
        duplicate (user, item) multiplicity summing thousands of
        confidence terms into one rank-1 direction (measured: such a
        dataset NaNs in f32 on the device while f64/CPU is fine). Fail
        loudly with the remediation options instead of silently saving NaN
        factors.
        """
        if not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite WALS training loss at epoch {epoch}: the "
                "f32/bf16 device path lost positive-definiteness of the "
                "normal equations (extreme conditioning, e.g. massive "
                "duplicate user-item multiplicity). Retry with "
                "--matmul_precision=highest, --solver=lu (the dsysv_-"
                "faithful indefinite solver), or --dtype=float64."
            )

    def optimize(self) -> None:
        if self.user_factors is None or self.item_factors is None:
            raise RuntimeError(
                "no factor data, have you initialized the engine?"
            )
        from qmf_tpu.utils.tracing import annotate

        start_epoch = self._maybe_resume()
        nepochs = self.config.nepochs
        if start_epoch <= nepochs and self._can_fuse_run():
            # whole run in one program; log per-epoch losses afterwards with
            # the same record format
            t0 = time.time()
            with annotate("wals_run"):
                losses = self._fused_run(nepochs - start_epoch + 1)
            elapsed = time.time() - t0
            for i, loss in enumerate(losses):
                log.info(
                    "epoch %d: train loss = %.10g (%.3fs)",
                    start_epoch + i,
                    loss,
                    elapsed / len(losses),
                )
            self._check_finite(losses[-1], nepochs)
            if self.progress_cb is not None:
                self.progress_cb(nepochs, losses[-1], elapsed)
            self.evaluate(nepochs)
            return
        for epoch in range(start_epoch, nepochs + 1):
            t0 = time.time()
            with annotate(f"wals_epoch_{epoch}"):
                if self.config.fuse_epoch:
                    loss = self._fused_epoch()
                else:
                    self._iterate("user")
                    loss = self._iterate("item")
            jax.block_until_ready(self.item_factors)
            dt = time.time() - t0
            log.info(
                "epoch %d: train loss = %.10g (%.3fs)", epoch, loss, dt
            )
            self._check_finite(loss, epoch)
            if self.progress_cb is not None:
                self.progress_cb(epoch, loss, dt)
            self.evaluate(epoch)
            self._maybe_checkpoint(epoch)

    def evaluate(self, epoch: int) -> None:
        me = self.metrics_engine
        if (
            me is not None
            and me.test_avg_metrics
            and self.test_users is not None
            and len(self.test_users)
            and (me.config.always_compute or epoch == self.config.nepochs)
        ):
            log.info("do compute evaluate ...")
            # slices are no-ops single-chip; the sharded engine keeps device
            # factor matrices padded to a mesh-divisible height
            scores = als_ops.compute_scores(
                self.user_factors[: self.nusers],
                self.item_factors[: self.nitems],
                user_idx=jnp.asarray(self.test_users),
            )
            me.compute_and_record_test_avg_metrics(
                epoch, self.test_labels, scores
            )

    # --- output --------------------------------------------------------------
    def save_user_factors(self, file_name: str) -> None:
        if self.user_factors is None:
            raise RuntimeError("user factors wasn't initialized")
        self.save_factor_data(
            np.asarray(self.user_factors, dtype=np.float64)[: self.nusers],
            self.user_index,
            file_name,
        )

    def save_item_factors(self, file_name: str) -> None:
        if self.item_factors is None:
            raise RuntimeError("item factors wasn't initialized")
        self.save_factor_data(
            np.asarray(self.item_factors, dtype=np.float64)[: self.nitems],
            self.item_index,
            file_name,
        )
