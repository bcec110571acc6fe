"""BPR training engine (Bayesian Personalized Ranking).

Device-side re-design of the reference ``BPREngine``
(qmf/bpr/BPREngine.{h,cpp,-inl.h}):

- ``init`` (reference BPREngine.cpp:65-105): keep elements with value >= 1.0
  as positive (user, item) pairs, index ids in first-occurrence order, build
  the per-user positive sets (as a sorted key array for device binary
  search), pre-sample a fixed seeded train eval set, init factors/biases
  uniform(+-bound).
- ``init_test`` (reference BPREngine.cpp:107-144): filter to known ids,
  build the test positive map, pre-sample the seeded test eval set
  (negatives rejected against the TEST map only, matching
  ``useTestItemMap=true``), and dense avg-metric test rows.
- ``optimize`` (reference BPREngine.cpp:146-176): the reference runs Hogwild
  lock-free SGD over ``num_hogwild_threads``. Here each epoch is a
  permutation of the positive pairs processed in minibatches of
  ``batch_size * num_negative_samples`` triplets; all updates in a batch read
  pre-batch parameters and scatter-add their gradients — the deterministic
  synchronous equivalent of Hogwild's unsynchronized concurrency (validated
  statistically like reference BPREngineTest.cpp:80-157).
- divergence guard: the reference CHECKs isfinite on every loss derivative
  (BPREngine.cpp:184-185); here factor finiteness is checked each epoch and
  raises with the same guidance.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from qmf_tpu.config import BPRConfig
from qmf_tpu.data.dataset import Dataset
from qmf_tpu.data.id_index import MISSING_IDX, IdIndex
from qmf_tpu.models.engine import Engine
from qmf_tpu.ops import als_ops, bpr_ops
from qmf_tpu.ops.bpr_ops import BPRParams
from qmf_tpu.utils.logging import log


class BPREngine(Engine):
    def __init__(
        self,
        config: BPRConfig,
        metrics_engine=None,
        eval_num_neg: int = 3,
        eval_seed: int = 42,
    ):
        self.config = config
        self.metrics_engine = metrics_engine
        self.eval_num_neg = eval_num_neg
        self.eval_seed = eval_seed
        self.dtype = jnp.dtype(config.dtype)
        self.learning_rate = config.init_learning_rate

        self.user_index: Optional[IdIndex] = None
        self.item_index: Optional[IdIndex] = None
        self.params: Optional[BPRParams] = None
        self._data_users: Optional[np.ndarray] = None  # (n,) positive pairs
        self._data_items: Optional[np.ndarray] = None
        self._pos_set = None  # CSR per-user positive sets (device)
        self._eval_set: Optional[tuple] = None  # (users, pos, neg) device
        self._test_eval_set: Optional[tuple] = None
        self.test_users: Optional[np.ndarray] = None
        self.test_labels: Optional[np.ndarray] = None
        self._step_key = jax.random.PRNGKey(config.init_seed)
        self._grouped = False
        self._grp_up = None  # (n_stream, 2) interleaved [user, item] rows
        self._last_overflow = None

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

    @property
    def _grp_users(self) -> jax.Array:
        """Column view of the interleaved grouped stream (diagnostics)."""
        return self._grp_up[:, 0]

    @property
    def _grp_items(self) -> jax.Array:
        return self._grp_up[:, 1]

    # --- lifecycle -----------------------------------------------------------
    def init(self, dataset: Dataset) -> None:
        if self.params is not None:
            raise RuntimeError("engine was already initialized with train data")
        cfg = self.config
        if cfg.neg_sampler not in ("word", "rounds"):
            raise ValueError(f"unknown BPR neg_sampler {cfg.neg_sampler!r}")
        if cfg.item_scatter not in ("seq", "merged", "dense"):
            # reject typos up front: the scan body treats any unknown value
            # as "seq", which would silently mis-label an A/B measurement
            raise ValueError(f"unknown BPR item_scatter {cfg.item_scatter!r}")
        stages = self._init_stages = {}  # stage -> seconds (observability)
        t_stage = time.time()

        def _mark(name):
            nonlocal t_stage
            stages[name] = round(time.time() - t_stage, 3)
            t_stage = time.time()

        # positives: value >= 1.0, ids indexed in first-appearance order;
        # index + full-stream lookup come from ONE unique pass per side
        keep = dataset.values >= 1.0
        users_raw = dataset.user_ids[keep]
        items_raw = dataset.item_ids[keep]
        self.user_index, u_idx = IdIndex.from_first_occurrence_with_lookup(
            users_raw
        )
        self.item_index, i_idx = IdIndex.from_first_occurrence_with_lookup(
            items_raw
        )
        self._data_users = u_idx.astype(np.int32)
        self._data_items = i_idx.astype(np.int32)
        _mark("index")

        # one 20M-row lexsort feeds BOTH the CSR set and the bitmap build
        self._pos_set, sorted_u, sorted_i = bpr_ops.make_pos_set(
            self._data_users, self._data_items, self.nusers,
            return_sorted=True,
        )
        _mark("pos_set")
        # O(1) membership bitmap for the hot sampler when the id space
        # fits the budget (U*I/8 bytes). Beyond it, a blocked Bloom filter
        # (memory independent of n_items) + compacted exact CSR verify
        # keeps the grouped fast path at any catalog scale; plain CSR
        # binary search remains the final fallback.
        bitmap_bytes = self.nusers * ((self.nitems + 31) // 32) * 4
        # int32 word indexing bounds the exact bitmap regardless of budget;
        # beyond it the Bloom path (built for exactly that regime) takes over
        bitmap_feasible = (
            self.nusers * ((self.nitems + 31) // 32) < 2**31
        )
        self._pos_bloom = None
        if bitmap_feasible and bitmap_bytes <= cfg.bitmap_budget_mb * (1 << 20):
            self._pos_bitmap = bpr_ops.make_pos_bitmap(
                sorted_u, sorted_i, self.nusers, self.nitems,
                assume_lex_sorted=True,
            )
        else:
            self._pos_bitmap = None
            avg_deg = max(1, len(self._data_users) // max(1, self.nusers))
            bits = 1 << max(8, (cfg.bloom_bits_per_pos * avg_deg - 1)
                            .bit_length())
            bits = min(bits, 1 << 20)
            self._pos_bloom = bpr_ops.make_pos_bloom(
                self._data_users, self._data_items, self.nusers, bits
            )
            log.info(
                "BPR positive set beyond exact-bitmap budget (%d MB > %d "
                "MB): blocked Bloom membership, %d bits/user (%.1f MB)",
                bitmap_bytes >> 20, cfg.bitmap_budget_mb, bits,
                self.nusers * bits / 8 / 2**20,
            )

        _mark("membership")

        # grouped fast path: ONE stream row per positive pair; the row's
        # num_negative_samples negatives live as 2-bit round indices
        # (ops/bpr_ops.py sgd_epoch_grouped). Falls back to the legacy
        # triplet stream when preconditions fail.
        n_pos = len(self._data_users)
        grp_bs = min(cfg.batch_size, max(1, n_pos))
        if not cfg.grouped_epoch:
            reject = "disabled by config (grouped_epoch=False)"
        else:
            reject = bpr_ops.grouped_path_reject_reason(
                self.nusers,
                self.nitems,
                cfg.num_negative_samples,
                cfg.neg_resample_rounds,
                grp_bs,
                has_bitmap=(self._pos_bitmap is not None
                            or self._pos_bloom is not None),
            )
        if reject is not None:
            log.info(
                "BPR grouped fast path unavailable (%s): falling back to "
                "the triplet-stream epoch (~2x slower)", reject,
            )
        self._grouped = reject is None
        self._last_overflow = None
        if self._grouped:
            self._grp_batch = grp_bs
            pad = (-n_pos) % grp_bs
            gu = np.concatenate(
                [self._data_users, np.zeros(pad, np.int32)]
            ) if pad else self._data_users
            gi = np.concatenate(
                [self._data_items, np.zeros(pad, np.int32)]
            ) if pad else self._data_items
            # interleaved [user, item] rows: the epoch shuffle is then ONE
            # row gather (random-gather cost is per gathered ROW)
            self._grp_up = jnp.asarray(
                np.stack(
                    [gu.astype(np.int32), gi.astype(np.int32)], axis=1
                )
            )
            self._n_real_pos = n_pos
            self._n_real_triplets = n_pos * cfg.num_negative_samples
            n_slots = len(gu) * cfg.num_negative_samples
            # expected collision rate of a uniform candidate:
            # P(cand in user's positives) averaged over stream slots
            # = sum_u deg(u)^2 / (n_pos * n_items). Dense small catalogs
            # (ml100k: ~8%) need a far larger buffer than sparse ones
            # (ml20m: ~0.7%); 3x headroom keeps overflows rare without a
            # config change per dataset. collide_cap_frac stays the floor.
            # Degrees come from the CSR indptr already built above — the
            # DEDUPLICATED counts (collisions are tested against the dedup
            # set, so raw multiplicities would overestimate p), and no
            # second full-stream bincount pass.
            degs = np.diff(np.asarray(self._pos_set.indptr))
            p_est = float((degs.astype(np.float64) ** 2).sum()) / (
                max(1, n_pos) * max(1, self.nitems)
            )
            cap_frac = max(cfg.collide_cap_frac, min(0.5, 3.0 * p_est))
            if self._pos_bloom is not None:
                # bloom mode compacts true collisions PLUS ~5% false
                # positives; give the buffer extra headroom
                cap_frac = max(cap_frac, 1.0 / 8.0)
            self._collide_cap = max(1024, int(n_slots * cap_frac))
            log.info(
                "BPR grouped epoch path: %d positives (+%d pad) x %d "
                "negatives, batch %d, collision cap %d",
                n_pos, pad, cfg.num_negative_samples, grp_bs,
                self._collide_cap,
            )
        else:
            self._build_triplet_stream()
        _mark("stream")

        self._post_stream_init()
        _mark("eval_and_params")
        log.info("BPR init stages (s): %s", stages)

    def _build_triplet_stream(self) -> None:
        """Legacy triplet stream: each positive pair repeated
        num_negative_samples times (reference iterate(),
        BPREngine-inl.h:21-29), padded to a batch multiple with zero
        weights."""
        cfg = self.config
        self._grouped = False
        tri_u = np.repeat(self._data_users, cfg.num_negative_samples)
        tri_i = np.repeat(self._data_items, cfg.num_negative_samples)
        self._n_real_triplets = len(tri_u)
        bs = min(cfg.batch_size, max(1, len(tri_u)))
        if (
            self._pos_bitmap is not None
            and self.nitems <= (1 << bpr_ops._PACK_SHIFT)
            and bs & (bs - 1) == 0
        ):
            # packed path: pad to a power of two so the epoch shuffle can
            # be a sort-free bijective index hash (bpr_ops._mix_bijection)
            n_pad = max(bs, 1 << (len(tri_u) - 1).bit_length())
            pad = n_pad - len(tri_u)
        else:
            pad = (-len(tri_u)) % bs
        w = np.ones(len(tri_u) + pad, dtype=np.float32)
        if pad:
            tri_u = np.concatenate([tri_u, np.zeros(pad, np.int32)])
            tri_i = np.concatenate([tri_i, np.zeros(pad, np.int32)])
            w[-pad:] = 0.0
        self._tri_users = jnp.asarray(tri_u.astype(np.int32))
        self._tri_items = jnp.asarray(tri_i.astype(np.int32))
        self._tri_weights = jnp.asarray(w, dtype=self.dtype)

    def _post_stream_init(self) -> None:
        # fixed seeded train eval set (reference BPREngine.cpp:84-87).
        # Negatives are rejection-sampled ON DEVICE (16 rounds ~= exact):
        # no 100s-of-MB host->device triplet transfer, no host loop.
        # NOTE: the 16-round CSR rejection program kernel-faulted the
        # runtime this code was first written for at MovieLens-20M scale
        # when dispatched in one piece (the fault surfaced at the NEXT sync);
        # use the O(1) bitmap membership when available and chunk the CSR
        # fallback into bounded dispatches.
        ev_u = jnp.repeat(
            jnp.asarray(self._data_users), self.eval_num_neg
        )
        ev_p = jnp.repeat(
            jnp.asarray(self._data_items), self.eval_num_neg
        )
        t0 = time.time()
        ev_n = self._sample_eval_negatives(ev_u)
        ev_n.block_until_ready()
        if hasattr(self, "_init_stages"):
            self._init_stages["eval_neg"] = round(time.time() - t0, 3)
        self._eval_set = (ev_u, ev_p, ev_n)

        # model init (reference BPREngine.cpp:89-104)
        cfg = self.config
        self.learning_rate = cfg.init_learning_rate
        init_rng = np.random.default_rng(cfg.init_seed)
        bound = cfg.init_distribution_bound
        uf = init_rng.uniform(-bound, bound, size=(self.nusers, cfg.nfactors))
        itf = init_rng.uniform(-bound, bound, size=(self.nitems, cfg.nfactors))
        ib = (
            init_rng.uniform(-bound, bound, size=self.nitems)
            if cfg.use_biases
            else np.zeros(self.nitems)
        )
        self.params = BPRParams(
            jnp.asarray(uf, dtype=self.dtype),
            jnp.asarray(itf, dtype=self.dtype),
            jnp.asarray(ib, dtype=self.dtype),
        )

    def init_test(self, test_dataset: Dataset) -> None:
        if self._test_eval_set is not None:
            raise RuntimeError("engine was already initialized with test data")
        uidx = self.user_index.lookup(test_dataset.user_ids)
        iidx = self.item_index.lookup(test_dataset.item_ids)
        valid = (
            (test_dataset.values >= 1.0)
            & (uidx != MISSING_IDX)
            & (iidx != MISSING_IDX)
        )
        t_users = uidx[valid].astype(np.int32)
        t_items = iidx[valid].astype(np.int32)

        # negatives rejected against the TEST positive map only
        # (reference BPREngine.cpp:126-136, useTestItemMap=true); sampled
        # on device like the train eval set
        ev_u = jnp.repeat(jnp.asarray(t_users), self.eval_num_neg)
        ev_p = jnp.repeat(jnp.asarray(t_items), self.eval_num_neg)
        if len(t_users):
            test_pos_set = bpr_ops.make_pos_set(t_users, t_items, self.nusers)
            ev_n = self._sample_eval_negatives(ev_u, pos_set=test_pos_set)
        else:
            ev_n = jnp.zeros(0, dtype=jnp.int32)
        self._test_eval_set = (ev_u, ev_p, ev_n)

        if self.metrics_engine is not None and self.metrics_engine.test_avg_metrics:
            self.test_users, self.test_labels = self.init_avg_test_data(
                test_dataset,
                self.user_index,
                self.item_index,
                self.metrics_engine.config.num_test_users,
                self.metrics_engine.config.seed,
            )

    def _sample_eval_negatives(self, ev_u, pos_set=None):
        """Rejection-sample eval negatives (seeded, fixed for all epochs).

        ``pos_set``: reject against this CSR set instead of the train set
        (init_test passes the TEST positive map, reference
        useTestItemMap=true). The O(1) bitmap shortcut only applies to the
        train set; every CSR path is chunked into bounded dispatches — the
        16-round CSR program kernel-faults this runtime when dispatched
        over tens of millions of rows in one piece (see _post_stream_init's
        NOTE)."""
        key = jax.random.PRNGKey(self.eval_seed)
        if pos_set is None:
            pos_set = self._pos_set
            if self._pos_bitmap is not None:
                return bpr_ops.sample_negatives(
                    key, ev_u, pos_set, self.nitems, rounds=16,
                    bitmap=self._pos_bitmap,
                )
        chunk = 4_000_000
        if ev_u.shape[0] <= chunk:
            return bpr_ops.sample_negatives(
                key, ev_u, pos_set, self.nitems, rounds=16
            )
        outs = []
        for start in range(0, ev_u.shape[0], chunk):
            key, sub = jax.random.split(key)
            outs.append(
                bpr_ops.sample_negatives(
                    sub, ev_u[start:start + chunk], pos_set,
                    self.nitems, rounds=16,
                )
            )
        return jnp.concatenate(outs)

    # --- training -------------------------------------------------------------
    def _epoch(self) -> None:
        """One epoch = ONE device program (shuffle + sample + all steps)."""
        cfg = self.config
        self._step_key, sub = jax.random.split(self._step_key)
        if self._grouped:
            self.params, self._last_overflow = bpr_ops.sgd_epoch_grouped(
                self.params,
                sub,
                self._grp_up,
                self._pos_bitmap
                if self._pos_bitmap is not None
                else self._pos_bloom,
                jnp.asarray(self.learning_rate, dtype=self.dtype),
                jnp.asarray(cfg.user_lambda, dtype=self.dtype),
                jnp.asarray(cfg.item_lambda, dtype=self.dtype),
                jnp.asarray(cfg.bias_lambda, dtype=self.dtype),
                n_items=self.nitems,
                n_real=self._n_real_pos,
                use_biases=cfg.use_biases,
                num_neg=cfg.num_negative_samples,
                neg_rounds=cfg.neg_resample_rounds,
                shuffle=cfg.shuffle_training_set,
                batch_size=self._grp_batch,
                collide_cap=self._collide_cap,
                pos_set=self._pos_set if self._pos_bloom is not None else None,
                item_scatter=cfg.item_scatter,
                sampler=cfg.neg_sampler,
            )
            return
        self.params = bpr_ops.sgd_epoch(
            self.params,
            sub,
            self._tri_users,
            self._tri_items,
            self._tri_weights,
            self._pos_set,
            jnp.asarray(self.learning_rate, dtype=self.dtype),
            jnp.asarray(cfg.user_lambda, dtype=self.dtype),
            jnp.asarray(cfg.item_lambda, dtype=self.dtype),
            jnp.asarray(cfg.bias_lambda, dtype=self.dtype),
            n_items=self.nitems,
            use_biases=cfg.use_biases,
            neg_rounds=cfg.neg_resample_rounds,
            shuffle=cfg.shuffle_training_set,
            batch_size=min(cfg.batch_size, self._tri_users.shape[0]),
            unroll=cfg.unroll_membership,
            bitmap=self._pos_bitmap,
            n_real=self._n_real_triplets,
        )

    def enable_checkpointing(self, directory: str, every: int = 1) -> None:
        """Per-epoch checkpoint + auto-resume (qmf_tpu/utils/checkpoint)."""
        self._ckpt_dir = directory
        self._ckpt_every = max(1, every)

    def _place_params(self) -> None:
        """Placement hook after a resume; the sharded engine re-pins the
        replicated parameter layouts its epoch programs expect."""

    def _maybe_resume(self) -> int:
        from qmf_tpu.utils import checkpoint as ckpt

        directory = getattr(self, "_ckpt_dir", None)
        if not directory:
            return 1
        path = ckpt.latest_checkpoint(directory)
        if path is None:
            return 1
        epoch, arrays, meta = ckpt.load_checkpoint(path)
        self.params = BPRParams(
            jnp.asarray(arrays["user_factors"], dtype=self.dtype),
            jnp.asarray(arrays["item_factors"], dtype=self.dtype),
            jnp.asarray(arrays["item_biases"], dtype=self.dtype),
        )
        self._place_params()  # sharded engine re-pins replicated layouts
        self.learning_rate = float(meta["learning_rate"])
        if "step_key" in arrays:
            # restore RNG state so resumed epochs draw the same
            # shuffle/negative-sample sequence a straight run would
            self._step_key = jnp.asarray(
                arrays["step_key"], dtype=jnp.uint32
            )
        log.info("resumed from %s at epoch %d", path, epoch)
        return epoch + 1

    def _maybe_checkpoint(self, epoch: int) -> None:
        from qmf_tpu.utils import checkpoint as ckpt

        directory = getattr(self, "_ckpt_dir", None)
        if directory and epoch % getattr(self, "_ckpt_every", 1) == 0:
            ckpt.save_checkpoint(
                directory,
                epoch,
                {
                    "user_factors": np.asarray(self.params.user_factors),
                    "item_factors": np.asarray(self.params.item_factors),
                    "item_biases": np.asarray(self.params.item_biases),
                    # post-epoch PRNG state (raw uint32 key data)
                    "step_key": np.asarray(self._step_key),
                },
                meta={
                    "engine": "bpr",
                    "learning_rate": self.learning_rate,
                },
            )

    def optimize(self) -> None:
        if self.params is None:
            raise RuntimeError(
                "no factor data, have you initialized the engine?"
            )
        cfg = self.config
        from qmf_tpu.utils.tracing import annotate

        start_epoch = self._maybe_resume()
        for epoch in range(start_epoch, cfg.nepochs + 1):
            t0 = time.time()
            with annotate(f"bpr_epoch_{epoch}"):
                self._epoch()
            # divergence guard (reference CHECK(isfinite), BPREngine.cpp:184)
            if not bool(jnp.all(jnp.isfinite(self.params.user_factors))):
                raise FloatingPointError(
                    "gradients too big, try decreasing the learning rate "
                    "(--init_learning_rate)"
                )
            self.evaluate(epoch, elapsed=time.time() - t0)
            # decay BEFORE checkpointing so a resumed run continues with the
            # same learning rate a straight run would use for epoch+1
            # (reference decays at end of epoch too, BPREngine.cpp:169-171)
            if cfg.decay_rate < 1.0:
                self.learning_rate *= cfg.decay_rate
            self._maybe_checkpoint(epoch)
            # shuffle_training_set is honored on-device inside _epoch
            # (jax.random.permutation of the triplet stream per epoch)

    def evaluate(self, epoch: int, elapsed: float = 0.0) -> None:
        cfg = self.config
        train_loss = (
            float(
                bpr_ops.eval_loss(
                    self.params, *self._eval_set, use_biases=cfg.use_biases
                )
            )
            if self._eval_set is not None and self._eval_set[0].shape[0]
            else -1.0
        )
        test_loss = (
            float(
                bpr_ops.eval_loss(
                    self.params, *self._test_eval_set, use_biases=cfg.use_biases
                )
            )
            if self._test_eval_set is not None and self._test_eval_set[0].shape[0]
            else -1.0
        )
        log.info(
            "epoch %d: train loss = %.10g, test loss = %.10g (%.3fs)",
            epoch,
            train_loss,
            test_loss,
            elapsed,
        )
        if self._last_overflow is not None:
            overflow = int(self._last_overflow)
            self._last_overflow = None
            if overflow > 0:
                log.warning(
                    "BPR presampler collision buffer overflowed by %d "
                    "slots (those kept a colliding candidate); raise "
                    "collide_cap_frac",
                    overflow,
                )

        me = self.metrics_engine
        if (
            me is not None
            and me.test_avg_metrics
            and self.test_users is not None
            and len(self.test_users)
            and (me.config.always_compute or epoch == cfg.nepochs)
        ):
            scores = als_ops.compute_scores(
                self.params.user_factors,
                self.params.item_factors,
                item_biases=(
                    self.params.item_biases if cfg.use_biases else None
                ),
                user_idx=jnp.asarray(self.test_users),
            )
            me.compute_and_record_test_avg_metrics(
                epoch, self.test_labels, scores
            )

    # --- output ----------------------------------------------------------------
    def save_user_factors(self, file_name: str) -> None:
        if self.params is None:
            raise RuntimeError("user factors wasn't initialized")
        self.save_factor_data(
            np.asarray(self.params.user_factors, dtype=np.float64),
            self.user_index,
            file_name,
        )

    def save_item_factors(self, file_name: str) -> None:
        if self.params is None:
            raise RuntimeError("item factors wasn't initialized")
        self.save_factor_data(
            np.asarray(self.params.item_factors, dtype=np.float64),
            self.item_index,
            file_name,
            biases=(
                np.asarray(self.params.item_biases, dtype=np.float64)
                if self.config.use_biases
                else None
            ),
        )
