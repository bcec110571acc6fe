"""Engine configuration dataclasses.

Field names and defaults mirror the reference's config structs so that users
of the reference can carry over hyperparameters unchanged:

- ``WALSConfig``    — reference qmf/wals/WALSEngine.h:35-42 and the gflags
  defaults in qmf/wals.cpp:26-31.
- ``BPRConfig``     — reference qmf/bpr/BPREngine.h:38-51 and qmf/bpr.cpp:28-44.
- ``MetricsConfig`` — reference qmf/metrics/MetricsEngine.h:29-33.

Device-side additions (dtype/solver/batching knobs) are grouped at the end
of each dataclass and have safe defaults.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class WALSConfig:
    """Weighted-ALS hyperparameters (Hu/Koren/Volinsky implicit feedback)."""

    nepochs: int = 10
    nfactors: int = 30
    regularization_lambda: float = 0.05
    confidence_weight: float = 40.0
    init_distribution_bound: float = 0.01
    # Path to a file with one float per line used to deterministically
    # initialize item factors (row-major), enabling bit-comparable runs
    # across implementations (reference qmf/FactorData.h:74-100).
    distribution_file: str = ""

    # --- device knobs (no reference equivalent) ---
    # Computation dtype on device. float32 is the accelerator choice; the
    # reference computes in float64 on CPU (qmf/Types.h:24).
    dtype: str = "float32"
    # "auto" resolves per backend (utils/platform.py): "cholesky_xla" for
    # f32 on the GPU (the fastest solve per ml20m epoch on the card; PERF.md
    # "Solve kernel vs XLA"), the unrolled blocked XLA Cholesky on the CPU
    # and for f64.
    # Explicit choices: "cholesky" (blocked XLA SPD factor+solve),
    # "cholesky_xla" (jnp.linalg.cholesky + triangular solves), "schur"
    # (recursive explicit SPD inverse), "cholesky_matmul" (matmul-panel
    # substitutions), or "lu" (general symmetric, matches dsysv_'s
    # tolerance of indefinite systems).
    solver: str = "auto"
    # Max rows per solve bucket on device; bounds compile count and memory.
    batch_rows: int = 4096
    # Matmul precision for the normal-equation builds: "highest" (full
    # f32) or "default" (bf16 inputs with f32 accumulation, ~1e-3 relative
    # error that WALS absorbs). The Cholesky solve always runs in f32.
    matmul_precision: str = "highest"
    # Run each epoch (both half-epochs) as one fused device program — one
    # dispatch + one host sync per epoch. Disable to dispatch per width
    # class (useful for debugging or compile-memory-constrained targets).
    fuse_epoch: bool = True
    # Solve granularity inside the fused epoch: True stacks each width
    # class's normal equations from a chunked build scan and runs ONE wide
    # batched Cholesky per class (the solve's serial dependency chain is
    # latency-bound, so wider batches are ~2x faster at ML-20M scale);
    # False solves inside every scan step (lower peak memory).
    class_solve: bool = True
    # Degree-class padding grid: "pow2" pads each row's signal list to the
    # next power of two (fill ~0.70 on MovieLens-20M); "pow2_15" adds the
    # 1.5x points (8,12,16,24,32,48,...) — fill ~0.83, i.e. ~16% less padded
    # build work, at ~2x the compiled width-class shapes; "pow2_q" adds the
    # quarter points (8,10,12,14,16,20,...) — fill ~0.92 at ~4x the shapes
    # (the build's gather stream costs per padded ROW, so fill buys epoch
    # time at the price of compile time).
    width_grid: str = "pow2_15"
    # Random seed for item-factor init when distribution_file is empty.
    # The reference draws from std::random_device (non-deterministic,
    # WALSEngine.cpp:58-62); we default to a fixed seed for reproducibility.
    init_seed: int = 0
    # Build the degree-class arrays on device (ops/device_pack.py): transfer
    # the raw 12-byte/rating COO once and sort + pad on the accelerator,
    # instead of building ~2x larger padded arrays in host numpy and
    # transferring those. "auto" enables it for float32 runs on the GPU
    # (utils/platform.py); True/False force it.
    device_pack: bool | str = "auto"
    # Hot/cold split build (ops/hot.py): the contribution of each side's H
    # hottest fixed-side columns rides dense GEMMs against static
    # per-row weight matrices instead of per-entry factor-row gathers
    # (random gathers cost per gathered row, so the power-law head can
    # dominate the build). "auto" picks H per side from the
    # degree-distribution cost model on f32 GPU runs (0 when the model says
    # it wouldn't pay, 0 on CPU/f64 golden runs); an int forces the same H
    # on both sides; 0 disables.
    hot_width: int | str = "auto"
    # Bound compiled program shapes: at most max_width_classes width
    # classes remain per side (0 = no cap) — the pairs whose merge adds the
    # least padding (rows * width gap) merge first, which preferentially
    # removes sparse classes. Every distinct width is a compiled shape, so
    # the cap bounds warm-up (compile) time. min_class_nnz_frac > 0 adds an
    # unconditional nnz-share merge rule; it is OFF by default because it
    # ignores padding cost (it pushed ml20m's smallest item class from
    # width 8 to 128, +3.8M padded gather rows per epoch).
    max_width_classes: int = 12
    min_class_nnz_frac: float = 0.0


@dataclasses.dataclass
class BPRConfig:
    """BPR-SGD hyperparameters."""

    nepochs: int = 10
    nfactors: int = 30
    init_learning_rate: float = 0.05
    bias_lambda: float = 1.0
    user_lambda: float = 0.025
    item_lambda: float = 0.0025
    decay_rate: float = 0.9
    use_biases: bool = False
    init_distribution_bound: float = 0.01
    num_negative_samples: int = 3
    # Reference meaning: Hogwild thread count (qmf/bpr/BPREngine.cpp:153-164).
    # Here it has no effect on the math: Hogwild's asynchronous races are
    # replaced by synchronous vectorized minibatches (see BPREngine docs).
    # Kept for CLI compatibility.
    num_hogwild_threads: int = 1
    shuffle_training_set: bool = True

    # --- device knobs ---
    dtype: str = "float32"
    # Triplets per device step. Plays the role Hogwild's concurrency played:
    # updates within a batch read the same (pre-batch) parameters, like
    # concurrent Hogwild threads reading unsynchronized state.
    batch_size: int = 8192
    # Rounds of negative re-sampling for candidates that collide with the
    # user's positive set (reference rejection loop BPREngine-inl.h:48-60).
    neg_resample_rounds: int = 4
    # Statically unroll the membership binary search instead of running it
    # as a fori_loop (opt-in: the unrolled form crashed the accelerator
    # runtime this code was first written for; not yet re-validated).
    unroll_membership: bool = False
    # Memory budget (MB) for the dense packed (user, item) membership
    # bitmap used by the hot negative sampler: ONE random gather per
    # candidate instead of ~log2(max_degree) chained binary-search gathers,
    # and the enabler of the shared-word sampler. The bitmap lives in device
    # memory (sparse-built on device, so host/transfer cost scales with nnz
    # not U*I); 4 GB covers ~34G (user, item) cells — e.g. 200k x 100k
    # catalogs. Above the budget (U*I/8 bytes) the sampler falls back to
    # blocked-Bloom membership + exact CSR verify.
    bitmap_budget_mb: int = 4096
    # Grouped packed epochs (one scan row per positive, negatives
    # reconstructed from 2-bit round indices — ops/bpr_ops.py
    # sgd_epoch_grouped). Preconditions checked by grouped_path_reject_reason;
    # set False to force the legacy triplet-stream paths.
    grouped_epoch: bool = True
    # Capacity of the compacted collision buffer in the grouped presampler,
    # as a fraction of the negative-slot count. Colliders beyond the cap
    # keep their (positive) round-0 candidate — the engine logs when that
    # happens. 1/16 covers avg_degree/n_items collision rates up to ~6%.
    collide_cap_frac: float = 1.0 / 16.0
    # Item-side scatter strategy for the grouped scan's 1+num_neg B-row
    # updates per step. "seq": sequential scatter-adds on the live table
    # (the conservatively-stable default). "merged": one wide
    # (1+num_neg)*B-row scatter (kernel-faulted the accelerator runtime
    # this code was first written for; retestable). "dense": segment-sum
    # the update stream into
    # a fresh zeroed (n_items, k) accumulator and add it densely — the
    # scatter stops read-modify-writing the live factor table, removing
    # its serialization against the next step's gathers (measured A/B in
    # benchmarks/bpr_dedup_scan_micro.py). All three are semantically
    # identical (duplicate-index contributions sum either way).
    item_scatter: str = "seq"
    # Negative-sampler strategy for the grouped epoch when the exact bitmap
    # is available. "word": each positive ROW gathers ONE bitmap word; slot
    # j's probe rounds r < R-1 test spread-out bits of that word
    # (distinct-mod-32 offsets per slot/round) and round R-1 is a fresh
    # unchecked candidate — one-word-per-row presampling (random-gather
    # cost is per gathered ROW, and this removes
    # the where-compaction + per-round gathers + 2/3 of the word-gather
    # rows; benchmarks/bpr_presample_micro.py), with residual
    # positive-candidate probability ~p^2 vs p^R. "rounds": the compacted
    # exact-rejection sampler (each round an independent uniform
    # candidate). Bloom-membership catalogs and configs with
    # num_neg*(rounds-1) > 15 always use "rounds" (+ CSR verify on bloom).
    neg_sampler: str = "word"
    # Blocked-Bloom membership for catalogs beyond the exact-bitmap budget
    # (ops/bpr_ops.py PosBloom): per-user block sized to
    # next_pow2(bloom_bits_per_pos * avg_degree) bits, clamped to
    # [256, 2^20]. 8 bits/positive => ~5% false-positive rate with the
    # 2-hash scheme; memory is U * block/8 bytes, independent of n_items.
    bloom_bits_per_pos: int = 8
    init_seed: int = 0


@dataclasses.dataclass
class MetricsConfig:
    """Evaluation configuration (reference qmf/metrics/MetricsEngine.h:29-33)."""

    num_test_users: int = 0
    always_compute: bool = False
    seed: int = 42
