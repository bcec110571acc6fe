"""``bpr`` CLI — Bayesian Personalized Ranking training.

Flag-compatible with the reference binary (reference qmf/bpr.cpp:28-59): same
names, defaults, and gflags syntax. ``--num_hogwild_threads`` and
``--nthreads`` are accepted for compatibility; the Hogwild concurrency role
is played by the synchronous minibatch (see ``--batch_size``).
"""

from __future__ import annotations

import sys

from qmf_tpu.cli.common import configure_platform, enable_compilation_cache
from qmf_tpu.config import BPRConfig, MetricsConfig
from qmf_tpu.data import read_dataset
from qmf_tpu.metrics import MetricsEngine
from qmf_tpu.models import BPREngine
from qmf_tpu.utils import split
from qmf_tpu.utils.flags import Flags
from qmf_tpu.utils.logging import log


def make_flags() -> Flags:
    fl = Flags("bpr")
    # model arguments (reference qmf/bpr.cpp:28-40)
    fl.define_integer("nepochs", 10, "number of epochs for SGD")
    fl.define_integer("nfactors", 30, "dimension of learned factors")
    fl.define_float("init_learning_rate", 0.05, "initial learning rate")
    fl.define_float("bias_lambda", 1.0, "regularization on biases")
    fl.define_float("user_lambda", 0.025, "regularization on user factors")
    fl.define_float("item_lambda", 0.0025, "regularization on item factors")
    fl.define_float("decay_rate", 0.9, "decay rate on learning rate")
    fl.define_bool("use_biases", False, "use bias term")
    fl.define_float("init_distribution_bound", 0.01, "init distirbution bound")
    fl.define_integer(
        "num_negative_samples",
        3,
        "number of negative items to sample for each positive item",
    )
    fl.define_integer(
        "num_hogwild_threads",
        1,
        "reference compatibility; Hogwild concurrency is replaced by the "
        "synchronous device minibatch (--batch_size)",
    )
    fl.define_bool(
        "shuffle_training_set", True, "shuffle training set after each epoch"
    )
    # settings (reference qmf/bpr.cpp:43-45)
    fl.define_integer(
        "eval_num_neg",
        3,
        "number of negatives generated per positive in evaluation",
    )
    fl.define_integer(
        "eval_seed",
        42,
        "random seed for generating evaluation set and test users",
    )
    fl.define_integer(
        "nthreads", 16, "reference compatibility; unused on the device"
    )
    # datasets (reference qmf/bpr.cpp:48-49)
    fl.define_string("train_dataset", "", "filename of training dataset")
    fl.define_string("test_dataset", "", "filename of test dataset")
    # metrics (reference qmf/bpr.cpp:52-56)
    fl.define_string(
        "test_avg_metrics",
        "",
        "comma-separated list of test metrics (averaged per-user)",
    )
    fl.define_integer(
        "num_test_users",
        0,
        "# users to use for computing test avg metrics (0 = all users)",
    )
    fl.define_bool(
        "test_always",
        False,
        "whether to compute test avg metrics after each epoch (if false, "
        "only computes at the end)",
    )
    # model output (reference qmf/bpr.cpp:58-59)
    fl.define_string("user_factors", "", "filename of user factors")
    fl.define_string("item_factors", "", "filename of item factors")
    # device extras
    fl.define_string("dtype", "float32", "device compute dtype")
    fl.define_integer("batch_size", 8192, "triplets per device SGD step")
    fl.define_integer(
        "neg_resample_rounds", 4, "device negative-sampling rejection rounds"
    )
    fl.define_integer("init_seed", 0, "seed for factor init and shuffling")
    fl.define_string(
        "neg_sampler",
        "word",
        "grouped-epoch negative sampler: word (single-gather in-word "
        "probes) | rounds (compacted exact-rejection rounds)",
    )
    fl.define_integer(
        "n_devices",
        1,
        "devices to data-parallel-shard the minibatch over: 1 = single-chip "
        "engine, 0 = ALL visible devices, N>1 = first N",
    )
    fl.define_string(
        "item_scatter",
        "seq",
        "grouped-scan item-update strategy: seq (sequential scatter-adds) "
        "| merged (one wide scatter) | dense (segment-sum accumulator); "
        "semantically identical, see benchmarks/README.md",
    )
    return fl


def main(argv=None) -> int:
    fl = make_flags()
    fl.parse(argv)
    configure_platform()
    if fl.dtype == "float64":
        # f64 golden mode needs x64 or jnp silently downgrades every array
        # to f32 (the device paths are f32). Mirrors the
        # distributed worker (worker.py run_worker).
        import jax

        jax.config.update("jax_enable_x64", True)
    enable_compilation_cache()

    if not fl.user_factors or not fl.item_factors:
        log.warning(
            "warning: missing model output filenames! "
            "(use options --{user,item}_factors)"
        )

    config = BPRConfig(
        nepochs=fl.nepochs,
        nfactors=fl.nfactors,
        init_learning_rate=fl.init_learning_rate,
        bias_lambda=fl.bias_lambda,
        user_lambda=fl.user_lambda,
        item_lambda=fl.item_lambda,
        decay_rate=fl.decay_rate,
        use_biases=fl.use_biases,
        init_distribution_bound=fl.init_distribution_bound,
        num_negative_samples=fl.num_negative_samples,
        num_hogwild_threads=fl.num_hogwild_threads,
        shuffle_training_set=fl.shuffle_training_set,
        dtype=fl.dtype,
        batch_size=fl.batch_size,
        neg_resample_rounds=fl.neg_resample_rounds,
        neg_sampler=fl.neg_sampler,
        init_seed=fl.init_seed,
        item_scatter=fl.item_scatter,
    )
    metrics_config = MetricsConfig(
        num_test_users=fl.num_test_users,
        always_compute=fl.test_always,
        seed=fl.eval_seed,
    )
    metrics_engine = MetricsEngine(metrics_config)
    for metric in split(fl.test_avg_metrics, ","):
        if not metrics_engine.add_test_avg_metric(metric):
            log.error("metric %s is not available", metric)
            return 1

    if fl.n_devices == 1:
        engine = BPREngine(
            config,
            metrics_engine,
            eval_num_neg=fl.eval_num_neg,
            eval_seed=fl.eval_seed,
        )
    else:
        from qmf_tpu.parallel import ShardedBPREngine

        n = fl.n_devices if fl.n_devices > 0 else None  # 0 = all devices
        engine = ShardedBPREngine(
            config,
            metrics_engine,
            eval_num_neg=fl.eval_num_neg,
            eval_seed=fl.eval_seed,
            n_devices=n,
        )
        log.info("data-parallel BPR over %d devices", engine.mesh.size)

    log.info("loading training data")
    engine.init(read_dataset(fl.train_dataset))

    if fl.test_dataset:
        log.info("loading test data")
        engine.init_test(read_dataset(fl.test_dataset))

    log.info("training")
    engine.optimize()

    if fl.user_factors and fl.item_factors:
        log.info("saving model output")
        engine.save_user_factors(fl.user_factors)
        engine.save_item_factors(fl.item_factors)
    return 0


if __name__ == "__main__":
    sys.exit(main())
