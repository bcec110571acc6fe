"""BPR throughput benchmark: ml20m k=30, 3 negatives (BASELINE.json config).

Usage: python -u benchmarks/bpr_bench.py [batch_size ...]
Reports REAL (unpadded) triplet updates/sec per epoch against the reference
Hogwild target (measured single-core updates/s x perfect 16-thread scaling,
read from benchmarks/baseline_measured.json — ~25.2M upd/s at ml20m; see
benchmarks/README.md baseline methodology). Padded no-op rows in the device
stream are excluded from the numerator.
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "benchmarks")
from qmf_tpu.cli.common import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402

import datagen  # noqa: E402
from qmf_tpu.config import BPRConfig  # noqa: E402
from qmf_tpu.data.dataset import Dataset  # noqa: E402
from qmf_tpu.models.bpr import BPREngine  # noqa: E402

def _ref_updates_per_s() -> float:
    """16-thread-extrapolated reference Hogwild bar: the interleaved-median
    measurement cached by bench.py when available, else the round-3 value
    (see benchmarks/README.md baseline methodology note)."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "baseline_measured.json")
    try:
        with open(path) as f:
            cache = json.load(f)
        return float(
            cache["ml20m_bpr_k30"]["ref_updates_per_s_16core_extrapolated"]
        )
    except (OSError, KeyError, ValueError):
        return 25.2e6


REF_UPDATES_PER_S = _ref_updates_per_s()


def _sync(eng):
    # block_until_ready waits for donated-input programs on the GPU
    # (benchmarks/solver_micro.py checks it)
    jax.block_until_ready(eng.params)


def main():
    # args: batch sizes, optionally "BSxROUNDS" (default rounds=4, the
    # exact-rejection setting; rounds=1 is the one-shot sampling variant)
    specs = []
    for s in sys.argv[1:]:
        bs, _, r = s.partition("x")
        specs.append((int(bs), int(r) if r else 4))
    specs = specs or [(32768, 4)]
    import os

    preset = os.environ.get("QMF_BPR_PRESET", "ml20m")
    datagen.ensure_dataset(preset)
    users, items, values = datagen.load_npz(preset)
    ds = Dataset(users, items, values)
    sampler = os.environ.get("QMF_BPR_SAMPLER", "word")
    merge = os.environ.get("QMF_BPR_MERGE", "") == "1"
    for bs, rounds in specs:
        cfg = BPRConfig(
            nepochs=1,
            nfactors=30,
            num_negative_samples=3,
            batch_size=bs,
            neg_resample_rounds=rounds,
            neg_sampler=sampler,
            item_scatter=("merged" if merge else "seq"),
            init_seed=0,
        )
        eng = BPREngine(cfg)
        t0 = time.time()
        eng.init(ds)
        path = "grouped" if eng._grouped else "stream"
        print(
            f"bs={bs} r={rounds}: init {time.time()-t0:.1f}s ({path} path)",
            flush=True,
        )
        n_updates = int(eng._n_real_triplets)

        t0 = time.time()
        eng._epoch()
        _sync(eng)
        print(
            f"bs={bs} r={rounds}: warmup epoch (incl compile) "
            f"{time.time()-t0:.1f}s",
            flush=True,
        )
        times = []
        for _ in range(3):
            t0 = time.time()
            eng._epoch()
            _sync(eng)
            times.append(time.time() - t0)
        ep = float(np.median(times))
        ups = n_updates / ep
        print(
            f"bs={bs} r={rounds}: epoch {ep:.2f}s, {ups/1e6:.2f}M updates/s "
            f"(vs ref 16-thread {REF_UPDATES_PER_S/1e6:.1f}M -> "
            f"{ups/REF_UPDATES_PER_S:.2f}x)",
            flush=True,
        )


if __name__ == "__main__":
    main()
