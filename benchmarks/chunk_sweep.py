"""Sweep the WALS scan chunk size (batch_rows) at ml20m k=64 on the GPU.

Usage: python -u benchmarks/chunk_sweep.py [batch_rows ...]
Default sweep: 8192 (production default), 65536, 100000000 (one-shot: every
width class solved in a single scan step).

Rationale: the solve stage is latency-bound — the unrolled blocked Cholesky
is a ~3k-op serial chain per scan step, and the user side runs ~444 steps at
batch_rows=8192. Fewer, wider steps amortize the serial chain over big
vectors (the decomposition evidence is in benchmarks/wals_micro.py output).
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
from qmf_tpu.config import WALSConfig  # noqa: E402
from qmf_tpu.data.dataset import Dataset  # noqa: E402
from qmf_tpu.models.wals import WALSEngine  # noqa: E402

def main():
    sweep = [int(s) for s in sys.argv[1:]] or [8192, 65536, 100000000]
    users, items, values = datagen.load_npz("ml20m")
    ds = Dataset(users, items, values)
    for batch_rows in sweep:
        eng = WALSEngine(
            WALSConfig(
                nepochs=1,
                nfactors=64,
                init_seed=0,
                batch_rows=batch_rows,
                matmul_precision="default",
            )
        )
        t0 = time.time()
        eng.init(ds)
        print(f"batch_rows={batch_rows}: init {time.time()-t0:.1f}s",
              flush=True)
        t0 = time.time()
        eng._fused_epoch()
        print(f"batch_rows={batch_rows}: warmup (incl compile) "
              f"{time.time()-t0:.1f}s", flush=True)
        times = []
        for _ in range(3):
            t0 = time.time()
            loss = eng._fused_epoch()
            times.append(time.time() - t0)
        print(
            f"batch_rows={batch_rows}: epoch {np.median(times)*1e3:.1f} ms "
            f"(loss {loss:.6f})",
            flush=True,
        )
        del eng


if __name__ == "__main__":
    main()
