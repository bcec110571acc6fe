"""Whole ml20m WALS epoch (k=64) with the solve resolved to each path.

Usage: python -u benchmarks/solver_sweep.py [solver@precision ...]
Default: cholesky_xla, cholesky and lu at precision "default" (the bench
setting), then cholesky_xla and cholesky at "highest".

One engine per precision, built with the production defaults (device
packing, hot/cold split auto); each solver then runs the engine's own
fused epoch program. An epoch ends in a host read of its loss, so each
time covers the whole device program. Prints compile+first-epoch time and
the median of REPS steady epochs, with the card's name and power limit.
"""

import subprocess
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

REPS = 5
DEFAULT_SPECS = [
    "cholesky_xla@default", "cholesky@default", "lu@default",
    "cholesky_xla@highest", "cholesky@highest",
]


def main():
    specs = sys.argv[1:] or DEFAULT_SPECS
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"# device {jax.devices()[0].device_kind}; nvidia-smi: {card}",
          flush=True)
    users, items, values = datagen.load_npz("ml20m")
    ds = Dataset(users, items, values)
    by_precision = {}
    for spec in specs:
        solver, _, precision = spec.partition("@")
        by_precision.setdefault(precision or "default", []).append(solver)
    for precision, solver_list in by_precision.items():
        eng = WALSEngine(WALSConfig(
            nepochs=1, nfactors=64, init_seed=0, batch_rows=8192,
            matmul_precision=precision,
        ))
        t0 = time.time()
        eng.init(ds)
        print(f"precision={precision}: init {time.time() - t0:.1f}s "
              f"(auto solver -> {eng._solver})", flush=True)
        for solver in solver_list:
            eng._solver = solver
            t0 = time.time()
            eng._fused_epoch()
            print(f"  {solver}@{precision}: compile+first epoch "
                  f"{time.time() - t0:.1f}s", flush=True)
            times, loss = [], None
            for _ in range(REPS):
                t0 = time.perf_counter()
                loss = eng._fused_epoch()
                times.append(time.perf_counter() - t0)
            print(
                f"  {solver}@{precision}: epoch median "
                f"{np.median(times) * 1e3:.2f} ms min {min(times) * 1e3:.2f}"
                f" ms (all {[round(t * 1e3, 2) for t in times]}) "
                f"loss {loss:.6f}",
                flush=True,
            )
        del eng


if __name__ == "__main__":
    main()
