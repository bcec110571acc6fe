"""A/B the class-granular solve vs the in-scan solve on the fused epoch.

Usage: python -u benchmarks/class_solve_ab.py [preset]
Times als_ops.train_epoch with class_solve True and False on the same
initialized engine (same device arrays), 5 reps each.
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")
sys.path.insert(0, "benchmarks")
from qmf_tpu.cli.common import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import datagen  # noqa: E402
from qmf_tpu.config import WALSConfig  # noqa: E402
from qmf_tpu.data.dataset import Dataset  # noqa: E402
from qmf_tpu.models.wals import WALSEngine  # noqa: E402
from qmf_tpu.ops import als_ops  # noqa: E402


def main():
    preset = sys.argv[1] if len(sys.argv) > 1 else "ml20m"
    users, items, values = datagen.load_npz(preset)
    ds = Dataset(users, items, values)
    cfg = WALSConfig(
        nepochs=1, nfactors=64, init_seed=0, matmul_precision="default"
    )
    eng = WALSEngine(cfg)
    t0 = time.time()
    eng.init(ds)
    print(f"init {time.time()-t0:.1f}s", flush=True)

    ub, ib = eng._user_buckets, eng._item_buckets
    u_arrays = [
        (ub.row_ids[i], ub.col_idx[i], ub.values[i], ub.mask[i])
        for i in range(len(ub))
    ]
    i_arrays = [
        (ib.row_ids[i], ib.col_idx[i], ib.values[i], ib.mask[i])
        for i in range(len(ib))
    ]
    for class_solve in (True, False):
        # copies: train_epoch donates its factor args
        u = jnp.array(eng.user_factors)
        v = jnp.array(eng.item_factors)
        args = dict(
            user_arrays=u_arrays,
            item_arrays=i_arrays,
            alpha=jnp.asarray(cfg.confidence_weight, dtype=eng.dtype),
            lam=jnp.asarray(cfg.regularization_lambda, dtype=eng.dtype),
            solver=cfg.solver,
            precision=cfg.matmul_precision,
            n_users=eng.nusers,
            n_items=eng.nitems,
            user_chunks=tuple(eng._user_chunks),
            item_chunks=tuple(eng._item_chunks),
            class_solve=class_solve,
        )
        t0 = time.time()
        out = als_ops.train_epoch(u, v, **args)
        float(out[3])  # device sync: the loss read waits for the epoch
        print(f"class_solve={class_solve}: compile+run {time.time()-t0:.1f}s",
              flush=True)
        times = []
        for _ in range(5):
            u2, v2 = out[0], out[1]
            t0 = time.time()
            out = als_ops.train_epoch(u2, v2, **args)
            float(out[3])
            times.append(time.time() - t0)
        print(
            f"class_solve={class_solve}: epoch {np.median(times)*1e3:.1f} ms"
            f" (all: {[f'{t*1e3:.0f}' for t in times]})",
            flush=True,
        )


if __name__ == "__main__":
    main()
