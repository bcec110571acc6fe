"""Decision experiment: can sorting + segment-summing
the BPR item-update stream beat plain duplicate-index scatter-add?

At ml20m BPR (B=32768, 3 negatives), each grouped-scan step scatters
4B = 131,072 item-side rows into a 26,744-row table — guaranteed duplicate
indices. The dedup recipe (sort by item idx, segment-sum duplicates, scatter
unique rows) only wins if:

  t(argsort) + t(reorder gather) + t(sorted segment_sum) + t(unique scatter)
      <  t(random 4B-row scatter-add)

All four left-hand stages are measured here against the right-hand baseline,
plus the end-to-end composed variant, at the exact epoch shapes. Also
measures the same set at bf16 storage.

Usage: python -u benchmarks/bpr_dedup_micro.py
"""

import sys
import time

sys.path.insert(0, ".")
from qmf_tpu.cli.common import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

B = 32768
NUM_NEG = 3
ROWS = B * (1 + NUM_NEG)  # one positive + num_neg negative updates
N_ITEMS = 26744
K = 32  # padded k=30


def _time(fn, *args, reps=7):
    out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.time()
        jax.block_until_ready(fn(*args))
        times.append(time.time() - t0)
    return float(np.median(times)) * 1e3  # ms


def bench(dtype):
    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, N_ITEMS, ROWS).astype(np.int32))
    upd = jnp.asarray(rng.normal(0, 1e-3, (ROWS, K)).astype(np.float32)).astype(dtype)
    table = jnp.asarray(
        rng.normal(0, 0.1, (N_ITEMS, K)).astype(np.float32)
    ).astype(dtype)

    name = jnp.dtype(dtype).name
    # baseline: plain duplicate-index scatter-add (what the epoch does; the
    # grouped path actually issues it as 1 + num_neg sequential B-row
    # scatters -- measure both shapes)
    t = _time(jax.jit(lambda t_, i_, u_: t_.at[i_].add(u_)), table, idx, upd)
    print(f"[{name}] scatter_add 4B rows (one wide): {t:.3f} ms")
    idx4 = idx.reshape(4, B)
    upd4 = upd.reshape(4, B, K)

    def seq4(t_, i_, u_):
        for j in range(4):
            t_ = t_.at[i_[j]].add(u_[j])
        return t_

    t_seq = _time(jax.jit(seq4), table, idx4, upd4)
    print(f"[{name}] scatter_add 4x B rows (sequential): {t_seq:.3f} ms")

    # stage 1: argsort of the index stream
    t = _time(jax.jit(lambda i_: jnp.argsort(i_)), idx)
    print(f"[{name}] argsort {ROWS}: {t:.3f} ms")

    # stage 2: reorder gather of the update rows
    order = jnp.argsort(idx)
    t = _time(jax.jit(lambda u_, o_: jnp.take(u_, o_, axis=0)), upd, order)
    print(f"[{name}] reorder gather ({ROWS}, {K}): {t:.3f} ms")

    # stage 3: sorted segment-sum into n_items segments
    sidx = jnp.take(idx, order)

    def seg(u_, si_):
        return jax.ops.segment_sum(
            u_, si_, num_segments=N_ITEMS, indices_are_sorted=True
        )

    t = _time(jax.jit(seg), jnp.take(upd, order, axis=0), sidx)
    print(f"[{name}] sorted segment_sum -> {N_ITEMS}: {t:.3f} ms")

    # unsorted segment_sum for contrast (is sortedness even exploited?)
    def seg_u(u_, si_):
        return jax.ops.segment_sum(u_, si_, num_segments=N_ITEMS)

    t = _time(jax.jit(seg_u), upd, idx)
    print(f"[{name}] unsorted segment_sum -> {N_ITEMS}: {t:.3f} ms")

    # composed dedup pipeline (sort + reorder + segment-sum + dense add)
    def dedup(t_, i_, u_):
        o = jnp.argsort(i_)
        si = jnp.take(i_, o)
        su = jnp.take(u_, o, axis=0)
        acc = jax.ops.segment_sum(
            su, si, num_segments=N_ITEMS, indices_are_sorted=True
        )
        return t_ + acc

    t_dedup = _time(jax.jit(dedup), table, idx, upd)
    print(f"[{name}] composed dedup pipeline: {t_dedup:.3f} ms")

    # dense one-shot: skip the sort entirely -- segment_sum on the raw
    # stream then one dense add (segment_sum itself is a scatter, but into
    # a zeroed accumulator XLA may specialize)
    def dense(t_, i_, u_):
        return t_ + jax.ops.segment_sum(u_, i_, num_segments=N_ITEMS)

    t_dense = _time(jax.jit(dense), table, idx, upd)
    print(f"[{name}] segment_sum + dense add: {t_dense:.3f} ms")
    print(
        f"[{name}] verdict: baseline(seq) {t_seq:.3f} ms vs dedup "
        f"{t_dedup:.3f} ms vs dense {t_dense:.3f} ms"
    )


def main():
    for dtype in (jnp.float32, jnp.bfloat16):
        bench(dtype)


if __name__ == "__main__":
    main()
