"""In-scan A/B for the BPR item-scatter dedup (part 2 of bpr_dedup_micro).

bpr_dedup_micro.py measured ISOLATED ops: a 4B-row duplicate-index
scatter-add can run near device-memory bandwidth alone, far below the
per-row cost the epoch scan attributes to its scatters. The
difference is context: the epoch is a lax.scan whose carry is the donated
param pytree — every scatter is an in-place RMW on the live factor tables,
serialized against the next step's gathers by the loop-carried dependency.

This micro rebuilds that context minimally: a 200-step scan over the real
table shapes (items 26744x32, users 138493x32) doing the epoch's memory
ops (5 gathers + 5 scatters per step, indices derived per-step by hashing
so nothing constant-folds), then A/Bs three item-side strategies:

  seq    — 1 + num_neg sequential B-row scatters (current epoch shape)
  dedup  — argsort + reorder + sorted segment_sum + one dense add
  dense  — unsorted segment_sum + one dense add (no sort)

Usage: python -u benchmarks/bpr_dedup_scan_micro.py
"""

import functools
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
N_ITEMS = 26744
N_USERS = 138493
K = 32
STEPS = 200


def _hash(x, salt):
    x = (x ^ salt) * jnp.uint32(0x9E3779B1)
    x = (x ^ (x >> 15)) * jnp.uint32(0x85EBCA77)
    return x ^ (x >> 13)


def _idx(step, lane, salt, n):
    h = _hash(lane.astype(jnp.uint32) + step.astype(jnp.uint32) * 0x01000193,
              jnp.uint32(salt))
    return (h % jnp.uint32(n)).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("mode",), donate_argnums=(0, 1))
def run(itf, uf, mode):
    lane = jnp.arange(B, dtype=jnp.int32)

    def body(carry, step):
        itf, uf = carry
        u = _idx(step, lane, 1, N_USERS)
        p = _idx(step, lane, 2, N_ITEMS)
        negs = [_idx(step, lane, 3 + j, N_ITEMS) for j in range(NUM_NEG)]
        pu = uf[u]
        qp = itf[p]
        qns = [itf[nj] for nj in negs]
        e = jnp.einsum("bk,bk->b", pu, qp) * 1e-6
        du = qp - qns[0]
        for qn in qns[1:]:
            du = du + (qp - qn)
        uf = uf.at[u].add(e[:, None] * du)
        dp = e[:, None] * pu
        dns = [-e[:, None] * pu - 1e-4 * qn for qn in qns]
        if mode == "seq":
            itf = itf.at[p].add(dp)
            for nj, dn in zip(negs, dns):
                itf = itf.at[nj].add(dn)
        else:
            all_idx = jnp.concatenate([p] + negs)
            all_upd = jnp.concatenate([dp] + dns, axis=0)
            if mode == "dedup":
                o = jnp.argsort(all_idx)
                si = jnp.take(all_idx, o)
                su = jnp.take(all_upd, o, axis=0)
                acc = jax.ops.segment_sum(
                    su, si, num_segments=N_ITEMS, indices_are_sorted=True
                )
            else:  # dense
                acc = jax.ops.segment_sum(
                    all_upd, all_idx, num_segments=N_ITEMS
                )
            itf = itf + acc
        return (itf, uf), None

    (itf, uf), _ = jax.lax.scan(
        body, (itf, uf), jnp.arange(STEPS, dtype=jnp.int32)
    )
    return itf, uf


def main():
    rng = np.random.default_rng(0)
    for mode in ("seq", "dedup", "dense"):
        times = []
        for rep in range(4):
            itf = jnp.asarray(
                rng.normal(0, 0.1, (N_ITEMS, K)).astype(np.float32)
            )
            uf = jnp.asarray(
                rng.normal(0, 0.1, (N_USERS, K)).astype(np.float32)
            )
            t0 = time.time()
            out = run(itf, uf, mode)
            jax.block_until_ready(out)
            times.append(time.time() - t0)
        t = float(np.median(times[1:]))  # skip compile rep
        print(
            f"{mode}: {t*1e3:.1f} ms / {STEPS} steps = "
            f"{t/STEPS*1e3:.3f} ms/step "
            f"-> est. epoch ({18000376 // B + 1} steps) "
            f"{t/STEPS*(18000376 // B + 1):.3f} s"
        )


if __name__ == "__main__":
    main()
