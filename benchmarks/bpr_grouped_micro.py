"""Microbenchmark: grouped BPR SGD step variants at ML-20M shapes.

Usage: python -u benchmarks/bpr_grouped_micro.py [variant ...] [B=batch]
Times 100-step lax.scan loops of the grouped minibatch step
(ops/bpr_ops.py _sgd_epoch_scan_grouped_body) with parts disabled, so the
scan's cost decomposes into gathers / compute / scatters:

  base        production grouped step (5 gathers + 5 scatters per step)
  merged      item-side scatters merged into one 4B-row scatter
  noneg       negative-item scatters skipped (2 scatters remain)
  noscatter   all scatters skipped (gathers + compute only)
  nogather    factor gathers replaced by broadcast row 0 (scatters remain)
  compute     neither gathers nor scatters (hash/sigmoid floor)
  inscan      base + the presample pass folded INTO the step: Feistel-cost
              index mix, (u,p) stream-row gather, bitmap-word gather, and
              in-word rejection probes per negative — models removing the
              separate presample+shuffle programs entirely
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")
from qmf_tpu.cli.common import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qmf_tpu.ops import bpr_ops  # noqa: E402

U, I, K = 138_493, 26_744, 30
NUM_NEG, N_ROUNDS = 3, 4
STEPS = 100


def make_step(variant: str, batch: int, u_shift: int, rk, wpu=0):
    def body(carry, inp):
        # carry = (params, up_arr, words) so the big sampling tables ride
        # as traced args, not multi-hundred-MB jaxpr constants
        params, up_arr, words = carry
        ue, p, t = inp
        if variant == "inscan":
            lane0 = jnp.arange(batch, dtype=jnp.int32)
            x = t * batch + lane0
            # Feistel-grade mixing cost (3 rounds of mul/xor/shift)
            for kx in (0x1E3779B1, 0x05EBCA77, 0x42B2AE3D):  # int32-safe
                x = (x * jnp.int32(kx | 1)) & jnp.int32(0x7FFFFFFF)
                x = x ^ (x >> 13) ^ (x >> 7)
            idx = jnp.remainder(x, jnp.int32(up_arr.shape[0]))
            up2 = up_arr[idx]  # (B, 2) stream-row gather
            u = up2[:, 0]
            p = up2[:, 1]
            w = jnp.ones((batch,), params.user_factors.dtype)
            # one bitmap word per positive + in-word probes
            w_idx = u * jnp.int32(wpu) + jnp.remainder(x, jnp.int32(wpu))
            w_row = words[w_idx]
            b0 = x & 31
            rbits = jnp.zeros((batch,), jnp.int32)
            for j in range(NUM_NEG):
                r_j = jnp.zeros((batch,), jnp.int32)
                for r in range(N_ROUNDS - 1):
                    bit = (b0 + 7 * (j * (N_ROUNDS - 1) + r)) & 31
                    free = (jax.lax.shift_right_logical(w_row, bit) & 1) == 0
                    r_j = jnp.where((r_j == 0) & free, r + 1, r_j)
                rbits = rbits | (r_j << (1 + 2 * j))
            ue = (u << jnp.int32(u_shift)) | rbits | 1
        else:
            w = (ue & 1).astype(params.user_factors.dtype)
            u = jax.lax.shift_right_logical(ue, jnp.int32(u_shift))
        wcol = w[:, None]
        if variant in ("nogather", "compute"):
            pu = jnp.broadcast_to(params.user_factors[0], (batch, K))
            qp = jnp.broadcast_to(params.item_factors[0], (batch, K))
        else:
            pu = params.user_factors[u]
            qp = params.item_factors[p]
        lane = jnp.arange(batch, dtype=jnp.int32)
        base_f = (t * batch + lane) * NUM_NEG
        x_p = jnp.einsum("bk,bk->b", pu, qp)
        negs, es = [], []
        for j in range(NUM_NEG):
            r_j = jax.lax.shift_right_logical(ue, jnp.int32(1 + 2 * j)) & 3
            f_j = base_f + j
            neg_j = bpr_ops._cand_hash(rk[0], f_j, I)
            for r in range(1, N_ROUNDS):
                neg_j = jnp.where(
                    r_j == r, bpr_ops._cand_hash(rk[r], f_j, I), neg_j
                )
            if variant in ("nogather", "compute"):
                qn_j = jnp.broadcast_to(
                    params.item_factors[1], (batch, K)
                ) + neg_j[:, None].astype(jnp.float32) * 0.0
            else:
                qn_j = params.item_factors[neg_j]
            d_j = x_p - jnp.einsum("bk,bk->b", pu, qn_j)
            e_j = (1.0 / (1.0 + jnp.exp(d_j))) * w
            negs.append((neg_j, qn_j))
            es.append(e_j)
        lr = jnp.float32(1e-6)
        lam = jnp.float32(1e-4)
        du = -NUM_NEG * lam * pu * wcol
        for e_j, (_, qn_j) in zip(es, negs):
            du = du + e_j[:, None] * (qp - qn_j)
        e_sum = sum(es)
        dp = e_sum[:, None] * pu - NUM_NEG * lam * qp * wcol
        if variant in ("noscatter", "compute"):
            uf = params.user_factors * (1.0 + lr * jnp.mean(du))
            itf = params.item_factors * (1.0 + lr * jnp.mean(dp))
        else:
            uf = params.user_factors.at[u].add(lr * du)
            if variant == "merged":
                all_idx = jnp.concatenate(
                    [p] + [n for n, _ in negs], axis=0
                )
                all_upd = jnp.concatenate(
                    [dp]
                    + [
                        -e_j[:, None] * pu - lam * qn_j * wcol
                        for e_j, (_, qn_j) in zip(es, negs)
                    ],
                    axis=0,
                )
                itf = params.item_factors.at[all_idx].add(lr * all_upd)
            else:
                itf = params.item_factors.at[p].add(lr * dp)
                if variant != "noneg":
                    for e_j, (neg_j, qn_j) in zip(es, negs):
                        itf = itf.at[neg_j].add(
                            lr * (-e_j[:, None] * pu - lam * qn_j * wcol)
                        )
        return (
            bpr_ops.BPRParams(uf, itf, params.item_biases), up_arr, words
        ), None

    return body


def main():
    variants, batch = [], 32768
    for a in sys.argv[1:]:
        if a.startswith("B="):
            batch = int(a[2:])
        else:
            variants.append(a)
    variants = variants or [
        "base", "merged", "noneg", "noscatter", "nogather", "compute",
    ]
    rng = np.random.default_rng(0)
    params = bpr_ops.BPRParams(
        jnp.asarray(rng.normal(0, 0.01, (U, K)).astype(np.float32)),
        jnp.asarray(rng.normal(0, 0.01, (I, K)).astype(np.float32)),
        jnp.zeros((I,), jnp.float32),
    )
    u_shift = 1 + 2 * NUM_NEG
    rk = jnp.asarray(
        rng.integers(0, 1 << 30, (N_ROUNDS, 3)).astype(np.int32)
    )
    ue = jnp.asarray(
        ((rng.integers(0, U, STEPS * batch) << u_shift) | 1).astype(np.int32)
    ).reshape(STEPS, batch)
    pos = jnp.asarray(
        rng.integers(0, I, STEPS * batch).astype(np.int32)
    ).reshape(STEPS, batch)
    ts = jnp.arange(STEPS, dtype=jnp.int32)

    wpu = (I + 31) // 32
    if "inscan" in variants:
        up_arr = jnp.asarray(
            np.stack(
                [rng.integers(0, U, STEPS * batch),
                 rng.integers(0, I, STEPS * batch)], axis=1
            ).astype(np.int32)
        )
        words = jnp.asarray(
            rng.integers(0, 1 << 31, U * wpu, dtype=np.int64).astype(np.int32)
        )
    else:
        up_arr = jnp.zeros((1, 2), jnp.int32)
        words = jnp.zeros((1,), jnp.int32)

    for variant in variants:
        step = make_step(variant, batch, u_shift, rk, wpu)

        @jax.jit
        def run(p0, up2, wd, v=variant, s=step):
            (out, _, _), _ = jax.lax.scan(s, (p0, up2, wd), (ue, pos, ts))
            return out

        out = run(params, up_arr, words)
        float(out.user_factors[0, 0])
        times = []
        for _ in range(3):
            t0 = time.time()
            out = run(params, up_arr, words)
            float(out.user_factors[0, 0])
            times.append(time.time() - t0)
        per_step = np.median(times) / STEPS
        print(
            f"{variant:10s} B={batch}: {per_step * 1e3:.3f} ms/step "
            f"({STEPS} steps, runs {[f'{t:.3f}' for t in times]})",
            flush=True,
        )


if __name__ == "__main__":
    main()
