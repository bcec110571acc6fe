"""Batched small-matrix linear algebra as unrolled XLA programs.

XLA's stock ``cholesky``/``triangular_solve`` may lower to loops with one
dynamic-sliced column step per iteration. These replacements unroll the
same textbook blocked algorithms statically: the per-block scalar
recurrences become straight-line vector ops over the batch dimension, and
the trailing updates become batched matmuls. ``solve_spd`` is the WALS
solve on the CPU and for float64 runs; on the GPU XLA's cuSOLVER path
(``als_ops._solve_spd_xla``) measured slightly faster (PERF.md).

Works for any k: matrices are padded to a block multiple with an identity
diagonal (padding rows solve to zero and are sliced off).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Cholesky block size. Swept on an NVIDIA H100 80GB HBM3 (700 W) at the
# ml20m user side's stacked normal equations (138,496 x 64 x 64,
# benchmarks/solver_micro.py): 8 -> 26.02 ms, 16 -> 17.97 ms, 32 -> 18.20 ms.
# 16 balances the unrolled diagonal-block chain (O(nb^2) ops) against the
# number of panel/Schur stages (k/nb).
_BLOCK = 16
_PREC = jax.lax.Precision.HIGHEST


def _pad_mat(a: jax.Array, block: int) -> jax.Array:
    """Pad a (B,k,k) matrix to a block multiple as diag(A, I)."""
    k = a.shape[-1]
    pad = (-k) % block
    if pad == 0:
        return a
    bsz = a.shape[0]
    a_p = jnp.zeros((bsz, k + pad, k + pad), dtype=a.dtype)
    a_p = a_p.at[:, :k, :k].set(a)
    eye_idx = jnp.arange(k, k + pad)
    a_p = a_p.at[:, eye_idx, eye_idx].set(1.0)
    return a_p


def _pad_vec(b: jax.Array, block: int) -> jax.Array:
    """Pad a (B,k) vector to a block multiple with zeros."""
    pad = (-b.shape[-1]) % block
    if pad == 0:
        return b
    return jnp.pad(b, ((0, 0), (0, pad)))


def _pad_spd(a: jax.Array, b: jax.Array, block: int):
    """Pad (B,k,k)/(B,k) to a block multiple: diag(A, I) and [b, 0]."""
    return _pad_mat(a, block), _pad_vec(b, block), a.shape[-1]


def _chol_diag_block(ajj):
    """Unrolled dense Cholesky of a (B, nb, nb) diagonal block."""
    nb = ajj.shape[-1]
    l = [[None] * nb for _ in range(nb)]
    for p in range(nb):
        s = ajj[:, p, p]
        for q in range(p):
            s = s - l[p][q] * l[p][q]
        dpp = jnp.sqrt(s)
        l[p][p] = dpp
        inv = 1.0 / dpp
        for r in range(p + 1, nb):
            s2 = ajj[:, r, p]
            for q in range(p):
                s2 = s2 - l[r][q] * l[p][q]
            l[r][p] = s2 * inv
    zero = jnp.zeros_like(l[0][0])
    return jnp.stack(
        [
            jnp.stack([l[r][c] if c <= r else zero for c in range(nb)], axis=1)
            for r in range(nb)
        ],
        axis=1,
    )


def _panel_solve(pan, ljj):
    """X such that X @ ljj^T = pan; pan (B, m, nb), ljj lower (B, nb, nb)."""
    nb = ljj.shape[-1]
    xs = []
    for c in range(nb):
        v = pan[:, :, c]
        for q in range(c):
            v = v - xs[q] * ljj[:, c : c + 1, q]
        xs.append(v / ljj[:, c : c + 1, c])
    return jnp.stack(xs, axis=2)


def cholesky_blocked(a: jax.Array, block: int = _BLOCK) -> jax.Array:
    """Batched lower Cholesky, statically-unrolled right-looking blocks.

    a: (B, k, k) SPD, any k (internally padded to a block multiple with an
    identity diagonal; the padded corner factors to I and is sliced off).
    """
    k_in = a.shape[-1]
    a = _pad_mat(a, block)
    k = a.shape[-1]
    cols = []
    for j in range(0, k, block):
        ajj = a[:, j : j + block, j : j + block]
        ljj = _chol_diag_block(ajj)
        if j + block < k:
            pan = a[:, j + block :, j : j + block]
            x = _panel_solve(pan, ljj)
            # trailing Schur update on the tensor cores
            a22 = a[:, j + block :, j + block :] - jnp.einsum(
                "bik,bjk->bij", x, x, precision=_PREC
            )
            a = a.at[:, j + block :, j + block :].set(a22)
            col = jnp.concatenate(
                [jnp.zeros((a.shape[0], j, block), a.dtype), ljj, x], axis=1
            )
        else:
            col = jnp.concatenate(
                [jnp.zeros((a.shape[0], j, block), a.dtype), ljj], axis=1
            )
        cols.append(col)
    return jnp.concatenate(cols, axis=2)[:, :k_in, :k_in]


def solve_lower_blocked(l: jax.Array, b: jax.Array, block: int = _BLOCK):
    """z with L z = b; L (B,k,k) lower, b (B,k), any k.

    Static block substitution; non-block-multiple k is padded internally
    (L extended with an identity diagonal, b with zeros).
    """
    k_in = l.shape[-1]
    l = _pad_mat(l, block)
    b = _pad_vec(b, block)
    k = l.shape[-1]
    zs = []
    for j in range(0, k, block):
        rhs = b[:, j : j + block]
        for q, z_q in enumerate(zs):
            lij = l[:, j : j + block, q * block : (q + 1) * block]
            rhs = rhs - jnp.einsum("bij,bj->bi", lij, z_q, precision=_PREC)
        ljj = l[:, j : j + block, j : j + block]
        # unrolled forward substitution within the block
        z_b = []
        for p in range(block):
            v = rhs[:, p]
            for q in range(p):
                v = v - ljj[:, p, q] * z_b[q]
            z_b.append(v / ljj[:, p, p])
        zs.append(jnp.stack(z_b, axis=1))
    return jnp.concatenate(zs, axis=1)[:, :k_in]


def solve_lower_t_blocked(l: jax.Array, z: jax.Array, block: int = _BLOCK):
    """x with L^T x = z (backward substitution, static blocks); any k.

    Non-block-multiple k is padded internally like ``solve_lower_blocked``.
    """
    k_in = l.shape[-1]
    l = _pad_mat(l, block)
    z = _pad_vec(z, block)
    k = l.shape[-1]
    nblocks = k // block
    xs = [None] * nblocks
    for jb in range(nblocks - 1, -1, -1):
        j = jb * block
        rhs = z[:, j : j + block]
        for qb in range(jb + 1, nblocks):
            q = qb * block
            # (L^T)[j:, q:] = L[q:, j:]^T
            lqj = l[:, q : q + block, j : j + block]
            rhs = rhs - jnp.einsum("bji,bj->bi", lqj, xs[qb], precision=_PREC)
        ljj = l[:, j : j + block, j : j + block]
        x_b = [None] * block
        for p in range(block - 1, -1, -1):
            v = rhs[:, p]
            for q in range(p + 1, block):
                v = v - ljj[:, q, p] * x_b[q]
            x_b[p] = v / ljj[:, p, p]
        xs[jb] = jnp.stack(x_b, axis=1)
    return jnp.concatenate(xs, axis=1)[:, :k_in]


def solve_spd(a: jax.Array, b: jax.Array, block: int = _BLOCK) -> jax.Array:
    """Batched SPD solve A x = b via the blocked Cholesky above.

    Accepts any k (internally padded to a block multiple with an identity
    diagonal; padded coordinates solve to zero and are sliced off).
    """
    a_p, b_p, k = _pad_spd(a, b, block)
    l = cholesky_blocked(a_p, block)
    z = solve_lower_blocked(l, b_p, block)
    x = solve_lower_t_blocked(l, z, block)
    return x[:, :k]


def _inv_lower_block(l: jax.Array) -> jax.Array:
    """Unrolled triangular inverse M = L^{-1} of a (B, nb, nb) lower block
    (forward substitution on the identity). ~O(nb^2) elementwise chain."""
    nb = l.shape[-1]
    m = [[None] * nb for _ in range(nb)]
    for r in range(nb):
        inv_d = 1.0 / l[:, r, r]
        for c in range(r):
            s = l[:, r, c] * m[c][c]
            for q in range(c + 1, r):
                s = s + l[:, r, q] * m[q][c]
            m[r][c] = -s * inv_d
        m[r][r] = inv_d
    zero = jnp.zeros_like(l[:, 0, 0])
    return jnp.stack(
        [
            jnp.stack([m[r][c] if c <= r else zero for c in range(nb)], axis=1)
            for r in range(nb)
        ],
        axis=1,
    )


def _inv_spd_base(a: jax.Array) -> jax.Array:
    """Explicit inverse of a (B, nb, nb) SPD block, nb <= _BLOCK.

    Unrolled Cholesky A = L L^T, unrolled triangular inverse M = L^{-1},
    then A^{-1} = M^T M (one batched matmul).
    """
    m_mat = _inv_lower_block(_chol_diag_block(a))
    return jnp.einsum("bri,brj->bij", m_mat, m_mat, precision=_PREC)


def solve_spd_matmul(a: jax.Array, b: jax.Array, block: int = _BLOCK):
    """Batched SPD solve with matmul panels and block-matvec substitutions.

    Same blocked right-looking Cholesky as ``solve_spd``, but every
    per-column inner loop is replaced by ONE batched contraction against an
    explicitly inverted diagonal block:

      - panel solve  X L_jj^T = P   ->  X = P @ L_jj^{-T}      (one einsum)
      - forward substitution          ->  z_j = L_jj^{-1} rhs  (one matvec)
      - backward substitution         ->  x_j = L_jj^{-T} rhs  (one matvec)

    The serial chain shrinks from ~3k elementwise HLO ops to ~700 (the
    unrolled nb x nb diagonal factor/inverse chains plus one op per block
    pair), which matters because the chain is op-latency-bound, not
    FLOP-bound. Inverting the (well-conditioned) nb x nb diagonal blocks is
    the standard blocked-LAPACK TRTRI trick; accuracy matches the
    division-based substitutions to ~1 ulp on SPD systems.
    """
    a_p, b_p, k = _pad_spd(a, b, block)
    n = a_p.shape[-1]
    nb = block
    nblocks = n // nb
    minvs = [None] * nblocks  # (B, nb, nb) = L_jj^{-1}
    cols = [None] * nblocks  # (B, n - j, nb): [L_jj; X] column block
    for jb in range(nblocks):
        j = jb * nb
        ljj = _chol_diag_block(a_p[:, j : j + nb, j : j + nb])
        mjj = _inv_lower_block(ljj)
        minvs[jb] = mjj
        if j + nb < n:
            pan = a_p[:, j + nb :, j : j + nb]
            x = jnp.einsum("bmk,bjk->bmj", pan, mjj, precision=_PREC)
            a22 = a_p[:, j + nb :, j + nb :] - jnp.einsum(
                "bik,bjk->bij", x, x, precision=_PREC
            )
            a_p = a_p.at[:, j + nb :, j + nb :].set(a22)
            cols[jb] = jnp.concatenate([ljj, x], axis=1)
        else:
            cols[jb] = ljj
    # forward: L z = b
    zs = []
    for jb in range(nblocks):
        j = jb * nb
        rhs = b_p[:, j : j + nb]
        for q in range(jb):
            # rows j..j+nb of column block q (block offset jb - q)
            lblk = cols[q][:, (jb - q) * nb : (jb - q + 1) * nb, :]
            rhs = rhs - jnp.einsum(
                "bij,bj->bi", lblk, zs[q], precision=_PREC
            )
        zs.append(
            jnp.einsum("bij,bj->bi", minvs[jb], rhs, precision=_PREC)
        )
    # backward: L^T x = z
    xs = [None] * nblocks
    for jb in range(nblocks - 1, -1, -1):
        rhs = zs[jb]
        for q in range(jb + 1, nblocks):
            # L[q-block rows, jb-block cols]^T x_q
            lblk = cols[jb][:, (q - jb) * nb : (q - jb + 1) * nb, :]
            rhs = rhs - jnp.einsum(
                "bji,bj->bi", lblk, xs[q], precision=_PREC
            )
        xs[jb] = jnp.einsum(
            "bji,bj->bi", minvs[jb], rhs, precision=_PREC
        )
    return jnp.concatenate(xs, axis=1)[:, :k]


def inv_spd(a: jax.Array, block: int = _BLOCK) -> jax.Array:
    """Batched SPD inverse by recursive 2x2 Schur-complement blocking.

    All combining steps are batched matmuls (matmul work); the only
    elementwise chains are the (B, block, block) base-case inversions.
    Total chain depth is ~10x shorter than the blocked-Cholesky
    factor+solve, which matters because batched small-matrix chains
    are op-latency-bound, not FLOP-bound (each unrolled step is a separate
    HLO op over the whole batch).

        A = [[A11, A12], [A12^T, A22]],  S = A22 - A12^T A11^{-1} A12
        A^{-1} = [[I11 + T S^{-1} T^T, -T S^{-1}],
                  [-S^{-1} T^T,         S^{-1}  ]],  T = A11^{-1} A12

    Requires k to be a power-of-two multiple of ``block`` (callers pad with
    an identity diagonal via ``solve_spd_schur``).
    """
    k = a.shape[-1]
    if k <= block:
        return _inv_spd_base(a)
    h = k // 2
    a11 = a[:, :h, :h]
    a12 = a[:, :h, h:]
    a22 = a[:, h:, h:]
    i11 = inv_spd(a11, block)
    t = jnp.einsum("bij,bjk->bik", i11, a12, precision=_PREC)
    s = a22 - jnp.einsum("bji,bjk->bik", a12, t, precision=_PREC)
    i22 = inv_spd(s, block)
    b12 = -jnp.einsum("bij,bjk->bik", t, i22, precision=_PREC)
    b11 = i11 - jnp.einsum("bij,bkj->bik", b12, t, precision=_PREC)
    top = jnp.concatenate([b11, b12], axis=2)
    bot = jnp.concatenate([jnp.swapaxes(b12, 1, 2), i22], axis=2)
    return jnp.concatenate([top, bot], axis=1)


def solve_spd_schur(
    a: jax.Array, b: jax.Array, block: int = _BLOCK, refine_steps: int = 1
):
    """Batched SPD solve via the recursive explicit inverse: x = A^{-1} b.

    The raw explicit inverse loses ~cond(A)^1.5 * eps accuracy (vs the
    Cholesky path's ~cond * eps), so ``refine_steps`` rounds of iterative
    refinement — x += A^{-1}(b - A x), two batched matvecs each, residual
    in full precision — squash the error back to Cholesky grade (measured:
    cond 1e9 f64 rel err 2.7e-5 raw -> 4e-9 with one step, matching the
    blocked-Cholesky 6.8e-9). Pads k up to the next power-of-two multiple
    of ``block`` with an identity diagonal.
    """
    k = a.shape[-1]
    kp = block
    while kp < k:
        kp *= 2
    if kp != k:
        bsz = a.shape[0]
        a_p = jnp.zeros((bsz, kp, kp), dtype=a.dtype)
        a_p = a_p.at[:, :k, :k].set(a)
        idx = jnp.arange(k, kp)
        a_p = a_p.at[:, idx, idx].set(1.0)
        b_p = jnp.zeros((bsz, kp), dtype=b.dtype)
        b_p = b_p.at[:, :k].set(b)
        a, b = a_p, b_p
    ainv = inv_spd(a, block)
    x = jnp.einsum("bij,bj->bi", ainv, b, precision=_PREC)
    for _ in range(refine_steps):
        r = b - jnp.einsum("bij,bj->bi", a, x, precision=_PREC)
        x = x + jnp.einsum("bij,bj->bi", ainv, r, precision=_PREC)
    return x[:, :k]
