"""Device-side BPR: negative sampling, minibatch SGD step, eval loss.

Device-side replacement for the reference's Hogwild! SGD
(qmf/bpr/BPREngine.cpp:146-244, BPREngine-inl.h):

- The reference samples one triplet at a time and applies lock-free racy
  updates from many threads. Here a minibatch of B triplets is sampled and
  updated in one device program: every update in the batch reads the same
  pre-batch parameters (exactly what concurrent Hogwild threads effectively
  do) and duplicate-index gradients are summed by scatter-add — the
  deterministic, synchronous counterpart of Hogwild's statistical behavior.
- Negative sampling: the reference rejection-samples uniform item indices
  until the candidate is outside the user's positive set
  (BPREngine-inl.h:48-60). On device we re-sample a fixed number of rounds;
  membership tests are vectorized binary searches over the sorted
  (user, item) key array. After R rounds the expected residual collision
  rate is (avg_degree/nitems)^R — negligible for real data and bounded by
  construction.

The update rule matches reference BPREngine.cpp:178-220 exactly:
    e = 1 / (1 + exp(score_diff))        (d/dx log sigmoid)
    b_i += lr (e - bias_lambda b_i);  b_j += lr (-e - bias_lambda b_j)
    p_u += lr (e (q_i - q_j) - user_lambda p_u)
    q_i += lr (e p_u - item_lambda q_i)
    q_j += lr (-e p_u - item_lambda q_j)
"""

from __future__ import annotations

import functools
import logging
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class BPRParams(NamedTuple):
    """Model state threaded through jitted steps."""

    user_factors: jax.Array  # (U, k)
    item_factors: jax.Array  # (I, k)
    item_biases: jax.Array  # (I,) — zeros and unused when use_biases=False


class PosSet(NamedTuple):
    """Per-user positive-item sets in CSR form for device membership tests.

    int32-safe at any scale (a flat user*n_items+item key would overflow
    int32 — and jax without x64 truncates int64 — already at
    MovieLens-20M scale: 138k users x 27k items > 2^31).
    """

    indptr: jax.Array  # (U+1,) int32 — per-user segment offsets
    items: jax.Array  # (nnz,) int32 — item ids, sorted within each segment
    max_degree: int  # python int — bounds the binary search depth


def make_pos_set(
    user_idx: np.ndarray, item_idx: np.ndarray, n_users: int,
    return_sorted: bool = False,
):
    """Build the CSR positive-set structure (host side, deduplicated).

    With ``return_sorted`` also returns the lexsorted deduplicated
    (user, item) host arrays — they are exactly the order the bitmap/word
    builders need, so callers building both structures pay for ONE 20M-row
    lexsort instead of two (BPR init stage attribution,
    benchmarks/README.md)."""
    order = np.lexsort((item_idx, user_idx))
    u = np.asarray(user_idx)[order]
    i = np.asarray(item_idx)[order]
    # dedup (user, item) pairs
    if len(u):
        keep = np.ones(len(u), dtype=bool)
        keep[1:] = (u[1:] != u[:-1]) | (i[1:] != i[:-1])
        u, i = u[keep], i[keep]
    counts = np.bincount(u, minlength=n_users)
    indptr = np.zeros(n_users + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    max_degree = int(counts.max()) if n_users else 0
    ps = PosSet(
        jnp.asarray(indptr), jnp.asarray(i.astype(np.int32)), max_degree
    )
    if return_sorted:
        return ps, u, i
    return ps


class PosBitmap(NamedTuple):
    """Dense packed (user, item) membership bitmap for O(1) device tests.

    One int32 word holds 32 item slots: bit (i % 32) of
    ``words[u * words_per_user + i // 32]``. A membership test is ONE
    random gather instead of the CSR binary search's ~log2(max_degree)
    chained gathers — the sampler's dominant cost at MovieLens-20M scale
    (measured 23.7 s -> see benchmarks/README.md). Memory is U*I/8 bytes,
    so callers gate on a budget and fall back to :class:`PosSet` when the
    id space is too large (the bitmap does NOT scale to e.g. 10M x 1M).
    """

    words: jax.Array  # (U * words_per_user,) int32
    words_per_user: int


def make_pos_bitmap(
    user_idx: np.ndarray, item_idx: np.ndarray, n_users: int, n_items: int,
    assume_lex_sorted: bool = False,
) -> PosBitmap:
    """Build the packed membership bitmap (host side, vectorized).

    ``assume_lex_sorted``: the inputs are already lexsorted by
    (user, item) — e.g. :func:`make_pos_set`'s ``return_sorted`` output —
    so ``word_idx = u*wpu + (i>>5)`` is nondecreasing and the 20M-row
    argsort is skipped."""
    wpu = (n_items + 31) // 32
    # _is_member_bitmap computes u * wpu + (i >> 5) in int32; guard the
    # word count so a raised bitmap budget cannot silently wrap the index.
    if n_users * wpu >= 2**31:
        raise ValueError(
            f"bitmap word count {n_users * wpu} overflows int32 indexing; "
            "lower bitmap_budget_mb or use the CSR membership path"
        )
    u = np.asarray(user_idx, dtype=np.int64)
    i = np.asarray(item_idx, dtype=np.int64)
    word_idx = u * wpu + (i >> 5)
    bit = np.uint32(1) << (i & 31).astype(np.uint32)
    if not assume_lex_sorted:
        order = np.argsort(word_idx, kind="stable")
        word_idx, bit = word_idx[order], bit[order]
    # OR together all bits landing in the same word (segment reduce)
    starts = np.concatenate(
        [[0], np.nonzero(np.diff(word_idx))[0] + 1]
    ) if len(word_idx) else np.zeros(0, dtype=np.int64)
    n_words = n_users * wpu
    if len(word_idx) and len(starts) * 8 < n_words * 4:
        # sparse device-side build: ship only the distinct (word, bits)
        # pairs and scatter-set into device zeros — host memory and
        # transfer scale with nnz, not U*I (a 200k x 100k catalog's dense
        # bitmap is 2.5 GB; its distinct words are ~160 MB). Indices are
        # unique after the reduceat, so scatter-set has no duplicates.
        uniq_idx = word_idx[starts].astype(np.int32)  # < 2^31 (guard above)
        uniq_bits = np.bitwise_or.reduceat(bit, starts).view(np.int32)
        words = (
            jnp.zeros(n_words, dtype=jnp.int32)
            .at[jnp.asarray(uniq_idx)]
            .set(jnp.asarray(uniq_bits))
        )
        return PosBitmap(words, wpu)
    words = np.zeros(n_words, dtype=np.uint32)
    if len(word_idx):
        words[word_idx[starts]] = np.bitwise_or.reduceat(bit, starts)
    return PosBitmap(jnp.asarray(words.view(np.int32)), wpu)


def _is_member_bitmap(
    bitmap: PosBitmap, users: jax.Array, cand: jax.Array
) -> jax.Array:
    """Vectorized O(1) membership test: one gather + bit extract."""
    word = bitmap.words[users * bitmap.words_per_user + (cand >> 5)]
    return (jax.lax.shift_right_logical(word, cand & 31) & 1) == 1


class PosBloom(NamedTuple):
    """Blocked Bloom filter over each user's positive set.

    The scale path for catalogs whose exact :class:`PosBitmap` exceeds the
    memory budget (U*I/8 bytes; reference design ceiling is ~100M rows,
    /root/reference/distributed/common/Common.h:17-18): memory here is
    U * bits_per_user / 8 bytes, INDEPENDENT of n_items. Two fixed-hash
    bit positions per item inside the user's private 2^m-bit block.

    No false negatives: a "not member" answer is exact, so candidates the
    filter passes are guaranteed true negatives. False positives (rate
    ~(load)^2) only send extra slots to the compacted exact CSR verify in
    :func:`_sample_rounds_bloom` — sampling semantics stay exact, cost
    degrades gracefully with filter load.
    """

    words: jax.Array  # (U * words_per_user,) int32
    words_per_user: int  # power of two


def _bloom_positions(item, bits_per_user: int):
    """Two bit positions for ``item`` in a 2^m-bit block (double hashing).

    Works identically on np.uint32 and jnp.uint32 arrays — the host
    builder and the device membership test MUST agree bit-for-bit.
    """
    mask = np.uint32(bits_per_user - 1)
    h = item * np.uint32(0x9E3779B1)
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(0x85EBCA77)
    h = h ^ (h >> np.uint32(13))
    p1 = h & mask
    p2 = (p1 + ((h >> np.uint32(16)) | np.uint32(1))) & mask
    return p1, p2


def make_pos_bloom(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    n_users: int,
    bits_per_user: int,
) -> PosBloom:
    """Build the blocked Bloom filter (host side, vectorized)."""
    if bits_per_user < 32 or bits_per_user & (bits_per_user - 1):
        raise ValueError("bits_per_user must be a power of two >= 32")
    wpu = bits_per_user // 32
    if n_users * wpu >= 2**31:
        raise ValueError("bloom word count overflows int32 indexing")
    u = np.asarray(user_idx, dtype=np.int64)
    i = np.asarray(item_idx, dtype=np.uint32)
    p1, p2 = _bloom_positions(i, bits_per_user)
    base = u * wpu
    word_idx = np.concatenate([base + (p1 >> 5), base + (p2 >> 5)])
    bit = np.concatenate(
        [np.uint32(1) << (p1 & 31), np.uint32(1) << (p2 & 31)]
    )
    order = np.argsort(word_idx, kind="stable")
    word_idx, bit = word_idx[order], bit[order]
    words = np.zeros(n_users * wpu, dtype=np.uint32)
    if len(word_idx):
        starts = np.concatenate([[0], np.nonzero(np.diff(word_idx))[0] + 1])
        words[word_idx[starts]] = np.bitwise_or.reduceat(bit, starts)
    return PosBloom(jnp.asarray(words.view(np.int32)), wpu)


def _is_member_bloom(
    bloom: PosBloom, users: jax.Array, cand: jax.Array
) -> jax.Array:
    """MAY-be-member test: two gathers + bit tests. False positives only."""
    bits_per_user = bloom.words_per_user * 32
    p1, p2 = _bloom_positions(cand.astype(jnp.uint32), bits_per_user)
    base = users * bloom.words_per_user
    w1 = bloom.words[base + (p1 >> 5).astype(jnp.int32)]
    w2 = bloom.words[base + (p2 >> 5).astype(jnp.int32)]
    b1 = jax.lax.shift_right_logical(w1, (p1 & 31).astype(jnp.int32)) & 1
    b2 = jax.lax.shift_right_logical(w2, (p2 & 31).astype(jnp.int32)) & 1
    return (b1 & b2) == 1


def _is_member(
    pos_set: PosSet, users: jax.Array, cand: jax.Array, unroll: bool = False
) -> jax.Array:
    """Vectorized per-user binary search: is cand[b] in users[b]'s set?"""
    lo = pos_set.indptr[users]  # (B,)
    hi = pos_set.indptr[users + 1]
    steps = max(1, int(np.ceil(np.log2(max(pos_set.max_degree, 1) + 1))) + 1)
    items = pos_set.items
    if items.shape[0] == 0:
        return jnp.zeros(users.shape, dtype=bool)

    def body(_, lohi):
        lo, hi = lohi
        # overflow-safe midpoint: lo + hi wraps int32 once the CSR holds
        # >= 2^30 positives (the docstring's "int32-safe at any scale"
        # contract covers this regime)
        mid = lo + (hi - lo) // 2
        v = items[jnp.minimum(mid, items.shape[0] - 1)]
        go_right = (v < cand) & (lo < hi)
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right | (lo >= hi), hi, mid)
        return lo, hi

    if unroll:
        # statically-unrolled search: straight-line gather chain, no While
        # overhead per probe (crashed the accelerator runtime this code was
        # first written for at ML-20M scale inside a fused epoch scan — kept
        # opt-in until re-validated; see BPRConfig.unroll_membership)
        lohi = (lo, hi)
        for s in range(steps):
            lohi = body(s, lohi)
        lo, hi = lohi
    else:
        lo, hi = jax.lax.fori_loop(0, steps, body, (lo, hi))
    found = items[jnp.minimum(lo, items.shape[0] - 1)] == cand
    return found & (lo < pos_set.indptr[users + 1])


@functools.partial(
    jax.jit,
    static_argnames=("n_items", "rounds", "max_degree", "unroll", "wpu"),
)
def _sample_negatives_impl(
    key: jax.Array,
    users: jax.Array,
    indptr: jax.Array,
    pos_items: jax.Array,
    n_items: int,
    rounds: int,
    max_degree: int,
    unroll: bool = False,
    bitmap_words: Optional[jax.Array] = None,
    wpu: int = 0,
) -> jax.Array:
    pos_set = PosSet(indptr, pos_items, max_degree)
    b = users.shape[0]
    neg = jnp.zeros((b,), dtype=jnp.int32)
    valid = jnp.zeros((b,), dtype=bool)

    def member(cand):
        if bitmap_words is not None:
            return _is_member_bitmap(
                PosBitmap(bitmap_words, wpu), users, cand
            )
        return _is_member(pos_set, users, cand, unroll=unroll)

    for r in range(rounds):
        key, sub = jax.random.split(key)
        cand = jax.random.randint(sub, (b,), 0, n_items, dtype=jnp.int32)
        cand_ok = ~member(cand)
        take = (~valid) & cand_ok
        neg = jnp.where(take, cand, neg)
        # after the final round, fall back to the last candidate if invalid
        if r == rounds - 1:
            neg = jnp.where(valid | take, neg, cand)
        valid = valid | cand_ok
    return neg


def sample_negatives(
    key: jax.Array,
    users: jax.Array,  # (B,) int32 user indices
    pos_set: PosSet,
    n_items: int,
    rounds: int = 4,
    unroll: bool = False,
    bitmap: Optional[PosBitmap] = None,
) -> jax.Array:
    """Sample one negative item per row, rejecting the user's positives.

    Fixed-round re-sampling (no data-dependent loop). Rows
    still colliding after ``rounds`` rounds keep the last candidate —
    residual collision probability is (user_degree/n_items)^rounds.
    """
    return _sample_negatives_impl(
        key,
        users,
        pos_set.indptr,
        pos_set.items,
        n_items=n_items,
        rounds=rounds,
        max_degree=pos_set.max_degree,
        unroll=unroll,
        bitmap_words=None if bitmap is None else bitmap.words,
        wpu=0 if bitmap is None else bitmap.words_per_user,
    )


def _score_diff(
    params: BPRParams,
    users: jax.Array,
    pos: jax.Array,
    neg: jax.Array,
    use_biases: bool,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    pu = params.user_factors[users]  # (B, k)
    qi = params.item_factors[pos]
    qj = params.item_factors[neg]
    d = jnp.sum(pu * (qi - qj), axis=1)
    if use_biases:
        d = d + params.item_biases[pos] - params.item_biases[neg]
    return d, pu, qi, qj


def _sgd_step_body(
    params: BPRParams,
    key: jax.Array,
    users: jax.Array,  # (B,) int32
    pos_items: jax.Array,  # (B,) int32
    weight: jax.Array,  # (B,) 0/1 mask for batch padding
    indptr: jax.Array,
    set_items: jax.Array,
    lr: jax.Array,
    user_lambda: jax.Array,
    item_lambda: jax.Array,
    bias_lambda: jax.Array,
    n_items: int,
    use_biases: bool,
    neg_rounds: int,
    max_degree: int,
    unroll: bool = False,
    bitmap_words: Optional[jax.Array] = None,
    wpu: int = 0,
) -> BPRParams:
    """One synchronous minibatch update (reference update(), vectorized)."""
    neg = _sample_negatives_impl(
        key,
        users,
        indptr,
        set_items,
        n_items=n_items,
        rounds=neg_rounds,
        max_degree=max_degree,
        unroll=unroll,
        bitmap_words=bitmap_words,
        wpu=wpu,
    )
    return _sgd_update_body(
        params, users, pos_items, neg, weight, lr, user_lambda, item_lambda,
        bias_lambda, use_biases=use_biases,
    )


def _sgd_update_body(
    params: BPRParams,
    users: jax.Array,  # (B,) int32
    pos_items: jax.Array,  # (B,) int32
    neg: jax.Array,  # (B,) int32 pre-sampled negatives
    weight: jax.Array,  # (B,) 0/1 mask for batch padding
    lr: jax.Array,
    user_lambda: jax.Array,
    item_lambda: jax.Array,
    bias_lambda: jax.Array,
    use_biases: bool,
) -> BPRParams:
    """The SGD update of one minibatch with negatives already sampled."""
    d, pu, qi, qj = _score_diff(params, users, pos_items, neg, use_biases)
    e = (1.0 / (1.0 + jnp.exp(d))) * weight  # masked loss derivative
    wcol = weight[:, None]

    uf = params.user_factors.at[users].add(
        lr * (e[:, None] * (qi - qj) - user_lambda * pu * wcol)
    )
    # NOTE: merging the pos/neg item scatters into one concatenated 2B-row
    # scatter is algebraically equivalent and was tried — it deterministically
    # kernel-faulted the accelerator runtime this code was first written for,
    # inside the epoch scan at MovieLens-20M scale. Keep the two sequential
    # B-row scatters until that is re-validated.
    epu = e[:, None] * pu
    itf = params.item_factors.at[pos_items].add(
        lr * (epu - item_lambda * qi * wcol)
    )
    itf = itf.at[neg].add(lr * (-epu - item_lambda * qj * wcol))
    if use_biases:
        bi = params.item_biases[pos_items]
        bj = params.item_biases[neg]
        ib = params.item_biases.at[pos_items].add(
            lr * (e - bias_lambda * bi * weight)
        )
        ib = ib.at[neg].add(lr * (-e - bias_lambda * bj * weight))
    else:
        ib = params.item_biases
    return BPRParams(uf, itf, ib)


_sgd_step_impl = functools.partial(
    jax.jit,
    static_argnames=(
        "n_items", "use_biases", "neg_rounds", "max_degree", "unroll", "wpu"
    ),
    donate_argnums=(0,),
)(_sgd_step_body)


def sgd_step(
    params: BPRParams,
    key: jax.Array,
    users: jax.Array,
    pos_items: jax.Array,
    weight: jax.Array,
    pos_set: PosSet,
    lr: jax.Array,
    user_lambda: jax.Array,
    item_lambda: jax.Array,
    bias_lambda: jax.Array,
    n_items: int,
    use_biases: bool,
    neg_rounds: int,
) -> BPRParams:
    return _sgd_step_impl(
        params,
        key,
        users,
        pos_items,
        weight,
        pos_set.indptr,
        pos_set.items,
        lr,
        user_lambda,
        item_lambda,
        bias_lambda,
        n_items=n_items,
        use_biases=use_biases,
        neg_rounds=neg_rounds,
        max_degree=pos_set.max_degree,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_items",
        "use_biases",
        "neg_rounds",
        "max_degree",
        "shuffle",
        "batch_size",
        "unroll",
        "wpu",
    ),
    donate_argnums=(0,),
)
def _sgd_epoch_impl(
    params: BPRParams,
    key: jax.Array,
    users_flat: jax.Array,  # (S*B,) int32 triplet users (padded)
    items_flat: jax.Array,  # (S*B,) int32 positive items
    weights_flat: jax.Array,  # (S*B,) 0/1 padding mask
    indptr: jax.Array,
    set_items: jax.Array,
    lr: jax.Array,
    user_lambda: jax.Array,
    item_lambda: jax.Array,
    bias_lambda: jax.Array,
    n_items: int,
    use_biases: bool,
    neg_rounds: int,
    max_degree: int,
    shuffle: bool,
    batch_size: int,
    unroll: bool = False,
    bitmap_words: Optional[jax.Array] = None,
    wpu: int = 0,
) -> BPRParams:
    """A FULL training epoch as one device program.

    The reference walks the (shuffled) positive-pair vector once per epoch,
    sampling negatives per pair (BPREngine.cpp:146-176). Here the epoch is a
    ``lax.scan`` over minibatches: optional on-device permutation of the
    triplet stream, per-step negative sampling, and the SGD update — a
    single dispatch instead of thousands.

    Shuffle-semantics note: the reference shuffles the positive-pair vector
    and emits num_negative_samples consecutive updates per pair
    (BPREngine.cpp:172-174); permuting the expanded triplet stream is an
    equivalent-in-distribution ordering.

    PROGRAM-SHAPE WARNING (hard-won): sampling MUST stay inside the scan
    body. Hoisting it out — one wide presampling pass feeding the scan as a
    4th xs array — crashed the runtime this code was first written for with
    a kernel fault at
    MovieLens-20M scale, in every variant tried (fused or as a separate
    program, with or without shuffle, merged or split scatters), while this
    in-scan shape runs for hours. With the bitmap membership table the
    in-scan sampler is cheap anyway: one gather per candidate round, no
    While loop (see PosBitmap).
    """
    if shuffle:
        key, pkey = jax.random.split(key)
        perm = jax.random.permutation(pkey, users_flat.shape[0])
        users_flat = users_flat[perm]
        items_flat = items_flat[perm]
        weights_flat = weights_flat[perm]
    s = users_flat.shape[0] // batch_size
    u_steps = users_flat.reshape(s, batch_size)
    i_steps = items_flat.reshape(s, batch_size)
    w_steps = weights_flat.reshape(s, batch_size)

    def body(carry, inp):
        params, key = carry
        key, sub = jax.random.split(key)
        u, i, w = inp
        params = _sgd_step_body(
            params,
            sub,
            u,
            i,
            w,
            indptr,
            set_items,
            lr,
            user_lambda,
            item_lambda,
            bias_lambda,
            n_items=n_items,
            use_biases=use_biases,
            neg_rounds=neg_rounds,
            max_degree=max_degree,
            unroll=unroll,
            bitmap_words=bitmap_words,
            wpu=wpu,
        )
        return (params, key), None

    (params, _), _ = jax.lax.scan(
        body, (params, key), (u_steps, i_steps, w_steps)
    )
    return params


_PACK_SHIFT = 15  # packed items xs: pos << 15 | neg, valid while n_items <= 32768

# fallback-path diagnoses already emitted (log once per reason set, not per
# epoch — the condition is fixed at init time)
_fallback_logged: set = set()


def _feistel_bijection(key: jax.Array, m: int, b: int) -> jax.Array:
    """A keyed bijection on [0, m * 2**b) as pure index arithmetic.

    Generalizes :func:`_mix_bijection` (power-of-two domains only) to any
    domain of the form m * 2**b: write x = q * 2**b + r and alternate
    coordinate updates that are each bijective for a fixed other coordinate
    (a Feistel-style network):

        r ^= h(q) & (2**b - 1)   (XOR: bijective in r)
        q  = (q + h(r)) mod m    (add: bijective in q; mod-by-static-m
                                  lowers to a mul-shift, no real division)
        r  = mix_pow2(r)         (odd-multiplier/xorshift mixer: bijective)

    Three rounds give epoch-shuffle-grade mixing. This keeps the shuffled
    stream length within 2**b of the real length (callers pick b ~ 16),
    instead of the up-to-2x padding a pure power-of-two bijection needs.
    Like _mix_bijection this is deliberately sort-free: sort-based
    permutations fused with the sampler kernel-faulted the runtime this code
    was first written for.
    """
    n = m << b
    mask_b = (1 << b) - 1
    ks = jax.random.randint(key, (6,), 0, 1 << 30, dtype=jnp.int32)

    def h(x, k):
        x = x * ((k << 1) | 1)
        x = x ^ ((x >> 7) ^ (x >> 13))
        return x * 0x6C62_72E5 + k

    x = jnp.arange(n, dtype=jnp.uint32)
    q = (x >> b).astype(jnp.int32)
    r = (x & mask_b).astype(jnp.int32)
    for i in range(3):
        r = r ^ (h(q, ks[2 * i]) & mask_b)
        q = (q + (h(r, ks[2 * i + 1]) & 0x3FFF_FFFF)) % m
        # in-place power-of-two mix of r
        r = (r * ((ks[2 * i] << 1) | 1)) & mask_b
        r = r ^ (r >> max(1, b // 2))
    return q * (1 << b) + r


def _mix32(rk: jax.Array, f: jax.Array) -> jax.Array:
    """Murmur-finalizer-grade 32-bit mixer of slot index f under round key
    rk (3,) int32. Shared by :func:`_cand_hash` and :func:`_word_probe`;
    MUST stay bit-identical between the presampling programs and the
    in-scan reconstruction (the scan stores only a 2-bit round index per
    slot and recomputes the candidate item from it)."""
    # the mixer depends on int32 wraparound; x64 mode (or int64 indices
    # from jnp.where) must not change the arithmetic width
    f = jnp.asarray(f, jnp.int32)
    rk = jnp.asarray(rk, jnp.int32)
    x = f * ((rk[0] << 1) | 1)
    x = x ^ ((x >> 7) ^ (x >> 13))
    x = x * ((rk[1] << 1) | 1)
    x = x ^ (x >> 11)
    x = x * ((rk[2] << 1) | 1)
    x = x ^ (x >> 9)
    return x


def _cand_hash(rk: jax.Array, f: jax.Array, n_items: int) -> jax.Array:
    """Candidate item for slot index f under round key rk (3,) int32,
    uniform-enough over [0, n_items) (bias ~ n_items/2^32; the mod by a
    STATIC n_items lowers to a mul-shift)."""
    x = _mix32(rk, f)
    return (x.astype(jnp.uint32) % jnp.uint32(n_items)).astype(jnp.int32)


# In-word probe offsets (mod 32) for the word sampler: slot j's probe
# round r tests bit (bit0 + _WORD_DELTA[j * (n_rounds-1) + r]) & 31 of the
# row's ONE gathered bitmap word. Pairwise distinct mod 32, so no two
# (slot, round) probes of a row can select the same item; spread out, so
# probes test well-separated bits. Capacity: num_neg * (n_rounds-1) <= 15
# (checked by word_sampler_applies); beyond it the grouped path falls back
# to the compacted exact-rejection sampler.
_WORD_DELTA = (0, 11, 19, 5, 16, 27, 3, 9, 25, 7, 14, 22, 29, 2, 13)


def word_sampler_applies(num_neg: int, n_rounds: int) -> bool:
    """True when the shared-word probe table covers every (slot, round)."""
    return num_neg * max(n_rounds - 1, 0) <= len(_WORD_DELTA)


def _word_probe(rk: jax.Array, row: jax.Array, wpu: int):
    """(word, bit0) coordinates of stream row ``row``'s shared probe word:
    word uniform over the user's ``wpu`` bitmap words, bit0 uniform over
    its 32 bits. ONE word gather per positive serves every (slot, round)
    probe of that row — slot j's round-r probe tests bit
    (bit0 + _WORD_DELTA[j*(n_rounds-1)+r]) & 31. Bit-identical contract
    with the in-scan reconstruction, like :func:`_cand_hash`."""
    x = _mix32(rk, row)
    b0 = x & 31
    w = (
        jax.lax.shift_right_logical(x, jnp.int32(5)).astype(jnp.uint32)
        % jnp.uint32(wpu)
    ).astype(jnp.int32)
    return w, b0


def _word_tail_mask(n_items: int, wpu: int) -> Optional[int]:
    """int32 mask of the NEVER-VALID bits of a user's last bitmap word
    (item ids >= n_items), or None when n_items fills the word exactly.
    The word sampler ORs it in so an invalid bit always reads "member" and
    is never chosen as a negative."""
    tail = n_items - 32 * (wpu - 1)
    if tail >= 32:
        return None
    return int(np.int32(np.uint32((0xFFFFFFFF << tail) & 0xFFFFFFFF)))


def _sample_rounds_word(
    rk: jax.Array,  # (R, 3) int32 round keys
    users: jax.Array,  # (n_rows,) int32 user of each stream row
    bitmap: PosBitmap,
    n_items: int,
    n_rounds: int,
    num_neg: int,
):
    """Single-shared-gather variant of :func:`_sample_rounds`: each
    positive row gathers ONE bitmap word; slot j's rounds r < n_rounds-1
    probe bits (b0 + _WORD_DELTA[j*(n_rounds-1)+r]) & 31 of that word; the
    final round is a fresh per-slot :func:`_cand_hash` candidate accepted
    UNCHECKED.

    Cost: one (n_rows,) word gather + VPU bit math — no where-compaction,
    no scatter, no per-round gathers, and num_neg x fewer gathered rows
    than a per-slot word. (The compaction + per-round gathers dominated
    the presample program at ML-20M scale — compaction 0.45 s + rounds
    0.24 s + scatter 0.10 s of a 2.11 s program — and random-gather cost
    here is per ROW, not per byte: benchmarks/bpr_presample_micro.py.)

    Semantics vs the reference's resample-until-non-positive
    (BPREngine-inl.h:48-60): probe 0 of slot 0 is exactly uniform over the
    32*wpu padded id domain (tail-masked); later probes and sibling slots
    stay within the row's 32-item block (conditionally correlated), and
    the unchecked last round keeps a positive with probability
    ~p_collision when reached — overall residual ~p * q^(R-2) * p per
    slot (p = per-slot collision rate ~0.7% at ml20m, q = in-word
    conditional rate), vs p^R for the compacted sampler. Within-row slots
    never collide with each other on probe rounds (_WORD_DELTA offsets are
    distinct mod 32). Validated end-to-end by benchmarks/bpr_auc_parity.py.

    Returns (rounds (n_rows, num_neg) int32, n_overflow=0) — there is no
    collision buffer to overflow.
    """
    n_rows = users.shape[0]
    wpu = bitmap.words_per_user
    zero = jnp.zeros((), jnp.int32)
    if n_rounds == 1:
        return jnp.zeros((n_rows, num_neg), jnp.int32), zero
    row = jnp.arange(n_rows, dtype=jnp.int32)
    w, b0 = _word_probe(rk[0], row, wpu)
    word = bitmap.words[users * wpu + w]
    invalid = _word_tail_mask(n_items, wpu)
    if invalid is not None:
        word = jnp.where(w == wpu - 1, word | jnp.int32(invalid), word)
    cols = []
    for j in range(num_neg):
        r_col = jnp.full((n_rows,), n_rounds - 1, jnp.int32)
        for r in range(n_rounds - 2, -1, -1):
            bit = (b0 + _WORD_DELTA[j * (n_rounds - 1) + r]) & 31
            member = (jax.lax.shift_right_logical(word, bit) & 1) == 1
            r_col = jnp.where(member, r_col, r)
        cols.append(r_col)
    return jnp.stack(cols, axis=1), zero


def _sample_rounds(
    rk: jax.Array,  # (R, 3) int32 round keys
    users_slots: jax.Array,  # (N,) int32 user of each negative slot
    bitmap: PosBitmap,
    n_items: int,
    n_rounds: int,
    collide_cap: int,
):
    """Pick, per negative slot f, the first round r whose candidate
    ``_cand_hash(rk[r], f)`` is NOT a positive of users_slots[f].

    Exact-rejection semantics (reference BPREngine-inl.h:48-60) at ~1/R of
    the membership cost: only round 0 is tested at full stream width; the
    ~(avg_degree/n_items) fraction of colliding slots is compacted to a
    fixed ``collide_cap``-slot buffer and rounds 1..R-1 test only those.
    Slots colliding in every round keep the LAST round's candidate
    (residual probability (degree/n_items)^R, matching sample_negatives).

    Returns (rounds (N,) int32 in [0, R), n_overflow) where n_overflow
    counts colliders beyond ``collide_cap`` (those keep round 0; callers
    should log when it is nonzero — quality degrades gracefully).
    """
    n = users_slots.shape[0]
    f = jnp.arange(n, dtype=jnp.int32)
    member0 = _is_member_bitmap(
        bitmap, users_slots, _cand_hash(rk[0], f, n_items)
    )
    rounds = jnp.zeros((n,), jnp.int32)
    if n_rounds == 1:
        return rounds, jnp.zeros((), jnp.int32)
    (cidx,) = jnp.where(member0, size=collide_cap, fill_value=n)
    cvalid = cidx < n
    cf = jnp.where(cvalid, cidx, 0)
    cu = users_slots[cf]
    chosen = jnp.full(cidx.shape, n_rounds - 1, jnp.int32)
    found = jnp.zeros(cidx.shape, bool)
    for r in range(1, n_rounds):
        m_r = _is_member_bitmap(bitmap, cu, _cand_hash(rk[r], cf, n_items))
        take = (~found) & (~m_r)
        chosen = jnp.where(take, r, chosen)
        found = found | take
    rounds = rounds.at[cidx].set(chosen, mode="drop")
    n_overflow = jnp.maximum(
        member0.sum(dtype=jnp.int32) - jnp.int32(collide_cap), 0
    )
    return rounds, n_overflow


def _sample_rounds_bloom(
    rk: jax.Array,  # (R, 3) int32 round keys
    users_slots: jax.Array,  # (N,) int32 user of each negative slot
    bloom: PosBloom,
    pos_set: PosSet,
    n_items: int,
    n_rounds: int,
    collide_cap: int,
):
    """:func:`_sample_rounds` for catalogs beyond the exact-bitmap budget.

    Same contract and EXACT same sampling semantics, composed differently:
    round 0 is tested at full stream width against the blocked Bloom filter
    (2 gathers/slot, no false negatives), and only the Bloom HITS — true
    collisions plus the ~load^2 false-positive fraction — are compacted to
    ``collide_cap`` slots and exact-verified with the CSR binary search.
    Bloom false positives keep their (verified-negative) round-0 candidate;
    true members walk rounds 1..R-1 under exact CSR tests.
    """
    n = users_slots.shape[0]
    f = jnp.arange(n, dtype=jnp.int32)
    hit0 = _is_member_bloom(
        bloom, users_slots, _cand_hash(rk[0], f, n_items)
    )
    rounds = jnp.zeros((n,), jnp.int32)
    (cidx,) = jnp.where(hit0, size=collide_cap, fill_value=n)
    cvalid = cidx < n
    cf = jnp.where(cvalid, cidx, 0)
    cu = users_slots[cf]
    # exact round-0 verdict for the compacted slots
    m0 = _is_member(pos_set, cu, _cand_hash(rk[0], cf, n_items))
    chosen = jnp.where(m0, jnp.int32(n_rounds - 1), 0)
    found = ~m0
    for r in range(1, n_rounds):
        m_r = _is_member(pos_set, cu, _cand_hash(rk[r], cf, n_items))
        take = (~found) & (~m_r)
        chosen = jnp.where(take, r, chosen)
        found = found | take
    rounds = rounds.at[cidx].set(chosen, mode="drop")
    n_overflow = jnp.maximum(
        hit0.sum(dtype=jnp.int32) - jnp.int32(collide_cap), 0
    )
    return rounds, n_overflow


def _sample_pack_grouped_body(
    key: jax.Array,
    pos_up: jax.Array,  # (n_stream, 2) int32 [user, pos_item] rows,
    #                     n_stream = m * 2**feistel_b
    bitmap_words: jax.Array,  # exact-bitmap OR bloom words, per `membership`
    n_items: int,
    n_real: int,  # rows < n_real are real positive pairs, >= are padding
    num_neg: int,
    n_rounds: int,
    shuffle: bool,
    wpu: int,
    u_shift: int,
    feistel_b: int,
    collide_cap: int,
    membership: str = "bitmap",
    indptr: Optional[jax.Array] = None,  # CSR verify arrays (bloom mode)
    csr_items: Optional[jax.Array] = None,
    max_degree: int = 0,
):
    """Grouped-epoch program 1: shuffle positives, presample ALL negatives,
    encode each row as (u_enc, pos).

    The row's num_neg negatives are NOT stored as items: slot f's candidate
    under round r is the pure function _cand_hash(rk[r], f), so storing the
    chosen 2-bit round index per slot is enough for the scan body to
    reconstruct the item with VPU arithmetic (no membership gathers in the
    scan — the fault shape of the runtime this code was first written for).
    Encoding:

        u_enc = (u << u_shift) | round_j bits (2 per negative) << 1 | valid

    This keeps the scan at TWO wide xs arrays, removes the pos<<15|neg
    item-count ceiling (any int32 item id works), and cuts the shuffled
    stream from triplet-level to positive-level width. The (user, item)
    pairs arrive INTERLEAVED as one (n_stream, 2) array so the shuffle is
    ONE row gather — random-gather cost is per gathered
    ROW, not per byte (benchmarks/bpr_presample_micro.py), and the legacy
    _sample_pack_impl uses the same layout.
    """
    n_stream = pos_up.shape[0]
    key, rkey = jax.random.split(key)
    rk = jax.random.randint(rkey, (n_rounds, 3), 0, 1 << 30, dtype=jnp.int32)
    if shuffle:
        key, mkey = jax.random.split(key)
        idx = _feistel_bijection(mkey, n_stream >> feistel_b, feistel_b)
        up = pos_up[idx]
        valid = idx < n_real
    else:
        up = pos_up
        valid = jnp.arange(n_stream, dtype=jnp.int32) < n_real
    u = up[:, 0]
    p = up[:, 1]
    if membership == "word":
        rounds_row, n_overflow = _sample_rounds_word(
            rk, u, PosBitmap(bitmap_words, wpu), n_items, n_rounds, num_neg
        )
        enc = (u << u_shift) | valid.astype(jnp.int32)
        for j in range(num_neg):
            enc = enc | (rounds_row[:, j] << (1 + 2 * j))
        return enc, p, rk, n_overflow
    # negative slot index f = row * num_neg + j; users_slots[f] is the
    # user of slot f, so _sample_rounds's f = arange(N_slots) lines up with
    # the scan body's (t * batch + lane) * num_neg + j
    users_slots = jnp.repeat(u, num_neg)
    if membership == "bloom":
        rounds, n_overflow = _sample_rounds_bloom(
            rk,
            users_slots,
            PosBloom(bitmap_words, wpu),
            PosSet(indptr, csr_items, max_degree),
            n_items,
            n_rounds,
            collide_cap,
        )
    else:
        rounds, n_overflow = _sample_rounds(
            rk,
            users_slots,
            PosBitmap(bitmap_words, wpu),
            n_items,
            n_rounds,
            collide_cap,
        )
    rounds_row = rounds.reshape(n_stream, num_neg)
    enc = (u << u_shift) | valid.astype(jnp.int32)
    for j in range(num_neg):
        enc = enc | (rounds_row[:, j] << (1 + 2 * j))
    return enc, p, rk, n_overflow


_GROUPED_PACK_STATICS = (
    "n_items", "n_real", "num_neg", "n_rounds", "shuffle", "wpu",
    "u_shift", "feistel_b", "collide_cap", "membership", "max_degree",
)
_sample_pack_grouped_impl = functools.partial(
    jax.jit, static_argnames=_GROUPED_PACK_STATICS
)(_sample_pack_grouped_body)


def _sgd_epoch_scan_grouped_body(
    params: BPRParams,
    u_enc: jax.Array,  # (S*B,) int32: user + per-slot round bits + valid
    pos: jax.Array,  # (S*B,) int32 positive items
    rk: jax.Array,  # (R, 3) int32 round keys (shared with presampling)
    lr: jax.Array,
    user_lambda: jax.Array,
    item_lambda: jax.Array,
    bias_lambda: jax.Array,
    use_biases: bool,
    batch_size: int,
    num_neg: int,
    n_items: int,
    n_rounds: int,
    u_shift: int,
    item_scatter: str = "seq",
    sampler: str = "rounds",
    wpu: int = 0,
) -> BPRParams:
    """Grouped-epoch program 2: minibatch-SGD scan, one row per POSITIVE.

    Compared to the triplet-stream scan this shares the user/positive
    gathers and the user/positive scatters across the row's num_neg
    negatives: 2 + num_neg gathers and 2 + num_neg B-row scatters per step
    instead of 3 * num_neg each. Negative items are reconstructed from the
    2-bit round indices via _cand_hash (pure VPU ops). Update semantics are
    identical to num_neg consecutive triplet rows of the ungrouped scan:
    every gradient reads pre-batch parameters; duplicate-row contributions
    (including the num_neg-fold regularization pull on u and pos) sum.
    """
    s = u_enc.shape[0] // batch_size
    ue_steps = u_enc.reshape(s, batch_size)
    p_steps = pos.reshape(s, batch_size)
    t_steps = jnp.arange(s, dtype=jnp.int32)
    lane = jnp.arange(batch_size, dtype=jnp.int32)

    def body(params, inp):
        ue, p, t = inp
        w = (ue & 1).astype(params.user_factors.dtype)
        u = jax.lax.shift_right_logical(ue, jnp.int32(u_shift))
        wcol = w[:, None]
        pu = params.user_factors[u]
        qp = params.item_factors[p]
        row_idx = t * batch_size + lane
        base_f = row_idx * num_neg
        x_p = jnp.einsum("bk,bk->b", pu, qp)
        if sampler == "word" and n_rounds > 1:
            w_row, b0_row = _word_probe(rk[0], row_idx, wpu)
        negs, es = [], []
        for j in range(num_neg):
            r_j = jax.lax.shift_right_logical(ue, jnp.int32(1 + 2 * j)) & 3
            f_j = base_f + j
            if sampler == "word":
                # shared-word in-word probes for r < n_rounds-1, fresh
                # per-slot hash for the unchecked final round (must mirror
                # _sample_rounds_word)
                neg_j = _cand_hash(rk[n_rounds - 1], f_j, n_items)
                if n_rounds > 1:
                    for r in range(n_rounds - 1):
                        delta = _WORD_DELTA[j * (n_rounds - 1) + r]
                        cand_r = w_row * 32 + ((b0_row + delta) & 31)
                        neg_j = jnp.where(r_j == r, cand_r, neg_j)
            else:
                neg_j = _cand_hash(rk[0], f_j, n_items)
                for r in range(1, n_rounds):
                    neg_j = jnp.where(
                        r_j == r, _cand_hash(rk[r], f_j, n_items), neg_j
                    )
            qn_j = params.item_factors[neg_j]
            d_j = x_p - jnp.einsum("bk,bk->b", pu, qn_j)
            if use_biases:
                d_j = d_j + params.item_biases[p] - params.item_biases[neg_j]
            e_j = (1.0 / (1.0 + jnp.exp(d_j))) * w
            negs.append((neg_j, qn_j))
            es.append(e_j)
        # user update: sum of the num_neg triplet gradients
        du = -num_neg * user_lambda * pu * wcol
        for e_j, (_, qn_j) in zip(es, negs):
            du = du + e_j[:, None] * (qp - qn_j)
        uf = params.user_factors.at[u].add(lr * du)
        e_sum = sum(es)
        dp = e_sum[:, None] * pu - num_neg * item_lambda * qp * wcol
        if item_scatter in ("merged", "dense"):
            all_idx = jnp.concatenate(
                [p] + [neg_j for neg_j, _ in negs], axis=0
            )
            all_upd = jnp.concatenate(
                [dp]
                + [
                    -e_j[:, None] * pu - item_lambda * qn_j * wcol
                    for e_j, (_, qn_j) in zip(es, negs)
                ],
                axis=0,
            )
            if item_scatter == "dense":
                # segment-sum into a fresh zeroed accumulator + one dense
                # add: the scatter RMW no longer targets the live factor
                # table, so it stops serializing against the next step's
                # factor gathers (in-scan A/B: ~10% faster than the
                # sequential shape, benchmarks/bpr_dedup_scan_micro.py;
                # the sort-based dedup variant LOSES — sorting + reorder
                # costs more than the duplicate scatter traffic saves)
                itf = params.item_factors + lr * jax.ops.segment_sum(
                    all_upd, all_idx, num_segments=params.item_factors.shape[0]
                )
            else:
                # ONE (1+num_neg)*B-row scatter-add for the whole
                # item-side update. Scatter-add sums duplicates in
                # unspecified order, so this is semantically identical to
                # the sequential scatters; it trades num_neg+1 scatter
                # dispatches for one wider one.
                itf = params.item_factors.at[all_idx].add(lr * all_upd)
        else:
            itf = params.item_factors.at[p].add(lr * dp)
            # num_neg sequential B-row scatters (the known-stable shape; a
            # merged wide scatter previously kernel-faulted this runtime —
            # see _sgd_update_body's NOTE; item_scatter="merged" retests it)
            for e_j, (neg_j, qn_j) in zip(es, negs):
                itf = itf.at[neg_j].add(
                    lr * (-e_j[:, None] * pu - item_lambda * qn_j * wcol)
                )
        if use_biases:
            bp = params.item_biases[p]
            if item_scatter in ("merged", "dense"):
                bidx = jnp.concatenate(
                    [p] + [neg_j for neg_j, _ in negs], axis=0
                )
                bupd = jnp.concatenate(
                    [e_sum - num_neg * bias_lambda * bp * w]
                    + [
                        -e_j
                        - bias_lambda * params.item_biases[neg_j] * w
                        for e_j, (neg_j, _) in zip(es, negs)
                    ],
                    axis=0,
                )
                if item_scatter == "dense":
                    ib = params.item_biases + lr * jax.ops.segment_sum(
                        bupd, bidx, num_segments=params.item_biases.shape[0]
                    )
                else:
                    ib = params.item_biases.at[bidx].add(lr * bupd)
            else:
                ib = params.item_biases.at[p].add(
                    lr * (e_sum - num_neg * bias_lambda * bp * w)
                )
                for e_j, (neg_j, _) in zip(es, negs):
                    bn = params.item_biases[neg_j]
                    ib = ib.at[neg_j].add(lr * (-e_j - bias_lambda * bn * w))
        else:
            ib = params.item_biases
        return BPRParams(uf, itf, ib), None

    params, _ = jax.lax.scan(body, params, (ue_steps, p_steps, t_steps))
    return params


_GROUPED_SCAN_STATICS = (
    "use_biases", "batch_size", "num_neg", "n_items", "n_rounds", "u_shift",
    "item_scatter", "sampler", "wpu",
)
_sgd_epoch_scan_grouped_impl = functools.partial(
    jax.jit,
    static_argnames=_GROUPED_SCAN_STATICS,
    donate_argnums=(0,),
)(_sgd_epoch_scan_grouped_body)


def grouped_path_reject_reason(
    n_users: int,
    n_items: int,
    num_neg: int,
    n_rounds: int,
    batch_size: int,
    has_bitmap: bool,
) -> Optional[str]:
    """Why the grouped packed epoch cannot run, or None if it can.

    Callers log the reason so a configuration that silently loses the fast
    path (e.g. a non-power-of-two batch_size) is diagnosable from the log
    (round-2 verdict: silent perf cliffs).
    """
    u_shift = 1 + 2 * num_neg
    if not has_bitmap:
        return "no positive-membership structure (bitmap/bloom) available"
    if num_neg < 1:
        return f"num_negative_samples={num_neg} < 1"
    if u_shift > 30:
        return (
            f"num_negative_samples={num_neg} leaves no user bits "
            f"(needs 1 + 2*{num_neg} + user bits <= 31)"
        )
    if not 1 <= n_rounds <= 4:
        return (
            f"neg_resample_rounds={n_rounds} outside [1, 4] "
            "(round index must fit 2 bits)"
        )
    if batch_size < 1:
        return f"batch_size={batch_size} < 1"
    if batch_size & (batch_size - 1):
        return (
            f"batch_size={batch_size} is not a power of two "
            "(stream shuffle needs an m * 2^b domain)"
        )
    if n_users > (1 << (31 - u_shift)):
        return (
            f"n_users={n_users} exceeds 2^{31 - u_shift} "
            f"(user id must fit beside {num_neg} 2-bit round indices)"
        )
    if n_items >= (1 << 31):
        return f"n_items={n_items} >= 2^31"
    return None


def sgd_epoch_grouped(
    params: BPRParams,
    key: jax.Array,
    pos_up: jax.Array,  # (n_stream, 2) int32 padded [user, item] pair rows
    bitmap,  # PosBitmap (exact) or PosBloom (needs pos_set for verify)
    lr: jax.Array,
    user_lambda: jax.Array,
    item_lambda: jax.Array,
    bias_lambda: jax.Array,
    n_items: int,
    n_real: int,
    use_biases: bool,
    num_neg: int,
    neg_rounds: int,
    shuffle: bool,
    batch_size: int,
    collide_cap: int,
    pos_set: Optional[PosSet] = None,
    item_scatter: str = "seq",
    sampler: str = "rounds",
):
    """One grouped training epoch: presample+encode, then the grouped scan.

    Returns (params, n_overflow) where n_overflow is a DEVICE scalar of
    collision-buffer overflows (callers should log when nonzero, reading it
    at a point that already syncs).

    Caller contract: pos_up is padded to a multiple of batch_size
    (a power of two), n_real marks the real prefix length, and
    grouped_path_reject_reason(...) returned None for this configuration.
    """
    u_shift = 1 + 2 * num_neg
    key, skey = jax.random.split(key)
    feistel_b = batch_size.bit_length() - 1
    is_bloom = isinstance(bitmap, PosBloom)
    if is_bloom and pos_set is None:
        raise ValueError("bloom membership requires pos_set for exact verify")
    use_word = (
        sampler == "word"
        and not is_bloom
        and word_sampler_applies(num_neg, neg_rounds)
    )
    enc, p, rk, n_overflow = _sample_pack_grouped_impl(
        skey,
        pos_up,
        bitmap.words,
        n_items=n_items,
        n_real=n_real,
        num_neg=num_neg,
        n_rounds=neg_rounds,
        shuffle=shuffle,
        wpu=bitmap.words_per_user,
        u_shift=u_shift,
        feistel_b=feistel_b,
        collide_cap=collide_cap,
        membership="word" if use_word
        else ("bloom" if is_bloom else "bitmap"),
        indptr=pos_set.indptr if is_bloom else None,
        csr_items=pos_set.items if is_bloom else None,
        max_degree=pos_set.max_degree if is_bloom else 0,
    )
    new_params = _sgd_epoch_scan_grouped_impl(
        params,
        enc,
        p,
        rk,
        lr,
        user_lambda,
        item_lambda,
        bias_lambda,
        use_biases=use_biases,
        batch_size=batch_size,
        num_neg=num_neg,
        n_items=n_items,
        n_rounds=neg_rounds,
        u_shift=u_shift,
        item_scatter=item_scatter,
        sampler="word" if use_word else "rounds",
        wpu=bitmap.words_per_user if use_word else 0,
    )
    return new_params, n_overflow


def _mix_bijection(key: jax.Array, n_pow2: int, kbits: int) -> jax.Array:
    """A random bijection on [0, 2^kbits) as pure index arithmetic.

    Three odd-multiplier multiplications mod 2^k interleaved with
    xor-shift-right mixes — every step is invertible mod 2^k (odd multiplier:
    unit of Z/2^k; x ^ (x>>a): triangular linear map over GF(2)), so the
    composition is a permutation. Replaces jax.random.permutation for the
    epoch shuffle: no sort, no extra program — the runtime this code was
    first written for kernel-faulted when a sort-based permutation was fused
    with the sampler or run over multiple arrays, while this form
    compiles and runs clean. Quality: an LCG-grade mix, re-keyed per epoch;
    the reference's mt19937 shuffle (BPREngine.cpp:172-174) is likewise
    "only" pseudorandom — SGD needs decorrelation, not cryptography.
    """
    mask = n_pow2 - 1
    ks = jax.random.randint(key, (3,), 0, 1 << 30, dtype=jnp.int32)
    x = jnp.arange(n_pow2, dtype=jnp.int32)
    x = (x * ((ks[0] << 1) | 1)) & mask
    x = x ^ ((x >> 7) ^ (x >> 13))
    x = (x * ((ks[1] << 1) | 1)) & mask
    x = x ^ (x >> (max(1, kbits // 2)))
    x = (x * ((ks[2] << 1) | 1)) & mask
    return x


@functools.partial(
    jax.jit,
    static_argnames=("n_items", "n_real", "neg_rounds", "shuffle", "wpu"),
)
def _sample_pack_impl(
    key: jax.Array,
    tri_ui: jax.Array,  # (N, 2) int32 [user, pos_item] rows, N a power of 2
    bitmap_words: jax.Array,
    n_items: int,
    n_real: int,  # rows < n_real are real triplets, >= are padding
    neg_rounds: int,
    shuffle: bool,
    wpu: int,
):
    """Epoch program 1: shuffle, presample negatives, pack.

    - The epoch shuffle is a sort-free bijective index hash applied as ONE
      row gather of the interleaved (user, item) stream; the padding mask
      needs no gather at all (w = idx < n_real).
    - Negatives are parameter-independent, so sampling commutes with the
      SGD updates; one wide bitmap-membership pass replaces per-step
      sampling. The sampled negative is packed into the positive-item
      stream (pos << 15 | neg) so the scan program keeps exactly THREE xs
      arrays.

    PROGRAM-SHAPE WARNINGS (from the runtime this code was first written
    for, not yet re-validated on the GPU): it kernel-faulted on (a) bitmap
    gathers inside a scan body, (b) epoch scans with a 4th xs array, (c) merged
    2B-row scatters inside the scan, (d) sort-based permutations fused
    with the sampler; and the compiler effectively hangs when the shuffle
    gather consumes the sampler's OUTPUT (shuffle-after-sampling). This
    exact decomposition — input gathers first, sampling second, run as its
    own program before the scan — compiles and runs clean. Do not "clean
    it up" without re-running the bisect harness at MovieLens-20M scale.
    """
    if shuffle:
        key, mkey = jax.random.split(key)
        n_pow2 = tri_ui.shape[0]
        kbits = n_pow2.bit_length() - 1
        idx = _mix_bijection(mkey, n_pow2, kbits)
        ui = tri_ui[idx]
        w = (idx < n_real).astype(jnp.float32)
    else:
        ui = tri_ui
        w = (
            jnp.arange(tri_ui.shape[0], dtype=jnp.int32) < n_real
        ).astype(jnp.float32)
    u = ui[:, 0]
    items = ui[:, 1]
    bitmap = PosBitmap(bitmap_words, wpu)
    neg = jnp.zeros(u.shape, jnp.int32)
    valid = jnp.zeros(u.shape, bool)
    # all rounds' candidates from ONE threefry call (the PRNG is ~a full
    # pass over the stream per call; batching rounds amortizes it)
    key, sub = jax.random.split(key)
    cands = jax.random.randint(
        sub, (neg_rounds,) + u.shape, 0, n_items, dtype=jnp.int32
    )
    for r in range(neg_rounds):
        cand = cands[r]
        cand_ok = ~_is_member_bitmap(bitmap, u, cand)
        take = (~valid) & cand_ok
        neg = jnp.where(take, cand, neg)
        if r == neg_rounds - 1:
            neg = jnp.where(valid | take, neg, cand)
        valid = valid | cand_ok
    packed = (items << _PACK_SHIFT) | neg
    return u, packed, w


@functools.partial(
    jax.jit,
    static_argnames=("use_biases", "batch_size"),
    donate_argnums=(0,),
)
def _sgd_epoch_scan_packed_impl(
    params: BPRParams,
    key: jax.Array,  # threaded through the carry to keep the known-good
    # carry structure of the in-scan-sampling epoch
    users_flat: jax.Array,
    packed_flat: jax.Array,  # (S*B,) pos << 15 | neg
    weights_flat: jax.Array,
    lr: jax.Array,
    user_lambda: jax.Array,
    item_lambda: jax.Array,
    bias_lambda: jax.Array,
    use_biases: bool,
    batch_size: int,
) -> BPRParams:
    """Epoch program 2: the minibatch-SGD scan over presampled triplets."""
    s = users_flat.shape[0] // batch_size
    u_steps = users_flat.reshape(s, batch_size)
    p_steps = packed_flat.reshape(s, batch_size)
    w_steps = weights_flat.reshape(s, batch_size)

    def body(carry, inp):
        params, key = carry
        u, p, w = inp
        pos = p >> _PACK_SHIFT
        neg = p & ((1 << _PACK_SHIFT) - 1)
        params = _sgd_update_body(
            params, u, pos, neg, w, lr, user_lambda, item_lambda,
            bias_lambda, use_biases=use_biases,
        )
        return (params, key), None

    (params, _), _ = jax.lax.scan(
        body, (params, key), (u_steps, p_steps, w_steps)
    )
    return params


def sgd_epoch(
    params: BPRParams,
    key: jax.Array,
    users_flat: jax.Array,
    items_flat: jax.Array,
    weights_flat: jax.Array,
    pos_set: PosSet,
    lr: jax.Array,
    user_lambda: jax.Array,
    item_lambda: jax.Array,
    bias_lambda: jax.Array,
    n_items: int,
    use_biases: bool,
    neg_rounds: int,
    shuffle: bool,
    batch_size: int,
    unroll: bool = False,
    bitmap: Optional[PosBitmap] = None,
    n_real: Optional[int] = None,  # real (unpadded) triplet count
) -> BPRParams:
    """One full training epoch (one or two device programs).

    When a membership bitmap exists and the item space fits the packing
    bound (n_items <= 2**_PACK_SHIFT), negatives are presampled in a
    separate program and packed into the items stream — ~5x cheaper than
    the in-scan CSR rejection search. Otherwise the epoch runs as the
    single program with in-scan CSR sampling.
    """
    n = users_flat.shape[0]
    if (
        bitmap is not None
        and n_items <= (1 << _PACK_SHIFT)
        and n & (n - 1) == 0  # packed path needs the pow2-padded stream
        and n % batch_size == 0
        and n_real is not None
    ):
        key, skey = jax.random.split(key)
        u, packed, w = _sample_pack_impl(
            skey,
            jnp.stack([users_flat, items_flat], axis=1),
            bitmap.words,
            n_items=n_items,
            n_real=n_real,
            neg_rounds=neg_rounds,
            shuffle=shuffle,
            wpu=bitmap.words_per_user,
        )
        return _sgd_epoch_scan_packed_impl(
            params,
            key,
            u,
            packed,
            w,
            lr,
            user_lambda,
            item_lambda,
            bias_lambda,
            use_biases=use_biases,
            batch_size=batch_size,
        )
    # Diagnose the perf cliff: the in-scan CSR path is ~4x slower than the
    # packed presampled path — say which precondition failed.
    reasons = []
    if bitmap is None:
        reasons.append("no membership bitmap (over budget?)")
    if n_items > (1 << _PACK_SHIFT):
        reasons.append(f"n_items={n_items} > {1 << _PACK_SHIFT}")
    if n & (n - 1) != 0:
        reasons.append(f"triplet stream length {n} not a power of two")
    if n % batch_size != 0:
        reasons.append(f"stream length {n} % batch_size {batch_size} != 0")
    if n_real is None:
        reasons.append("n_real not provided")
    reason_key = tuple(reasons)
    if reason_key not in _fallback_logged:
        _fallback_logged.add(reason_key)
        logging.getLogger("qmf_tpu").info(
            "BPR epoch falling back to in-scan CSR sampling (~4x slower "
            "than the packed presampled path): %s", "; ".join(reasons)
        )
    # the in-scan path still needs batch divisibility (the scan reshapes to
    # (steps, batch_size)): pad with zero-weight no-op rows, matching the
    # engine's own stream padding semantics
    pad = (-n) % batch_size
    if pad:
        users_flat = jnp.concatenate(
            [users_flat, jnp.zeros(pad, users_flat.dtype)]
        )
        items_flat = jnp.concatenate(
            [items_flat, jnp.zeros(pad, items_flat.dtype)]
        )
        weights_flat = jnp.concatenate(
            [weights_flat, jnp.zeros(pad, weights_flat.dtype)]
        )
    # NOTE: bitmap_words deliberately NOT forwarded — bitmap membership
    # gathers inside the lax.scan body kernel-faulted the runtime this code
    # was first written for at ML-20M scale.
    # The in-scan sampler uses the known-stable CSR binary search; the
    # bitmap serves only the standalone presample/eval programs.
    return _sgd_epoch_impl(
        params,
        key,
        users_flat,
        items_flat,
        weights_flat,
        pos_set.indptr,
        pos_set.items,
        lr,
        user_lambda,
        item_lambda,
        bias_lambda,
        n_items=n_items,
        use_biases=use_biases,
        neg_rounds=neg_rounds,
        max_degree=pos_set.max_degree,
        shuffle=shuffle,
        batch_size=batch_size,
        unroll=unroll,
        bitmap_words=None,
        wpu=0,
    )


@functools.partial(jax.jit, static_argnames=("use_biases",))
def eval_loss(
    params: BPRParams,
    users: jax.Array,
    pos: jax.Array,
    neg: jax.Array,
    use_biases: bool,
) -> jax.Array:
    """Mean logistic loss log(1+exp(-d)) over a fixed triplet eval set
    (reference BPREngine.cpp:237-239, 246-261)."""
    d, _, _, _ = _score_diff(params, users, pos, neg, use_biases)
    # log1p(exp(-d)) computed stably
    return jnp.mean(jnp.logaddexp(0.0, -d))


def sample_negatives_host(
    rng: np.random.Generator,
    users: np.ndarray,
    pos_users: np.ndarray,
    pos_items: np.ndarray,
    n_items: int,
) -> np.ndarray:
    """Host-side exact rejection sampling (for fixed eval sets).

    Loops until every row is valid — matching the reference's unbounded
    rejection loop (BPREngine-inl.h:48-60); used only at init time. Host
    numpy has real int64, so a flat key is safe here.
    """
    users = users.astype(np.int64)
    key_set = np.unique(
        pos_users.astype(np.int64) * np.int64(n_items)
        + pos_items.astype(np.int64)
    )
    neg = rng.integers(0, n_items, size=len(users))
    while True:
        keys = users * n_items + neg
        pos_idx = np.searchsorted(key_set, keys)
        pos_idx = np.minimum(pos_idx, len(key_set) - 1)
        bad = key_set[pos_idx] == keys if len(key_set) else np.zeros(
            len(users), dtype=bool
        )
        if not bad.any():
            return neg.astype(np.int64)
        neg[bad] = rng.integers(0, n_items, size=int(bad.sum()))
