"""Serving-side top-N recommendation from trained factors.

The reference stops at saving factor files; serving is left to the caller.
This module closes that gap on the device: score = bias + <p_u, q_i> as one
matmul over a batch of users, ``jax.lax.top_k`` for the head, and an
optional exclusion of already-seen items (scores pushed to -inf via the
same CSR positive-set structure BPR uses for membership).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qmf_tpu.ops import als_ops
from qmf_tpu.ops.bpr_ops import PosSet, _is_member


@functools.partial(
    jax.jit, static_argnames=("n", "exclude_seen", "max_degree")
)
def _topn_impl(
    user_factors: jax.Array,  # (B, k) factors of the query users
    item_factors: jax.Array,  # (I, k)
    item_biases: Optional[jax.Array],
    users: Optional[jax.Array],  # (B,) dense user indices (for exclusion)
    indptr: Optional[jax.Array],
    set_items: Optional[jax.Array],
    n: int,
    exclude_seen: bool,
    max_degree: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    scores = als_ops.compute_scores(
        user_factors, item_factors, item_biases=item_biases
    )
    if exclude_seen:
        pos_set = PosSet(indptr, set_items, max_degree)
        item_ids = jnp.arange(scores.shape[1], dtype=jnp.int32)
        # (B, I) membership mask via vmapped binary search over columns
        seen = jax.vmap(
            lambda u: _is_member(
                pos_set, jnp.full_like(item_ids, u), item_ids
            )
        )(users)
        scores = jnp.where(seen, -jnp.inf, scores)
    top_scores, top_idx = jax.lax.top_k(scores, n)
    return top_idx, top_scores


def recommend_top_n(
    user_factors,
    item_factors,
    user_idx,
    n: int = 10,
    item_biases=None,
    seen: Optional[PosSet] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-n item indices + scores for the given dense user indices.

    ``seen`` (a :class:`PosSet`, e.g. built from the training ratings)
    excludes already-interacted items.
    """
    user_idx = jnp.asarray(np.asarray(user_idx, dtype=np.int32))
    uf = jnp.asarray(user_factors)[user_idx]
    itf = jnp.asarray(item_factors)
    ib = jnp.asarray(item_biases) if item_biases is not None else None
    if seen is not None:
        idx, sc = _topn_impl(
            uf, itf, ib, user_idx, seen.indptr, seen.items, n=n,
            exclude_seen=True, max_degree=seen.max_degree,
        )
    else:
        idx, sc = _topn_impl(
            uf, itf, ib, None, None, None, n=n, exclude_seen=False
        )
    return np.asarray(idx), np.asarray(sc)
