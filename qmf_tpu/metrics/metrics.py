"""Vectorized ranking/regression metrics (MSE, AUC, AP, P@k, R@k).

Vectorized device replacement for the reference's per-user metric loops
(qmf/metrics/Metrics.cpp): every metric computes for all test users at once
as one device program — a two-key sort (score descending, positives first on
ties, matching the reference's ``std::greater<pair<Double,bool>>``
comparator) followed by cumulative sums — instead of per-user
``std::sort``/``nth_element`` on a thread pool.

Reference edge-case semantics preserved:
- AUC with an empty class returns 1.0 and logs an error
  (Metrics.cpp:80-84).
- P@k / R@k require at least k ranked elements (Metrics.cpp:104,120).
- R@k / AP require at least one positive (Metrics.cpp:129,151).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from qmf_tpu.utils.logging import log


def _ranked_positives(labels: jax.Array, scores: jax.Array) -> jax.Array:
    """Per-row positive indicators ordered by (score desc, positive first).

    labels/scores: (T, I). Returns (T, I) of 0/1 floats in ranked order.
    """
    pos = (labels > 0.0).astype(scores.dtype)
    # lax.sort is ascending lexicographic over the key operands; negate both
    # keys to get score-descending with positives winning ties.
    _, _, ranked = jax.lax.sort(
        (-scores, -pos, pos), dimension=-1, num_keys=2
    )
    return ranked


@jax.jit
def mse_batch(labels: jax.Array, scores: jax.Array) -> jax.Array:
    """Per-user mean squared error (Metrics.cpp:54-63)."""
    return jnp.mean(jnp.square(labels - scores), axis=-1)


@jax.jit
def auc_batch(labels: jax.Array, scores: jax.Array) -> jax.Array:
    """Per-user AUC via ranked true-positive accumulation (Metrics.cpp:65-99).

    Rows where either class is empty yield 1.0 (callers log the error).
    """
    b = _ranked_positives(labels, scores)
    cum = jnp.cumsum(b, axis=-1)
    pos = cum[:, -1]
    neg = b.shape[-1] - pos
    # each negative contributes (#positives ranked before it) / (pos*neg)
    auc = jnp.sum((1.0 - b) * cum, axis=-1) / jnp.maximum(pos * neg, 1.0)
    return jnp.where((pos == 0) | (neg == 0), 1.0, auc)


@functools.partial(jax.jit, static_argnames=("k",))
def precision_at_k_batch(labels: jax.Array, scores: jax.Array, k: int) -> jax.Array:
    """Per-user P@k: positives among the k top-ranked items / k
    (Metrics.cpp:101-117)."""
    b = _ranked_positives(labels, scores)
    return jnp.sum(b[:, :k], axis=-1) / k


@functools.partial(jax.jit, static_argnames=("k",))
def recall_at_k_batch(labels: jax.Array, scores: jax.Array, k: int) -> jax.Array:
    """Per-user R@k: positives among top k / total positives
    (Metrics.cpp:119-137)."""
    b = _ranked_positives(labels, scores)
    total_pos = jnp.sum(b, axis=-1)
    return jnp.sum(b[:, :k], axis=-1) / jnp.maximum(total_pos, 1.0)


@jax.jit
def average_precision_batch(labels: jax.Array, scores: jax.Array) -> jax.Array:
    """Per-user AP: mean over positives of precision at their rank
    (Metrics.cpp:139-164)."""
    b = _ranked_positives(labels, scores)
    cum = jnp.cumsum(b, axis=-1)
    ranks = jnp.arange(1, b.shape[-1] + 1, dtype=cum.dtype)
    total_pos = cum[:, -1]
    ap = jnp.sum(b * cum / ranks, axis=-1)
    return ap / jnp.maximum(total_pos, 1.0)


class Metric:
    """Named metric with the reference's compute-then-average contract.

    ``compute(labels, scores)`` takes (T, I) label/score matrices (the dense
    per-test-user rows built by Engine.init_avg_test_data) and returns the
    mean over users — the same contract as the reference's averaged
    ``Metric::compute`` overloads (Metrics.cpp:27-52).
    """

    name = "metric"

    def _batch(self, labels: jax.Array, scores: jax.Array) -> jax.Array:
        raise NotImplementedError

    def _validate(self, labels_np: np.ndarray) -> None:
        pass

    def compute(self, labels, scores) -> float:
        """(T, I) label/score matrices -> mean over users; 1-D inputs are
        treated as a single row (the reference's plain scalar ``compute``
        overload, Metrics.h:30-40)."""
        labels_np = np.asarray(labels)
        if labels_np.ndim == 1:
            labels = labels_np[None, :]
            scores = np.asarray(scores)[None, :]
            labels_np = np.asarray(labels)
        if labels_np.ndim != 2:
            raise ValueError("labels/scores must be (num_users, num_items)")
        if labels_np.shape[0] == 0:
            raise ValueError("need at least one user")
        scores_dev = jnp.asarray(scores)
        labels_dev = jnp.asarray(labels_np, dtype=scores_dev.dtype)
        if labels_dev.shape != scores_dev.shape:
            raise ValueError("labels and scores shapes differ")
        self._validate(labels_np)
        per_user = self._batch(labels_dev, scores_dev)
        return float(jnp.mean(per_user))


class MeanSquaredError(Metric):
    name = "mse"

    def _batch(self, labels, scores):
        return mse_batch(labels, scores)


class AUC(Metric):
    name = "auc"

    def _validate(self, labels_np):
        pos = (labels_np > 0).sum(axis=1)
        if np.any((pos == 0) | (pos == labels_np.shape[1])):
            # reference logs and returns 1.0 for those rows (Metrics.cpp:80-84)
            log.error("AUC needs at least 1 example in each class")

    def _batch(self, labels, scores):
        return auc_batch(labels, scores)


class AveragePrecision(Metric):
    name = "ap"

    def _validate(self, labels_np):
        if np.any((labels_np > 0).sum(axis=1) == 0):
            raise ValueError("AP needs at least 1 positive")

    def _batch(self, labels, scores):
        return average_precision_batch(labels, scores)


class Precision(Metric):
    def __init__(self, k: int):
        self.k = int(k)
        self.name = f"p@{k}"

    def _validate(self, labels_np):
        if labels_np.shape[1] < self.k:
            raise ValueError("P@k needs at least k ranked elements")

    def _batch(self, labels, scores):
        return precision_at_k_batch(labels, scores, self.k)


class Recall(Metric):
    def __init__(self, k: int):
        self.k = int(k)
        self.name = f"r@{k}"

    def _validate(self, labels_np):
        if labels_np.shape[1] < self.k:
            raise ValueError("R@k needs at least k ranked elements")
        if np.any((labels_np > 0).sum(axis=1) == 0):
            raise ValueError("R@k needs at least 1 positive")

    def _batch(self, labels, scores):
        return recall_at_k_batch(labels, scores, self.k)
