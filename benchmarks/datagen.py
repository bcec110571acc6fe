"""Deterministic synthetic MovieLens-like ratings generation.

The environment has no network access, so the BASELINE.md harness configs
(MovieLens-100K / MovieLens-20M) are stood in for by seeded synthetic
datasets matching their scale and shape statistics:

- ml100k: 943 users x 1,682 items, ~100k ratings (every user >= 20)
- ml20m: 138,493 users x 26,744 items, ~20M ratings, power-law degrees

Both the reference binaries and qmf_tpu are measured on the *same files*,
so relative numbers are apples-to-apples.
"""

from __future__ import annotations

import os

import numpy as np


def _zipf_item_probs(n_items: int, a: float = 1.1) -> np.ndarray:
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def generate(
    n_users: int,
    n_items: int,
    target_nnz: int,
    seed: int = 0,
    min_degree: int = 20,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Power-law user degrees, zipf item popularity, 0.5..5.0 ratings."""
    rng = np.random.default_rng(seed)
    # user degrees: lognormal, clipped, oversampled to survive dedup of
    # with-replacement zipf sampling, then trimmed back to target_nnz
    oversample = 2.5
    raw = rng.lognormal(mean=0.0, sigma=1.1, size=n_users)
    degrees = np.maximum(
        min_degree, raw / raw.mean() * (oversample * target_nnz / n_users)
    )
    degrees = np.minimum(degrees, n_items * 0.8).astype(np.int64)

    item_p = _zipf_item_probs(n_items)
    users = np.repeat(np.arange(n_users, dtype=np.int64), degrees)
    items = rng.choice(n_items, size=len(users), p=item_p)
    # dedup (user, item) pairs
    keys = users * np.int64(n_items) + items
    _, first = np.unique(keys, return_index=True)
    if len(first) > target_nnz:
        first = rng.choice(first, size=target_nnz, replace=False)
    first.sort()
    users, items = users[first], items[first]
    values = rng.integers(1, 11, size=len(users)) * 0.5
    return users + 1, items + 1, values


def write_ratings(path: str, users, items, values) -> None:
    """Write the reference text format fast via one big formatted buffer."""
    arr = np.stack(
        [users.astype(np.float64), items.astype(np.float64), values], axis=1
    )
    with open(path, "w") as f:
        np.savetxt(f, arr, fmt=["%d", "%d", "%.1f"])


PRESETS = {
    "ml100k": dict(n_users=943, n_items=1682, target_nnz=100_000),
    "ml1m": dict(n_users=6040, n_items=3706, target_nnz=1_000_000),
    "ml20m": dict(n_users=138_493, n_items=26_744, target_nnz=20_000_000),
    # large-catalog BPR scale check: the 200k x 100k id space puts the
    # exact positive bitmap at 2.5 GB (>> the 1 GiB budget), forcing the
    # blocked-Bloom membership path (ops/bpr_ops.py PosBloom)
    "synth100k": dict(n_users=200_000, n_items=100_000, target_nnz=20_000_000),
}


# Generated data lives inside the checkout (listed in .gitignore), so the
# scripts read and write nothing outside it.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench_data"
)


def _ensure_npz(preset: str, cache_dir: str) -> str:
    """Generate (once) and return the path of a preset's arrays (.npz)."""
    os.makedirs(cache_dir, exist_ok=True)
    npz = os.path.join(cache_dir, f"{preset}.npz")
    if not os.path.exists(npz):
        users, items, values = generate(**PRESETS[preset], seed=42)
        tmp = npz + ".tmp.npz"
        np.savez(tmp, users=users, items=items, values=values)
        os.replace(tmp, npz)
    return npz


def ensure_dataset(preset: str, cache_dir: str = DEFAULT_CACHE_DIR) -> str:
    """Generate (once) and return the path of a preset's ratings text file
    (the reference binaries' and the CLIs' input format)."""
    path = os.path.join(cache_dir, f"{preset}.txt")
    if not os.path.exists(path):
        users, items, values = load_npz(preset, cache_dir)
        write_ratings(path, users, items, values)
    return path


def load_npz(preset: str, cache_dir: str = DEFAULT_CACHE_DIR):
    d = np.load(_ensure_npz(preset, cache_dir))
    return d["users"], d["items"], d["values"]


if __name__ == "__main__":
    import sys

    preset = sys.argv[1] if len(sys.argv) > 1 else "ml100k"
    p = ensure_dataset(preset)
    print(p)
