"""Hot/cold split build tests (ops/hot.py).

The split moves the contribution of the H hottest fixed-side columns from
per-entry factor-row gathers onto dense GEMMs against static weight
matrices. It must be mathematically identical to the unsplit build (the
reference accumulates the same per-signal terms in a different order,
qmf/wals/WALSEngine.cpp:266-310), so the oracle here is the unsplit engine
itself at float64.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from qmf_tpu.config import WALSConfig
from qmf_tpu.data.dataset import Dataset
from qmf_tpu.models.wals import WALSEngine
from qmf_tpu.ops import hot as hot_ops


def _zipf_dataset(rng, n_users=60, n_items=40, nnz=600):
    """Synthetic power-law dataset: column popularity ~ Zipf."""
    ranks = np.arange(1, n_items + 1)
    p = (1.0 / ranks) / (1.0 / ranks).sum()
    pairs = set()
    while len(pairs) < nnz:
        u = int(rng.integers(n_users))
        i = int(rng.choice(n_items, p=p))
        pairs.add((u, i))
    pairs = sorted(pairs)
    users = np.array([p[0] for p in pairs]) + 1
    items = np.array([p[1] for p in pairs]) + 1
    vals = rng.uniform(0.5, 5.0, size=len(pairs)).round(1)
    return Dataset(users, items, vals)


def _train(dataset, hot_width, device_pack=False, nepochs=3, **kw):
    cfg = WALSConfig(
        nepochs=nepochs,
        nfactors=8,
        regularization_lambda=0.05,
        confidence_weight=4.0,
        init_distribution_bound=0.1,
        dtype="float64",
        solver="cholesky",
        hot_width=hot_width,
        device_pack=device_pack,
        init_seed=7,
        **kw,
    )
    eng = WALSEngine(cfg)
    eng.init(dataset)
    eng.optimize()
    return eng


class TestHotHelpers:
    def test_top_hot_columns_orders_by_degree(self):
        deg = np.array([3, 9, 1, 7, 7, 0])
        ids = hot_ops.top_hot_columns(deg, 3)
        assert ids[0] == 1
        assert set(ids.tolist()) == {1, 3, 4}
        assert len(hot_ops.top_hot_columns(deg, 0)) == 0
        # h larger than n_cols clamps
        assert len(hot_ops.top_hot_columns(deg, 99)) == 6

    def test_rank_lookup_roundtrip(self):
        deg = np.array([3, 9, 1, 7, 5])
        ids = hot_ops.top_hot_columns(deg, 2)
        rank = hot_ops.rank_lookup(ids, 5)
        assert rank[ids[0]] == 0 and rank[ids[1]] == 1
        cold = np.setdiff1d(np.arange(5), ids)
        assert (rank[cold] == 2).all()

    def test_auto_hot_width_flat_distribution_returns_zero(self):
        # a perfectly flat distribution has no head worth splitting
        deg = np.full(100_000, 200, dtype=np.int64)
        assert hot_ops.auto_hot_width(deg, 100_000, 64) == 0

    def test_auto_hot_width_powerlaw_picks_nonzero(self):
        # extreme head: 10 columns own 90% of 100M entries
        deg = np.full(200_000, 50, dtype=np.int64)
        deg[:10] = 9_000_000
        h = hot_ops.auto_hot_width(deg, 500_000, 64)
        assert h >= 256


@pytest.mark.slow
class TestHotSplitParity:
    """Split vs unsplit engines must produce near-identical f64 factors."""

    def test_host_pack_split_matches_unsplit(self):
        rng = np.random.default_rng(3)
        ds = _zipf_dataset(rng)
        base = _train(ds, hot_width=0)
        split = _train(ds, hot_width=6)
        np.testing.assert_allclose(
            np.asarray(split.user_factors), np.asarray(base.user_factors),
            rtol=1e-9, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(split.item_factors), np.asarray(base.item_factors),
            rtol=1e-9, atol=1e-12,
        )

    def test_device_pack_split_matches_unsplit(self):
        rng = np.random.default_rng(4)
        ds = _zipf_dataset(rng)
        base = _train(ds, hot_width=0)
        split = _train(ds, hot_width=6, device_pack=True)
        np.testing.assert_allclose(
            np.asarray(split.user_factors), np.asarray(base.user_factors),
            rtol=1e-9, atol=1e-12,
        )

    def test_split_loss_matches_unsplit(self, caplog):
        rng = np.random.default_rng(5)
        ds = _zipf_dataset(rng)
        base = _train(ds, hot_width=0, fuse_epoch=False, nepochs=2)
        split = _train(ds, hot_width=8, fuse_epoch=False, nepochs=2)
        # engines expose the last train loss only via logs; compare factors
        # (which the loss is a function of) plus explicit per-epoch losses
        b = base._iterate("item")
        s = split._iterate("item")
        assert abs(b - s) < 1e-9

    def test_all_hot_rows_still_get_solved(self):
        # a user whose every item is hot must still land in a (fully
        # masked) width class and receive a correct solve
        users = np.array([1, 1, 2, 2, 3])
        items = np.array([1, 2, 1, 2, 1])
        vals = np.array([1.0, 2.0, 3.0, 1.0, 2.0])
        ds = Dataset(users, items, vals)
        base = _train(ds, hot_width=0, nepochs=2)
        # hot width 2 covers items {1,2} = EVERY entry -> cold stream empty
        split = _train(ds, hot_width=2, nepochs=2)
        np.testing.assert_allclose(
            np.asarray(split.user_factors), np.asarray(base.user_factors),
            rtol=1e-9, atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(split.item_factors), np.asarray(base.item_factors),
            rtol=1e-9, atol=1e-12,
        )

    def test_unfused_iterate_path(self):
        rng = np.random.default_rng(6)
        ds = _zipf_dataset(rng, n_users=30, n_items=20, nnz=200)
        base = _train(ds, hot_width=0, fuse_epoch=False)
        split = _train(ds, hot_width=5, fuse_epoch=False)
        np.testing.assert_allclose(
            np.asarray(split.user_factors), np.asarray(base.user_factors),
            rtol=1e-9, atol=1e-12,
        )
