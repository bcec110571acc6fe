"""Sharded-WALS tests on a virtual 8-device CPU mesh.

Covers what the reference never tested: its distributed layer had zero test
coverage (SURVEY.md section 4). Here the sharded engine must match the
single-chip engine bit-for-bit in float64 on the same data — the moral
equivalent of the reference's golden standalone-vs-distributed workflow
(reference examples/README.md:4-13), but automated.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qmf_tpu.config import WALSConfig
from qmf_tpu.data.dataset import Dataset
from qmf_tpu.models.wals import WALSEngine
from qmf_tpu.ops import als_ops
from qmf_tpu.parallel import (
    ShardedWALSEngine,
    make_mesh,
    sharded_gramian,
)


def _dataset(seed=0, n_users=60, n_items=35, per_user=9):
    rng = np.random.default_rng(seed)
    users, items, vals = [], [], []
    for u in range(n_users):
        for i in rng.choice(n_items, size=per_user, replace=False):
            users.append(u + 10)
            items.append(i + 20)
            vals.append(float(rng.integers(1, 6)))
    return Dataset(np.array(users), np.array(items), np.array(vals))


class TestMesh:
    def test_eight_virtual_devices(self):
        assert len(jax.devices()) == 8
        mesh = make_mesh()
        assert mesh.size == 8
        mesh4 = make_mesh(4)
        assert mesh4.size == 4

    def test_too_many_devices_raises(self):
        with pytest.raises(ValueError):
            make_mesh(1000)


class TestShardedGramian:
    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    def test_matches_dense(self, n_dev):
        mesh = make_mesh(n_dev)
        rng = np.random.default_rng(0)
        y = jnp.asarray(rng.normal(size=(64, 6)))
        g = sharded_gramian(y, mesh)
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(y).T @ np.asarray(y), rtol=1e-10
        )


@pytest.mark.slow
class TestShardedEngineParity:
    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_matches_single_chip_f64(self, n_dev):
        """Sharded vs single-chip: identical factors after 2 epochs (f64)."""
        ds = _dataset()
        cfg = dict(
            nepochs=2,
            nfactors=5,
            regularization_lambda=0.07,
            confidence_weight=20.0,
            init_seed=1,
            dtype="float64",
        )
        single = WALSEngine(WALSConfig(**cfg))
        single.init(ds)
        single.optimize()

        sharded = ShardedWALSEngine(WALSConfig(**cfg), n_devices=n_dev)
        sharded.init(ds)
        sharded.optimize()

        np.testing.assert_allclose(
            np.asarray(sharded.user_factors)[: single.nusers],
            np.asarray(single.user_factors),
            rtol=1e-9,
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(sharded.item_factors)[: single.nitems],
            np.asarray(single.item_factors),
            rtol=1e-9,
            atol=1e-12,
        )

    def test_factors_actually_sharded_buckets(self):
        """Every bucket's row axis must be divisible by the mesh size."""
        ds = _dataset()
        eng = ShardedWALSEngine(
            WALSConfig(nfactors=4, init_seed=0), n_devices=8
        )
        eng.init(ds)
        for b in eng._user_buckets.row_ids:
            assert b.shape[0] % 8 == 0
        # bucket tensors carry a sharded layout across 8 devices
        first = eng._user_buckets.col_idx[0]
        assert len(first.sharding.device_set) == 8

    def test_fused_epoch_outputs_stay_row_sharded(self):
        """After optimize() (fused whole-epoch path), both factor matrices
        must carry the explicit row-sharded layout over all 8 devices — the
        layout the next epoch's all-gather analysis and the multi-host data
        path depend on."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        ds = _dataset(seed=1)
        eng = ShardedWALSEngine(
            WALSConfig(nepochs=1, nfactors=4, init_seed=0), n_devices=8
        )
        eng.init(ds)
        assert eng.config.fuse_epoch  # the path under test
        eng.optimize()
        expect = NamedSharding(eng.mesh, P(eng.axis_name, None))
        for arr in (eng.user_factors, eng.item_factors):
            assert len(arr.sharding.device_set) == 8
            assert arr.sharding.is_equivalent_to(expect, arr.ndim), (
                arr.sharding
            )
            # row axis really divides over the mesh
            assert arr.shape[0] % 8 == 0

    @pytest.mark.parametrize("n_dev", [2, 8])
    def test_fused_run_matches_per_epoch(self, n_dev):
        """Whole-run fusion (one lax.scan program for all epochs) must be
        f64-identical to per-epoch fused dispatches on the same mesh, and
        leave the factors row-sharded."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        ds = _dataset(seed=5)
        cfg = dict(nepochs=3, nfactors=4, init_seed=2, dtype="float64")

        fused = ShardedWALSEngine(WALSConfig(**cfg), n_devices=n_dev)
        fused.init(ds)
        assert fused._can_fuse_run()
        fused.optimize()

        stepped = ShardedWALSEngine(WALSConfig(**cfg), n_devices=n_dev)
        stepped.init(ds)
        for _ in range(3):
            stepped._fused_epoch()

        np.testing.assert_allclose(
            np.asarray(fused.user_factors),
            np.asarray(stepped.user_factors),
            rtol=1e-12,
            atol=1e-14,
        )
        np.testing.assert_allclose(
            np.asarray(fused.item_factors),
            np.asarray(stepped.item_factors),
            rtol=1e-12,
            atol=1e-14,
        )
        expect = NamedSharding(fused.mesh, P(fused.axis_name, None))
        for arr in (fused.user_factors, fused.item_factors):
            assert arr.sharding.is_equivalent_to(expect, arr.ndim)

    def test_loss_matches(self):
        ds = _dataset(seed=3)
        cfg = dict(nepochs=1, nfactors=4, init_seed=2, dtype="float64")
        single = WALSEngine(WALSConfig(**cfg))
        single.init(ds)
        single._iterate("user")
        loss_single = single._iterate("item")

        sharded = ShardedWALSEngine(WALSConfig(**cfg), n_devices=4)
        sharded.init(ds)
        sharded._iterate("user")
        loss_sharded = sharded._iterate("item")
        assert loss_sharded == pytest.approx(loss_single, rel=1e-9)
