"""The backend policy, the GPU solve path, the compile-cache rule and the
per-card worker pinning.

Runs on the CPU (the backend is mocked where a test needs the GPU's
policy); the ``gpu``-marked tests compile on the card and are run there by
chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from qmf_tpu.ops import als_ops, linalg
from qmf_tpu.utils import platform


def _random_spd(bsz: int, k: int, seed: int = 0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(bsz, k, k))
    a = m @ m.transpose(0, 2, 1) + 0.1 * np.eye(k)
    b = rng.normal(size=(bsz, k))
    return a.astype(dtype), b.astype(dtype)


def _solve64(a, b):
    return np.linalg.solve(
        a.astype(np.float64), b.astype(np.float64)[..., None]
    )[..., 0]


class TestPlatformPolicy:
    @pytest.mark.parametrize("backend", ["gpu", "cpu"])
    def test_supported_backends(self, monkeypatch, backend):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        assert platform.backend() == backend
        on_gpu = backend == "gpu"
        assert platform.auto_solver(jnp.float32) == (
            "cholesky_xla" if on_gpu else "cholesky")
        assert platform.auto_device_pack(jnp.float32) is on_gpu
        assert platform.auto_hot_split(jnp.float32) is on_gpu
        # f64 golden runs keep the plain paths on every backend
        assert platform.auto_solver(jnp.float64) == "cholesky"
        assert platform.auto_device_pack(jnp.float64) is False

    @pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
    def test_unknown_backend_raises(self, monkeypatch, backend):
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            platform.backend()
        with pytest.raises(RuntimeError):
            platform.auto_solver(jnp.float32)

    def test_engines_resolve_auto_through_policy(self, monkeypatch):
        """WALSEngine and ShardedWALSEngine pick the cuSOLVER path under a
        mocked GPU backend and the blocked Cholesky on the CPU."""
        from qmf_tpu.config import WALSConfig
        from qmf_tpu.models.wals import WALSEngine
        from qmf_tpu.parallel import ShardedWALSEngine, make_mesh

        single = WALSEngine(WALSConfig())
        sharded = ShardedWALSEngine(WALSConfig(), mesh=make_mesh(2))
        for eng in (single, sharded):
            assert eng._auto_solver() == "cholesky"
            assert eng._use_device_pack() is False
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        for eng in (single, sharded):
            assert eng._auto_solver() == "cholesky_xla"
            assert eng._use_device_pack() is True
        assert WALSEngine(WALSConfig(dtype="float64"))._auto_solver() == (
            "cholesky")

    def test_hot_width_auto_is_zero_off_the_gpu(self, monkeypatch):
        from qmf_tpu.config import WALSConfig
        from qmf_tpu.models.wals import WALSEngine

        deg = (1e6 / np.arange(1, 20_001) ** 1.1).astype(np.int64) + 1
        eng = WALSEngine(WALSConfig(nfactors=64))
        assert eng._resolve_hot_width(deg, 100_000) == 0
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert eng._resolve_hot_width(deg, 100_000) > 0
        monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
        with pytest.raises(RuntimeError):
            eng._resolve_hot_width(deg, 100_000)


class TestCompileCacheDir:
    def test_env_dir_wins(self, monkeypatch, tmp_path):
        from qmf_tpu.cli import common

        monkeypatch.delenv("QMF_TPU_NO_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert common.compilation_cache_dir() == str(tmp_path)

    def test_default_is_fixed_inside_checkout(self, monkeypatch):
        import os

        from qmf_tpu.cli import common

        monkeypatch.delenv("QMF_TPU_NO_COMPILE_CACHE", raising=False)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = common.compilation_cache_dir()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")

    def test_opt_out(self, monkeypatch, tmp_path):
        from qmf_tpu.cli import common

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.setenv("QMF_TPU_NO_COMPILE_CACHE", "1")
        assert common.compilation_cache_dir() is None


class TestWorkerPinning:
    def test_each_worker_sees_its_own_card(self):
        from qmf_tpu.distributed.scheduler import worker_env

        base = {"CUDA_VISIBLE_DEVICES": "0,1,2,3", "PATH": "/bin"}
        seen = [worker_env(p, 0, base)["CUDA_VISIBLE_DEVICES"]
                for p in range(4)]
        assert seen == ["0", "1", "2", "3"]
        assert worker_env(2, 0, base)["PATH"] == "/bin"
        # a parent restricted to some cards hands out only those
        sub = {"CUDA_VISIBLE_DEVICES": "2,3"}
        assert [worker_env(p, 0, sub)["CUDA_VISIBLE_DEVICES"]
                for p in range(2)] == ["2", "3"]

    def test_virtual_cpu_workers_and_cardless_hosts_unpinned(self):
        from qmf_tpu.distributed.scheduler import worker_env

        base = {"CUDA_VISIBLE_DEVICES": "0,1"}
        assert worker_env(1, 4, base) == base
        cardless = {"CUDA_VISIBLE_DEVICES": ""}
        assert worker_env(1, 0, cardless) == cardless

    def test_local_quorum_larger_than_cards_refused(self):
        from qmf_tpu.distributed.scheduler import check_local_quorum

        check_local_quorum(2, 0, cards=["0", "1"])
        check_local_quorum(8, 4, cards=["0"])  # virtual CPU workers
        check_local_quorum(3, 0, cards=[])  # no cards: nothing to share
        with pytest.raises(RuntimeError, match="card of its own"):
            check_local_quorum(3, 0, cards=["0", "1"])


class TestSolvePaths:
    """Every solver the policy can pick, against float64 numpy."""

    @pytest.mark.parametrize("solver", ["cholesky_xla", "cholesky", "lu"])
    @pytest.mark.parametrize("k", [8, 30, 64])
    def test_dispatch_matches_float64(self, solver, k):
        a, b = _random_spd(24, k, seed=k)
        x = np.asarray(als_ops._solve_dispatch(
            jnp.asarray(a), jnp.asarray(b), solver))
        np.testing.assert_allclose(x, _solve64(a, b), rtol=2e-4, atol=2e-4)

    def test_cholesky_xla_matches_blocked(self):
        a, b = _random_spd(32, 64, seed=3)
        x_xla = np.asarray(als_ops._solve_spd_xla(jnp.asarray(a),
                                                  jnp.asarray(b)))
        x_blk = np.asarray(linalg.solve_spd(jnp.asarray(a), jnp.asarray(b)))
        # both are f32 with different accumulation orders
        np.testing.assert_allclose(x_xla, x_blk, rtol=2e-3, atol=2e-4)

    @pytest.mark.parametrize("block", [8, 16, 32])
    def test_blocked_sizes_agree(self, block):
        a, b = _random_spd(8, 48, seed=block)
        x = np.asarray(linalg.solve_spd(jnp.asarray(a), jnp.asarray(b),
                                        block=block))
        np.testing.assert_allclose(x, _solve64(a, b), rtol=2e-4, atol=2e-4)

    def test_unknown_solver_rejected(self):
        from qmf_tpu.config import WALSConfig
        from qmf_tpu.data.dataset import Dataset
        from qmf_tpu.models.wals import WALSEngine

        ds = Dataset(np.array([1, 2]), np.array([1, 2]), np.array([1., 1.]))
        for name in ("fused", "pallas", "nope"):
            with pytest.raises(ValueError, match="unknown WALS solver"):
                WALSEngine(WALSConfig(solver=name)).init(ds)


@pytest.mark.gpu
class TestOnCard:
    """Compiled on the card; skipped without a GPU."""

    @pytest.mark.parametrize("k", [30, 64])
    def test_gpu_solve_matches_float64(self, gpu, k):
        a, b = _random_spd(1000, k, seed=k)
        solver = platform.auto_solver(jnp.float32)
        x = np.asarray(jax.jit(
            lambda a, b: als_ops._solve_dispatch(a, b, solver)
        )(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(x, _solve64(a, b), rtol=2e-4, atol=2e-4)

    def test_auto_policy_on_card(self, gpu):
        assert platform.backend() == "gpu"
        assert platform.auto_solver(jnp.float32) == "cholesky_xla"
        assert platform.auto_solver(jnp.float64) == "cholesky"
