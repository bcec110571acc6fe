"""Drive qmf_tpu's main path once on an NVIDIA GPU and check what comes out.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: the sharded engines only

Phases (one card), each timed (init / compile, i.e. first epoch or call /
steady) and printed beside the card's name and power limit:

1. Device: the default JAX backend is the GPU; the card-only tests
   (pytest marker ``gpu``) pass in a child process that exits before this
   process opens the card.
2. The solve solver="auto" picks on the GPU (cuSOLVER through XLA) vs
   the plain references: WALS-like normal equations at k=30/64/128,
   compared with float64 numpy, and at k=64 with linalg.solve_spd.
3. WALS on the MovieLens-20M-shaped catalog (benchmarks/datagen.py
   "ml20m", seed 42) at k=64 through WALSEngine (init, init_test,
   optimize), 3 epochs at matmul_precision "highest" and "default" with
   solver="auto": loss finite and not rising, test AUC within 1e-3 of the
   solver="cholesky" + "highest" run; factors saved and read back.
4. BPR on ml20m at k=30, 3 negatives, batch 32768 (grouped path), 2
   epochs: finite, and test AUC above its value at init.
5. Top-N for the first 1,000 users through ``qmf_tpu.cli.recommend``
   (--exclude_seen) on the phase-3 factors, against a float64 numpy
   argsort: equal up to ties.

``--four`` runs only the sharded WALS (k=64, 3 epochs) and BPR (k=30, 2
epochs) at ml20m over make_mesh(4) beside the same runs on one card, and
the float64 sharded-vs-single parity of __graft_entry__.dryrun_multichip.

Any failed check raises, and the script exits non-zero without printing
its result line. The last line of standard output is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

import datagen  # noqa: E402
from qmf_tpu.cli.common import enable_compilation_cache  # noqa: E402

AUC_BOUND = 1e-3  # the repo's acceptance bound (benchmarks/auc_parity.py)
SOLVE_TOL = 2e-4  # rtol = atol at k <= 64 (tests/test_platform.py)
# k=128: float32 Cholesky error grows with the width and the condition
# number (backward error ~ k * eps * cond); both solvers stay near 1e-4
# relative, so the bound is 1e-3 — still far below what changes a
# recommendation.
SOLVE_TOL_K128 = 1e-3
N_TOPN_USERS = 1000
TOPN = 10
NUM_TEST_USERS = 10_000


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


class Phase:
    """Times and reports one phase; a failure propagates (no phase catches
    its own exception)."""

    def __init__(self, name: str, card: str):
        self.name, self.card = name, card
        self.times: dict = {}

    @contextlib.contextmanager
    def timed(self, what: str):
        t0 = time.perf_counter()
        yield
        self.times[what] = time.perf_counter() - t0

    def __enter__(self):
        print(f"== phase {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            parts = " ".join(f"{k}={v:.2f}s" for k, v in self.times.items())
            print(
                f"== phase {self.name} OK in "
                f"{time.perf_counter() - self.t0:.1f}s [{parts}] "
                f"({self.card})",
                flush=True,
            )
        return False


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# --- phase 1 -----------------------------------------------------------------


def run_card_tests() -> None:
    """Run the ``gpu``-marked tests in a child with the card to itself."""
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "gpu.xml")
        env = {**os.environ, "JAX_PLATFORMS": "cuda"}
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
             "-p", "no:cacheprovider", f"--junitxml={xml}", "tests/"],
            cwd=REPO, env=env, capture_output=True, text=True,
        )
        print(proc.stdout[-2000:], flush=True)
        check(proc.returncode == 0,
              f"card-only tests failed:\n{proc.stderr[-2000:]}")
        import xml.etree.ElementTree as ET

        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n, skipped = int(suite.get("tests")), int(suite.get("skipped"))
        check(n > 0 and skipped == 0,
              f"card-only tests: {n} collected, {skipped} skipped")
        print(f"card-only tests: {n} passed", flush=True)


def phase_device(card: str, card_tests: bool = True):
    import jax

    with Phase("1 device", card) as ph:
        print(f"nvidia-smi: {card}", flush=True)
        if card_tests:
            with ph.timed("card_tests"):
                run_card_tests()
        with ph.timed("backend_init"):
            backend = jax.default_backend()
        check(backend == "gpu", f"default JAX backend is {backend!r}")
        dev = jax.devices()[0]
        print(f"device_kind: {dev.device_kind}; {len(jax.devices())} "
              "device(s)", flush=True)
    return dev


# --- phase 2 -----------------------------------------------------------------


def normal_equations(n: int, k: int, n_cols: int = 26_744, d: int = 32,
                     seed: int = 0):
    """WALS-like (A, b) on device: YtY + lam I + sum_d alpha r y y^T,
    built at precision HIGHEST (benchmarks/solver_micro.py's recipe)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def build(key):
        ky, kc, kr = jax.random.split(key, 3)
        y = 0.1 * jax.random.normal(ky, (n_cols, k), jnp.float32)
        col = jax.random.randint(kc, (n, d), 0, n_cols)
        w = 40.0 * jax.random.randint(kr, (n, d), 1, 11) * 0.5
        yg = y[col]
        hp = jax.lax.Precision.HIGHEST
        a = (jnp.matmul(y.T, y, precision=hp)[None]
             + jnp.einsum("bdk,bd,bdl->bkl", yg, w, yg, precision=hp)
             + 0.05 * jnp.eye(k, dtype=jnp.float32))
        b = jnp.einsum("bd,bdk->bk", 1.0 + w, yg, precision=hp)
        return a, b

    return build(jax.random.PRNGKey(seed))


def phase_solve(card: str) -> None:
    import jax
    import jax.numpy as jnp

    from qmf_tpu.ops import als_ops, linalg
    from qmf_tpu.utils import platform

    solver = platform.auto_solver(jnp.float32)
    auto = jax.jit(lambda a, b: als_ops._solve_dispatch(a, b, solver))
    plain = jax.jit(linalg.solve_spd)
    with Phase(f"2 solve ({solver}) vs references", card) as ph:
        # (systems, k): the ml20m user side's padded count at k=64, a
        # float64-checkable slice at every width; k=30 is WALS's default
        for n, k in ((4096, 30), (138_496, 64), (4096, 128)):
            a, b = normal_equations(n, k)
            with ph.timed(f"compile_k{k}"):
                x = jax.block_until_ready(auto(a, b))
            with ph.timed(f"steady_k{k}"):
                x = jax.block_until_ready(auto(a, b))
            x = np.asarray(x)
            check(x.shape == (n, k) and np.isfinite(x).all(),
                  f"solve output at k={k}: shape {x.shape} or non-finite")
            m = 4096
            a64 = np.asarray(a[:m], np.float64)
            b64 = np.asarray(b[:m], np.float64)
            x64 = np.linalg.solve(a64, b64[..., None])[..., 0]
            tol = SOLVE_TOL if k <= 64 else SOLVE_TOL_K128
            np.testing.assert_allclose(
                x[:m], x64, rtol=tol, atol=tol,
                err_msg=f"{solver} vs float64 numpy at k={k}")
            if k == 64:  # the unrolled reference compiles per shape
                np.testing.assert_allclose(
                    x, np.asarray(plain(a, b)), rtol=2e-3, atol=tol,
                    err_msg=f"{solver} vs linalg.solve_spd at k={k}")
            err = np.abs(x[:m] - x64).max() / np.abs(x64).max()
            print(f"k={k}: {n} systems, max rel err vs float64 {err:.2e}",
                  flush=True)
            del a, b


# --- phases 3-5 --------------------------------------------------------------


def ml20m_split(seed: int = 42):
    """The ml20m catalog with a seeded 10% holdout of ratings as test."""
    from qmf_tpu.data.dataset import Dataset

    users, items, values = datagen.load_npz("ml20m")
    test = np.random.default_rng(seed).random(len(users)) < 0.1
    train = Dataset(users[~test], items[~test], values[~test])
    held = Dataset(users[test], items[test], values[test])
    return train, held


def auc_metrics():
    from qmf_tpu.config import MetricsConfig
    from qmf_tpu.metrics.engine import MetricsEngine

    me = MetricsEngine(MetricsConfig(num_test_users=NUM_TEST_USERS,
                                     always_compute=True))
    check(me.add_test_avg_metric("auc"), "auc metric not registered")
    return me


def run_wals(train, test, ph, label, engine_cls=None, **cfg_kw):
    """init -> init_test -> optimize; returns (engine, losses, auc)."""
    from qmf_tpu.config import WALSConfig
    from qmf_tpu.models.wals import WALSEngine

    engine_cls = engine_cls or WALSEngine
    me = auc_metrics()
    cfg = WALSConfig(nepochs=3, nfactors=64, init_seed=0, **cfg_kw)
    eng = engine_cls(cfg, metrics_engine=me)
    epochs = []
    eng.progress_cb = lambda e, loss, dt: epochs.append((loss, dt))
    with ph.timed(f"{label}_init"):
        eng.init(train)
        eng.init_test(test)
    with ph.timed(f"{label}_optimize"):
        eng.optimize()
    losses = [loss for loss, _ in epochs]
    times = [dt for _, dt in epochs]
    ph.times[f"{label}_compile"] = times[0]
    ph.times[f"{label}_steady"] = float(np.median(times[1:]))
    auc = me.last("test_avg_auc")[1]
    print(f"{label}: solver={eng._solver} losses={losses} "
          f"epoch_s={[round(t, 4) for t in times]} test_auc={auc:.6f}",
          flush=True)
    check(len(losses) == cfg.nepochs and np.isfinite(losses).all(),
          f"{label}: non-finite or missing losses {losses}")
    check(all(b <= a * (1 + 1e-6) for a, b in zip(losses, losses[1:])),
          f"{label}: loss rose {losses}")
    return eng, losses, auc


def phase_wals(card: str, train, test, tmp: str):
    from qmf_tpu.data import load_factors

    with Phase("3 WALS ml20m k=64", card) as ph:
        eng, _, ref_auc = run_wals(train, test, ph, "ref_cholesky_highest",
                                   solver="cholesky",
                                   matmul_precision="highest")
        del eng
        gc.collect()
        saved = None
        for precision in ("highest", "default"):
            eng, _, auc = run_wals(train, test, ph, f"auto_{precision}",
                                   matmul_precision=precision)
            check(abs(auc - ref_auc) <= AUC_BOUND,
                  f"auto/{precision} AUC {auc:.6f} vs cholesky/highest "
                  f"{ref_auc:.6f}")
            if saved is None:
                paths = (os.path.join(tmp, "user.dat"),
                         os.path.join(tmp, "item.dat"))
                with ph.timed("save_factors"):
                    eng.save_user_factors(paths[0])
                    eng.save_item_factors(paths[1])
                for path, dev in zip(paths,
                                     (eng.user_factors, eng.item_factors)):
                    _, fd = load_factors(path)
                    np.testing.assert_allclose(
                        fd.factors, np.asarray(dev, np.float64),
                        rtol=1e-6, atol=1e-8,
                        err_msg=f"{path} did not read back")
                saved = paths
            del eng
            gc.collect()
    return saved


class _EpochTimes(logging.Handler):
    """Collects the BPR engine's per-epoch wall times from its log line."""

    def __init__(self):
        super().__init__()
        self.times = []

    def emit(self, record):
        if str(record.msg).startswith("epoch %d: train loss"):
            self.times.append(float(record.args[-1]))


def phase_bpr(card: str, train, test, engine_cls=None, label="bpr",
              ph=None, check_learns=True, **engine_kw):
    """BPR through init -> init_test -> optimize; with ``check_learns``
    the test AUC must rise above its value at init."""
    from qmf_tpu.config import BPRConfig
    from qmf_tpu.models.bpr import BPREngine
    from qmf_tpu.utils.logging import log

    engine_cls = engine_cls or BPREngine
    own = ph is None
    ctx = (Phase("4 BPR ml20m k=30", card) if own
           else contextlib.nullcontext(ph))
    with ctx as ph:
        me = auc_metrics()
        cfg = BPRConfig(nepochs=2, nfactors=30, num_negative_samples=3,
                        batch_size=32768, init_seed=0)
        eng = engine_cls(cfg, metrics_engine=me, **engine_kw)
        with ph.timed(f"{label}_init"):
            eng.init(train)
            eng.init_test(test)
        check(eng._grouped, f"{label}: not on the grouped path")
        auc0 = float("nan")
        if check_learns:
            eng.evaluate(0)
            auc0 = me.last("test_avg_auc")[1]
        handler = _EpochTimes()
        log.addHandler(handler)
        try:
            with ph.timed(f"{label}_optimize"):
                eng.optimize()
        finally:
            log.removeHandler(handler)
        ph.times[f"{label}_compile"] = handler.times[0]
        ph.times[f"{label}_steady"] = handler.times[-1]
        auc = me.last("test_avg_auc")[1]
        print(f"{label}: test_auc init {auc0:.6f} -> {auc:.6f}, "
              f"epoch_s={handler.times}, real triplets/epoch "
              f"{int(eng._n_real_triplets)}", flush=True)
        for arr in (eng.params.user_factors, eng.params.item_factors):
            check(bool(np.isfinite(np.asarray(arr)).all()),
                  f"{label}: non-finite factors")
        if check_learns:
            check(auc > auc0,
                  f"{label}: test AUC {auc:.6f} <= init {auc0:.6f}")
    return eng, auc


def phase_topn(card: str, train, paths, tmp: str) -> None:
    from qmf_tpu.cli import recommend
    from qmf_tpu.data import load_factors

    with Phase("5 top-N via cli.recommend", card) as ph:
        user_ids, ufd = load_factors(paths[0])
        item_ids, ifd = load_factors(paths[1])
        served = np.asarray(user_ids[:N_TOPN_USERS])
        sel = np.isin(train.user_ids, served)
        seen_path = os.path.join(tmp, "seen.txt")
        datagen.write_ratings(seen_path, train.user_ids[sel],
                              train.item_ids[sel], train.values[sel])
        out_path = os.path.join(tmp, "recs.txt")
        argv = [f"--user_factors={paths[0]}", f"--item_factors={paths[1]}",
                f"--users={','.join(str(int(u)) for u in served)}",
                f"--exclude_seen={seen_path}", f"--topn={TOPN}",
                f"--output={out_path}"]
        with ph.timed("recommend_cli"):
            check(recommend.main(argv) == 0, "recommend CLI failed")
        # float64 oracle: argsort of exact scores with seen items excluded
        item_pos = {int(i): j for j, i in enumerate(item_ids)}
        scores = ufd.factors[:N_TOPN_USERS] @ ifd.factors.T
        row_of = {int(u): r for r, u in enumerate(served)}
        rows = np.array([row_of[int(u)] for u in train.user_ids[sel]])
        cols = np.array([item_pos[int(i)] for i in train.item_ids[sel]])
        scores[rows, cols] = -np.inf
        oracle = np.sort(scores, axis=1)[:, ::-1][:, :TOPN]
        tol = 1e-4 * np.abs(oracle).max()
        n_lines = 0
        with open(out_path) as f:
            for line in f:
                u_raw, pairs = line.rstrip("\n").split("\t")
                r = row_of[int(u_raw)]
                got = [item_pos[int(p.split(":")[0])] for p in pairs.split()]
                check(len(got) == TOPN and len(set(got)) == TOPN,
                      f"user {u_raw}: {len(got)} items, not {TOPN} distinct")
                got_scores = scores[r, got]
                check(np.isfinite(got_scores).all(),
                      f"user {u_raw}: a seen item was recommended")
                # equal up to ties: the exact score of each rank matches
                np.testing.assert_allclose(
                    got_scores, oracle[r], rtol=0, atol=tol,
                    err_msg=f"user {u_raw}: top-{TOPN} differs from float64")
                n_lines += 1
        check(n_lines == N_TOPN_USERS, f"{n_lines} users served")
        print(f"top-{TOPN} of {n_lines} users equal to the float64 oracle "
              f"(score tolerance {tol:.2e})", flush=True)


# --- --four ------------------------------------------------------------------


def phase_four(card: str, train, test) -> None:
    import jax

    from qmf_tpu.parallel import ShardedBPREngine, ShardedWALSEngine, make_mesh

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices, need 4")
    mesh = make_mesh(4)
    with Phase("6 four cards: sharded vs one card", card) as ph:
        one, _, auc1 = run_wals(train, test, ph, "wals_one_card",
                                matmul_precision="highest")
        u1 = np.asarray(one.user_factors)[: one.nusers]
        del one
        gc.collect()
        four, _, auc4 = run_wals(
            train, test, ph, "wals_four_cards",
            engine_cls=lambda cfg, metrics_engine: ShardedWALSEngine(
                cfg, metrics_engine=metrics_engine, mesh=mesh),
            matmul_precision="highest")
        devs = {s.device for s in four.item_factors.addressable_shards}
        check(len(devs) == 4, f"item factor shards on {len(devs)} devices")
        print(f"sharded factors on devices {sorted(d.id for d in devs)}",
              flush=True)
        u4 = np.asarray(four.user_factors)[: four.nusers]
        check(abs(auc4 - auc1) <= AUC_BOUND,
              f"sharded WALS AUC {auc4:.6f} vs one card {auc1:.6f}")
        rel = np.abs(u4 - u1).max() / np.abs(u1).max()
        print(f"WALS user factors: max |4 cards - 1 card| / max = {rel:.2e}",
              flush=True)
        del four
        gc.collect()
        one, b1 = phase_bpr(card, train, test, ph=ph, label="bpr_one_card",
                            check_learns=False)
        v1 = np.asarray(one.params.item_factors)
        del one
        gc.collect()
        four, b4 = phase_bpr(card, train, test, engine_cls=ShardedBPREngine,
                             ph=ph, label="bpr_four_cards",
                             check_learns=False, mesh=mesh)
        v4 = np.asarray(four.params.item_factors)
        rel = np.abs(v4 - v1).max() / np.abs(v1).max()
        print(f"BPR test AUC one card {b1:.6f}, four cards {b4:.6f}; item "
              f"factors max |4 cards - 1 card| / max = {rel:.2e}", flush=True)
        del four
        gc.collect()

    from __graft_entry__ import dryrun_multichip

    with Phase("7 float64 sharded-vs-single parity (tiny)", card):
        dryrun_multichip(4)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded phase")
    args = p.parse_args(argv)
    enable_compilation_cache()
    card = card_line()
    dev = phase_device(card, card_tests=not args.four)
    import jax

    train, test = ml20m_split()
    if args.four:
        phase_four(card, train, test)
    else:
        phase_solve(card)
        with tempfile.TemporaryDirectory() as tmp:
            paths = phase_wals(card, train, test, tmp)
            phase_bpr(card, train, test)
            phase_topn(card, train, paths, tmp)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
