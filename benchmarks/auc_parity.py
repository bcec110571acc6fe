"""Quality-parity check: test AUC vs the reference binary (target: <= 1e-3).

The driver's acceptance criterion (BASELINE.json) is test-AUC parity within
1e-3 of the reference at matched hyperparameters. This script:

1. splits the synthetic ml100k dataset 90/10 per user,
2. runs the reference ``wals`` with ``-test_avg_metrics=auc`` and parses its
   logged ``test_avg_auc``,
3. runs qmf_tpu's wals CLI (float32, default device) with the same flags and
   the same ``--distribution_file`` init,
4. reports both AUCs and the difference.

Run: python benchmarks/auc_parity.py   (add JAX_PLATFORMS=cpu to force the CPU)
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))


def split_per_user(users, items, values, test_frac=0.1, seed=0):
    rng = np.random.default_rng(seed)
    test_mask = np.zeros(len(users), dtype=bool)
    order = np.argsort(users, kind="stable")
    sorted_u = users[order]
    bounds = np.nonzero(np.diff(sorted_u))[0] + 1
    for seg in np.split(order, bounds):
        n_test = max(1, int(len(seg) * test_frac)) if len(seg) > 3 else 0
        if n_test:
            test_mask[rng.choice(seg, size=n_test, replace=False)] = True
    return test_mask


def write(path, u, i, v):
    arr = np.stack([u.astype(np.float64), i.astype(np.float64), v], axis=1)
    with open(path, "w") as f:
        np.savetxt(f, arr, fmt=["%d", "%d", "%.1f"])


def main() -> int:
    import datagen
    from qmf_tpu.cli import gen_uniform as gen_cli

    subprocess.run(
        [os.path.join(REPO, "benchmarks", "reference_harness", "build.sh")],
        check=True,
        capture_output=True,
    )
    users, items, values = datagen.load_npz("ml100k")
    test_mask = split_per_user(users, items, values)
    work = tempfile.mkdtemp(prefix="qmf_auc_")
    train_p, test_p = f"{work}/train.txt", f"{work}/test.txt"
    write(train_p, users[~test_mask], items[~test_mask], values[~test_mask])
    write(test_p, users[test_mask], items[test_mask], values[test_mask])
    dist = f"{work}/uniform.dat"
    gen_cli.main(["2000000", dist, "--seed=7"])

    common = [
        "-nepochs=10",
        "-nfactors=30",
        "-regularization_lambda=0.05",
        "-confidence_weight=40",
        f"-distribution_file={dist}",
        f"-train_dataset={train_p}",
        f"-test_dataset={test_p}",
        "-test_avg_metrics=auc",
    ]

    print("running reference wals ...", flush=True)
    ref = subprocess.run(
        ["/tmp/qmf_ref_build/bin/wals", "-nthreads=1", *common,
         f"-user_factors={work}/ru.dat", f"-item_factors={work}/ri.dat"],
        check=True,
        capture_output=True,
        text=True,
    )
    m = re.findall(r"test_avg_auc = ([0-9.]+)", ref.stderr)
    ref_auc = float(m[-1])
    print(f"reference test_avg_auc = {ref_auc:.6f}", flush=True)

    print("running qmf_tpu wals ...", flush=True)
    from qmf_tpu.cli import wals as wals_cli
    from qmf_tpu.metrics.engine import MetricsEngine

    # capture our recorded AUC through the metrics engine history
    recorded = {}
    orig = MetricsEngine.record_metric

    def spy(self, key, epoch, val):
        recorded[key] = val
        return orig(self, key, epoch, val)

    MetricsEngine.record_metric = spy
    try:
        extra = []
        if os.environ.get("QMF_PARITY_PRECISION"):
            extra = [f"--matmul_precision={os.environ['QMF_PARITY_PRECISION']}"]
        if os.environ.get("QMF_PARITY_SOLVER"):
            extra.append(f"--solver={os.environ['QMF_PARITY_SOLVER']}")
        rc = wals_cli.main(
            [*common, *extra, f"--user_factors={work}/ou.dat",
             f"--item_factors={work}/oi.dat"]
        )
    finally:
        MetricsEngine.record_metric = orig
    assert rc == 0
    our_auc = recorded["test_avg_auc"]
    diff = abs(our_auc - ref_auc)
    print(f"qmf_tpu  test_avg_auc = {our_auc:.6f}", flush=True)
    print(f"abs diff = {diff:.2e} ({'PASS <= 1e-3' if diff <= 1e-3 else 'FAIL'})")
    return 0 if diff <= 1e-3 else 1


if __name__ == "__main__":
    sys.exit(main())
