"""Golden cross-implementation check: qmf_tpu vs the reference binary.

Runs the reference ``wals`` (built by reference_harness) and qmf_tpu's WALS
on the SAME dataset with the SAME ``--distribution_file`` init — the
reference's own reproducibility technique (reference examples/README.md:4-13,
FactorData.h:74-100) — then compares the saved factor files numerically.

In float64 both implementations execute the same exact algorithm (sorted-id
indexing, Hu-Koren normal equations, exact solves), so factors must agree to
solver tolerance. Run:  python benchmarks/golden_vs_reference.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import datagen
    from qmf_tpu.cli import wals as wals_cli
    from qmf_tpu.cli import gen_uniform as gen_cli
    from qmf_tpu.data import load_factors

    # ensure reference binary
    build = os.path.join(REPO, "benchmarks", "reference_harness", "build.sh")
    subprocess.run([build], check=True, capture_output=True)
    ref_wals = "/tmp/qmf_ref_build/bin/wals"

    train = datagen.ensure_dataset("ml100k")
    work = tempfile.mkdtemp(prefix="qmf_golden_")
    dist = os.path.join(work, "uniform.dat")
    gen_cli.main(["2000000", dist, "--seed=7"])

    nepochs, k = 3, 16
    common = [
        f"-nepochs={nepochs}",
        f"-nfactors={k}",
        "-regularization_lambda=0.05",
        "-confidence_weight=40",
        f"-distribution_file={dist}",
        f"-train_dataset={train}",
    ]

    print("running reference wals ...", flush=True)
    subprocess.run(
        [ref_wals, "-nthreads=1", *common,
         f"-user_factors={work}/ref_u.dat", f"-item_factors={work}/ref_i.dat"],
        check=True,
        capture_output=True,
    )

    print("running qmf_tpu wals (float64, CPU) ...", flush=True)
    rc = wals_cli.main(
        [*common, "--dtype=float64",
         f"--user_factors={work}/our_u.dat",
         f"--item_factors={work}/our_i.dat"]
    )
    assert rc == 0

    report = {}
    for side in ("u", "i"):
        ids_r, f_r = load_factors(f"{work}/ref_{side}.dat")
        ids_o, f_o = load_factors(f"{work}/our_{side}.dat")
        assert np.array_equal(ids_r, ids_o), f"{side}: id order differs"
        diff = np.abs(f_r.factors - f_o.factors)
        denom = np.abs(f_r.factors) + 1e-6
        report[side] = (float(diff.max()), float((diff / denom).max()))
    print(
        f"user factors: max abs diff {report['u'][0]:.3e}, "
        f"max rel diff {report['u'][1]:.3e}"
    )
    print(
        f"item factors: max abs diff {report['i'][0]:.3e}, "
        f"max rel diff {report['i'][1]:.3e}"
    )
    ok = all(absd < 1e-5 for absd, _ in report.values())
    print("GOLDEN MATCH" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
