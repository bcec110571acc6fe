"""Per-process training worker for multi-process (multi-host) WALS.

This is the compute role the reference's Labor played
(reference distributed/labor/Labor.cpp:326-405: receive dataset + fixed
factors, solve 10k-row buckets, send rows back). Redesign: every
participating process joins ONE jax.distributed rendezvous and co-executes
the SAME sharded SPMD program (qmf_tpu/parallel/engine.py) over the global
device mesh — the scheduler process's worker is process 0, each labor host
runs one worker as process 1..N-1. Dataset rows are read per-process from
the shared filesystem (the reference also assumed a shared filesystem for
task files, wals_submit.cpp:17-25) and all cross-device traffic rides the
accelerator interconnect instead of the reference's TCP star.

The worker is launched as a fresh subprocess per task (one jax.distributed
rendezvous per process lifetime), with `python -m qmf_tpu.distributed.worker`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional

from qmf_tpu.distributed.taskdef import TaskDef
from qmf_tpu.utils.logging import log


def _force_virtual_cpu(n_local_devices: int) -> None:
    """Pin this process to n virtual CPU devices (test/dev deployments).

    Must run before the first jax backend init; works after `import jax`
    because backend init is lazy (see tests/conftest.py).
    """
    import re

    flags = os.environ.get("XLA_FLAGS", "")
    # replace any inherited count (e.g. a test harness parent's) with ours
    flags = re.sub(
        r"--xla_force_host_platform_device_count=\d+", "", flags
    ).strip()
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_local_devices}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


def default_ckpt_dir(td: TaskDef, taskid: int) -> str:
    """Shared-fs checkpoint directory for a task, keyed by taskid AND a
    digest of the task definition, so every worker (and a retried attempt,
    or the scheduler's single-process fallback) resumes the same run —
    while a DIFFERENT task that happens to reuse the output path and a
    recycled taskid (scheduler restart; failed tasks leave their dir
    behind) can never silently auto-resume foreign factors. The digest
    covers the FULL task definition — a leftover dir from a run with a
    different regularization_lambda/confidence_weight/solver must not be
    resumed either."""
    import hashlib
    import json as _json

    digest = hashlib.sha1(
        _json.dumps(td.to_dict(), sort_keys=True).encode()
    ).hexdigest()[:8]
    return f"{td.user_factors}.ckpt_task{taskid}_{digest}"


def run_worker(
    td: TaskDef,
    coordinator: Optional[str] = None,
    num_processes: int = 1,
    process_id: int = 0,
    n_local_devices: int = 0,
    taskid: int = 0,
    ckpt_dir: Optional[str] = None,
    progress_path: Optional[str] = None,
) -> Dict[str, Any]:
    """Join the rendezvous, co-train, save factors on process 0.

    Per-epoch fault tolerance: every attempt checkpoints to ``ckpt_dir``
    (default: a shared-fs dir keyed by taskid) and auto-resumes from LATEST,
    so a worker killed mid-run costs at most one epoch when the scheduler
    retries the task — the recovery semantics the reference got from
    per-bucket reassignment + state re-push (RunOneTask.cpp:177-240,
    Connection.cpp:307-413), with the epoch as the recovery unit.

    Progress: when ``progress_path`` is set, a JSON line with
    {taskid, epoch, loss, wall_s} is atomically rewritten after every epoch
    (the per-bucket progress logging analog, RunOneTask.cpp:208-212); the
    spawning agent tails it and forwards progress to the scheduler.

    Returns a result dict (on every process; only process 0's is reported).
    """
    if n_local_devices:
        _force_virtual_cpu(n_local_devices)

    import time

    import jax

    from qmf_tpu.config import WALSConfig
    from qmf_tpu.data import read_dataset
    from qmf_tpu.parallel import ShardedWALSEngine, multihost

    if td.dtype == "float64":
        # f64 golden mode (CPU only; used for cross-run bit-exactness)
        jax.config.update("jax_enable_x64", True)
    if num_processes > 1:
        multihost.initialize(
            coordinator=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
    mesh = multihost.global_mesh()

    cfg = WALSConfig(
        nepochs=td.nepochs,
        nfactors=td.nfactors,
        regularization_lambda=td.regularization_lambda,
        confidence_weight=td.confidence_weight,
        init_distribution_bound=td.init_distribution_bound,
        distribution_file=td.distribution_file,
        dtype=td.dtype,
        solver=td.solver,
    )
    engine = ShardedWALSEngine(cfg, mesh=mesh)
    engine.init(read_dataset(td.train_set))
    engine.enable_checkpointing(ckpt_dir or default_ckpt_dir(td, taskid))
    t0 = time.time()
    # fault-injection knob (tests/ops drills): stretch each epoch so a
    # worker can be killed mid-run deterministically. The reference has no
    # fault-injection tooling at all (SURVEY.md section 5.3).
    epoch_sleep = float(os.environ.get("QMF_TPU_EPOCH_SLEEP_S", "0") or 0)
    if progress_path or epoch_sleep:
        def _report(epoch, loss, wall_s):
            if progress_path:
                tmp = progress_path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(
                        {
                            "taskid": taskid,
                            "epoch": epoch,
                            "nepochs": td.nepochs,
                            "loss": float(loss),
                            "wall_s": round(wall_s, 3),
                        },
                        f,
                    )
                os.replace(tmp, progress_path)
            if epoch_sleep:
                time.sleep(epoch_sleep)

        engine.progress_cb = _report
    engine.optimize()
    wall = time.time() - t0

    # Replicate the final factors across processes (all processes must
    # execute this collective — engine._checkpoint_arrays is the same
    # gather the per-epoch checkpoints use), then only process 0 touches
    # the filesystem — the analog of the reference scheduler gathering
    # kCalcRsp rows before saveFactors (RunOneTask.cpp:153-155).
    import numpy as np

    arrays = engine._checkpoint_arrays()
    if jax.process_index() == 0:
        engine.save_factor_data(
            np.asarray(arrays["user_factors"], dtype=np.float64),
            engine.user_index,
            td.user_factors,
        )
        engine.save_factor_data(
            np.asarray(arrays["item_factors"], dtype=np.float64),
            engine.item_index,
            td.item_factors,
        )
    if num_processes > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(f"qmf_task_{taskid}_saved")
    return {
        "taskid": taskid,
        "process_id": process_id,
        "num_processes": num_processes,
        "nusers": engine.nusers,
        "nitems": engine.nitems,
        "global_devices": jax.device_count(),
        "local_devices": jax.local_device_count(),
        "wall_s": round(wall, 3),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task-json", required=True,
                   help="TaskDef as a JSON object (or @/path/to/file.json)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--n-local-devices", type=int, default=0,
                   help="force N virtual CPU devices (0 = native platform)")
    p.add_argument("--taskid", type=int, default=0)
    p.add_argument("--result", default=None,
                   help="write the result JSON to this path")
    p.add_argument("--ckpt-dir", default=None,
                   help="per-epoch checkpoint directory (shared fs); "
                        "default derives from user_factors + taskid")
    p.add_argument("--progress", default=None,
                   help="atomically rewrite per-epoch progress JSON here")
    args = p.parse_args(argv)

    raw = args.task_json
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    td = TaskDef.from_dict(json.loads(raw))
    td.validate()

    result = run_worker(
        td,
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        n_local_devices=args.n_local_devices,
        taskid=args.taskid,
        ckpt_dir=args.ckpt_dir,
        progress_path=args.progress,
    )
    log.info("worker done: %s", result)
    if args.result:
        tmp = args.result + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f)
        os.replace(tmp, args.result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
