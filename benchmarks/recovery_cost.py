"""Measure the wall-clock cost of one killed-worker recovery.

The multi-process fault-tolerance design (distributed/scheduler.py) pays
for a mid-run worker loss with: failure detection (task_done rc!=0 or
labor loss) + task_abort fan-out + a fresh quorum + a new jax.distributed
rendezvous + re-init (dataset pack + transfers) + recompile (warm
persistent cache) + re-running at most one epoch past the last durable
checkpoint. The reference's recovery unit was a ~1 s 10k-row bucket
reassignment (RunOneTask.cpp:239); ours is a whole attempt — this script
puts a number on that delta.

Method: run the same task twice on virtual CPU devices (scheduler process 0
+ one labor process, 2x4-device mesh):
  run A — uninterrupted, wall W0
  run B — SIGKILL the labor's worker right after the first epoch checkpoint
          is durable, wall W1
  recovery overhead = W1 - W0 (minus the kill-wait slack, reported too)

Usage: python -u benchmarks/recovery_cost.py [nratings] [nepochs]
Writes one summary line; record it in benchmarks/README.md.
"""

import asyncio
import os
import signal
import sys
import threading
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

# virtual CPU mesh: two JAX workers cannot share one card
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from qmf_tpu.distributed.labor import Labor  # noqa: E402
from qmf_tpu.distributed.scheduler import Scheduler  # noqa: E402
from qmf_tpu.distributed.submit import (  # noqa: E402
    scheduler_status,
    submit_task_file,
)
from qmf_tpu.distributed.taskdef import parse_taskdef  # noqa: E402
from qmf_tpu.distributed.worker import default_ckpt_dir  # noqa: E402

N_RATINGS = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
NEPOCHS = int(sys.argv[2]) if len(sys.argv) > 2 else 8


class Fixture:
    def __init__(self):
        self.scheduler = Scheduler(
            "127.0.0.1", 0, multiproc=True, n_local_devices=4,
            prepare_timeout=60.0,
        )
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)

            async def boot():
                await self.scheduler.start()
                started.set()

            self.loop.run_until_complete(boot())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        started.wait(10)

    def run_coro(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def close(self):
        asyncio.run_coroutine_threadsafe(
            self.scheduler.stop(), self.loop
        ).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


def make_task(tmp, tag):
    rng = np.random.default_rng(7)
    train = os.path.join(tmp, "train.txt")
    if not os.path.exists(train):
        with open(train, "w") as f:
            for u, i, v in zip(
                rng.integers(1, 4000, N_RATINGS),
                rng.integers(1, 1500, N_RATINGS),
                rng.integers(1, 6, N_RATINGS),
            ):
                f.write(f"{u} {i} {v}\n")
    path = os.path.join(tmp, f"task_{tag}.pb")
    with open(path, "w") as f:
        f.write(
            f"nepochs : {NEPOCHS}\n"
            "nfactors : 16\n"
            f'train_set : "{train}"\n'
            f'user_factors : "{tmp}/u_{tag}.dat"\n'
            f'item_factors : "{tmp}/i_{tag}.dat"\n'
        )
    return path


def run_once(tmp, tag, kill):
    fx = Fixture()
    labor = Labor("127.0.0.1", fx.scheduler.port)
    fut = fx.run_coro(labor.run())
    kill_info = {}
    try:
        for _ in range(100):
            if fx.scheduler.labors:
                break
            time.sleep(0.05)
        task_path = make_task(tmp, tag)
        t0 = time.time()
        rsp = submit_task_file("127.0.0.1", fx.scheduler.port, task_path)
        assert rsp["status"] == "OK", rsp
        if kill:
            td = parse_taskdef(open(task_path).read())
            ckpt = os.path.join(
                default_ckpt_dir(td, rsp["taskid"]), "LATEST"
            )
            for _ in range(6000):
                if os.path.exists(ckpt):
                    break
                time.sleep(0.05)
            assert os.path.exists(ckpt), "no checkpoint appeared"
            pid = labor.worker_pid
            assert pid is not None
            os.kill(pid, signal.SIGKILL)
            kill_info["t_kill"] = time.time() - t0
        while True:
            status = scheduler_status("127.0.0.1", fx.scheduler.port)
            if status["history"] and status["history"][-1]["state"] in (
                "done", "failed",
            ):
                break
            time.sleep(0.2)
        wall = time.time() - t0
        last = status["history"][-1]
        assert last["state"] == "done", last
        return wall, last["result"], kill_info
    finally:
        fut.cancel()
        fx.close()


def main():
    import tempfile

    tmp = tempfile.mkdtemp(prefix="qmf_recovery_")
    w0, r0, _ = run_once(tmp, "base", kill=False)
    print(
        f"uninterrupted: {w0:.1f}s wall, attempts={r0.get('attempts')}, "
        f"procs={r0.get('num_processes')}", flush=True,
    )
    w1, r1, ki = run_once(tmp, "kill", kill=True)
    print(
        f"killed-after-first-checkpoint: {w1:.1f}s wall "
        f"(kill at +{ki.get('t_kill', float('nan')):.1f}s), "
        f"attempts={r1.get('attempts')}, procs={r1.get('num_processes')}",
        flush=True,
    )
    print(
        f"RECOVERY OVERHEAD: {w1 - w0:.1f}s for one killed worker at "
        f"{N_RATINGS} ratings x {NEPOCHS} epochs, k=16, 2 processes "
        "(detection + abort + re-quorum + re-rendezvous + re-init + "
        "resume from last epoch checkpoint)", flush=True,
    )


if __name__ == "__main__":
    main()
