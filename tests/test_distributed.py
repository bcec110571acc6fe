"""Distributed control-plane tests.

Coverage the reference never had: its distributed/ layer shipped with zero
tests (SURVEY.md section 4). These run scheduler + labors + submit
end-to-end in-process over real sockets (ephemeral ports), including the
golden standalone-vs-distributed equality check from the reference workflow
(reference examples/README.md:4-13).
"""

import asyncio
import threading

import numpy as np
import pytest

from qmf_tpu.distributed import protocol
from qmf_tpu.distributed.labor import Labor
from qmf_tpu.distributed.scheduler import Scheduler
from qmf_tpu.distributed.submit import scheduler_status, submit_task_file
from qmf_tpu.distributed.taskdef import TaskDef, load_taskdef, parse_taskdef


class TestTaskDef:
    def test_parses_reference_example_format(self):
        text = (
            'nepochs : 5\n'
            'nfactors : 30\n'
            'distribution_file : "../uniform.dat"\n'
            'train_set : "../n_rating.csv"\n'
            'user_factors : "./user_factors_vec.dat"\n'
            'item_factors : "./item_factors_vec.dat"\n'
        )
        td = parse_taskdef(text)
        assert td.nepochs == 5 and td.nfactors == 30
        assert td.train_set == "../n_rating.csv"
        assert td.distribution_file == "../uniform.dat"
        # proto defaults preserved (task.proto:7-10)
        assert td.regularization_lambda == 0.05
        assert td.confidence_weight == 40.0

    def test_missing_required_raises(self):
        with pytest.raises(ValueError, match="required"):
            parse_taskdef("nepochs : 5\n")

    def test_unknown_field_raises(self):
        with pytest.raises(ValueError, match="unknown field"):
            parse_taskdef('bogus : 1\ntrain_set : "x"\n')

    def test_comments_and_floats(self):
        td = parse_taskdef(
            "# job\nregularization_lambda : 0.1\n"
            'train_set : "a"\nuser_factors : "b"\nitem_factors : "c"\n'
        )
        assert td.regularization_lambda == 0.1

    def test_hash_inside_quoted_string(self):
        # '#' is only a comment delimiter outside quoted strings
        # (legal proto2 TextFormat, e.g. file names containing '#')
        td = parse_taskdef(
            'train_set : "data#1.csv"  # trailing comment\n'
            'user_factors : "u#f.dat"\nitem_factors : "c"\n'
        )
        assert td.train_set == "data#1.csv"
        assert td.user_factors == "u#f.dat"

    def test_escaped_quotes_and_backslashes_unescaped(self):
        # _strip_comment accepts \" inside strings; the parsed value must
        # have the escapes RESOLVED, not retain the backslash
        td = parse_taskdef(
            'train_set : "data\\"1.csv"\n'
            'user_factors : "dir\\\\u.dat"\n'
            'item_factors : "c"\n'
        )
        assert td.train_set == 'data"1.csv'
        assert td.user_factors == "dir\\u.dat"


class TestProtocol:
    def test_frame_roundtrip(self):
        msg = {"kind": "status", "x": [1, 2, 3]}
        raw = protocol.encode_frame(msg)
        assert raw[:4] == protocol.MAGIC
        import json
        import struct

        (length,) = struct.unpack(">I", raw[4:8])
        assert json.loads(raw[8 : 8 + length].decode()) == msg

    def test_bad_magic_rejected(self):
        with pytest.raises(protocol.ProtocolError):
            protocol._decode_head(b"XXXX\x00\x00\x00\x01")


def _fake_runner(results):
    def runner(td: TaskDef, taskid: int):
        results.append((taskid, td.train_set))
        return {"ok": True, "taskid": taskid}

    return runner


class SchedulerFixture:
    """Runs a Scheduler on an ephemeral port in a background event loop."""

    def __init__(self, runner=None, heartbeat_interval=30.0, **kwargs):
        self.scheduler = Scheduler(
            "127.0.0.1",
            0,
            runner=runner,
            heartbeat_interval=heartbeat_interval,
            **kwargs,
        )
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        self._started.wait(10)

    def _run(self):
        asyncio.set_event_loop(self.loop)

        async def boot():
            await self.scheduler.start()
            self._started.set()

        self.loop.run_until_complete(boot())
        self.loop.run_forever()

    @property
    def port(self):
        return self.scheduler.port

    def run_coro(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def close(self):
        asyncio.run_coroutine_threadsafe(
            self.scheduler.stop(), self.loop
        ).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)


class TestControlPlane:
    def test_submit_runs_task_and_status(self, tmp_path):
        results = []
        fx = SchedulerFixture(runner=_fake_runner(results))
        try:
            task_file = tmp_path / "task.pb"
            task_file.write_text(
                'nepochs : 1\ntrain_set : "train.txt"\n'
                'user_factors : "u.dat"\nitem_factors : "i.dat"\n'
            )
            rsp = submit_task_file("127.0.0.1", fx.port, str(task_file))
            assert rsp["status"] == "OK" and rsp["taskid"] == 1
            # wait for the runner thread
            import time

            for _ in range(100):
                if results:
                    break
                time.sleep(0.05)
            assert results == [(1, "train.txt")]
            status = scheduler_status("127.0.0.1", fx.port)
            assert status["kind"] == "status_rsp"
            assert status["history"][-1]["state"] == "done"
        finally:
            fx.close()

    def test_submit_malformed_task_fails_cleanly(self, tmp_path):
        fx = SchedulerFixture(runner=_fake_runner([]))
        try:
            rsp = protocol.send_and_recv(
                "127.0.0.1",
                fx.port,
                {"kind": "submit_task", "task_text": "nonsense ::"},
            )
            assert rsp["status"] == "FAIL"
        finally:
            fx.close()

    def test_labor_attach_heartbeat_and_announce(self, tmp_path):
        results = []
        fx = SchedulerFixture(
            runner=_fake_runner(results), heartbeat_interval=0.3
        )
        labor = Labor("127.0.0.1", fx.port)
        labor_future = fx.run_coro(labor.run())
        try:
            import time

            for _ in range(100):
                if fx.scheduler.labors:
                    break
                time.sleep(0.05)
            assert len(fx.scheduler.labors) == 1

            task_file = tmp_path / "task.pb"
            task_file.write_text(
                'nepochs : 2\ntrain_set : "t.txt"\n'
                'user_factors : "u.dat"\nitem_factors : "i.dat"\n'
            )
            submit_task_file("127.0.0.1", fx.port, str(task_file))
            for _ in range(100):
                if labor.taskid == 1:
                    break
                time.sleep(0.05)
            assert labor.taskid == 1  # announcement received

            # heartbeat path: after the short interval, labor's info_rsp
            # must have updated the scheduler's view
            for _ in range(100):
                li = next(iter(fx.scheduler.labors.values()), None)
                if li is not None and li.taskid == 1:
                    break
                time.sleep(0.05)
            assert li is not None and li.taskid == 1
        finally:
            labor_future.cancel()
            fx.close()

    def test_hung_labor_is_dropped_after_unanswered_probe(self):
        """A connected-but-silent labor must be probed once and then dropped
        after one unanswered interval — not re-touched forever."""
        import time

        fx = SchedulerFixture(runner=_fake_runner([]), heartbeat_interval=0.3)
        try:
            # register a fake labor whose writer swallows probes silently
            class _NullWriter:
                def write(self, data):
                    pass

                async def drain(self):
                    pass

            async def attach_fake():
                from qmf_tpu.distributed.scheduler import LaborInfo

                li = LaborInfo("fake:1")
                li.writer = _NullWriter()
                fx.scheduler.labors["fake:1"] = li

            fx.run_coro(attach_fake()).result(10)
            # stale (>interval) -> probe sent -> no reply -> dropped
            for _ in range(100):
                if "fake:1" not in fx.scheduler.labors:
                    break
                time.sleep(0.05)
            assert "fake:1" not in fx.scheduler.labors
        finally:
            fx.close()

    def test_labor_loss_flags_active_attempt(self):
        """Losing a labor that participates in the in-flight multi-process
        attempt must set the fail event (its worker died with it — no
        task_done will arrive); losing a bystander labor must not."""
        import asyncio as aio

        sched = Scheduler("127.0.0.1", 0)
        sched._fail_event = aio.Event()
        sched._active_peers = {"10.0.0.1:1"}
        sched._notice_labor_loss("10.0.0.2:9")  # bystander
        assert not sched._fail_event.is_set()
        sched._notice_labor_loss("10.0.0.1:1")  # participant
        assert sched._fail_event.is_set()
        # no in-flight attempt: must not crash
        sched._fail_event = None
        sched._notice_labor_loss("10.0.0.1:1")

    def test_stale_task_done_cannot_fail_healthy_attempt(self):
        """Retries reuse the taskid: a failure report from an aborted labor
        of a PREVIOUS attempt (not in _active_peers) must not abort the
        in-flight healthy attempt."""
        import asyncio as aio

        sched = Scheduler("127.0.0.1", 0)
        sched.current = {"taskid": 7}
        sched._fail_event = aio.Event()
        sched._active_peers = {"10.0.0.1:1"}
        msg = {"kind": "task_done", "taskid": 7, "rc": 1}
        aio.run(sched._dispatch(msg, "10.0.0.9:9", None))  # stale bystander
        assert not sched._fail_event.is_set()
        aio.run(sched._dispatch(msg, "10.0.0.1:1", None))  # participant
        assert sched._fail_event.is_set()

    def test_heartbeat_reply_reports_running_epoch(self):
        """The info_rsp to a labor-initiated heartbeat must carry the task's
        live epoch (the reference put the epchoid in every reply header),
        not a hard-coded 0."""
        import asyncio as aio

        sched = Scheduler("127.0.0.1", 0)
        sched.taskid = 3
        rsp = aio.run(sched._dispatch({"kind": "heartbeat"}, "p:1", None))
        assert rsp == {"kind": "info_rsp", "taskid": 3, "epoch": 0}
        sched.current = {
            "taskid": 3,
            "progress": {
                "scheduler": {"epoch": 4},
                "10.0.0.1:1": {"epoch": 5},
            },
        }
        rsp = aio.run(sched._dispatch({"kind": "heartbeat"}, "p:1", None))
        assert rsp["epoch"] == 5

    def test_abort_racing_task_start_arms_deferred_kill(self):
        """A task_abort dispatched from the same buffered read batch as
        task_start (before the worker coroutine ever runs) must arm the
        deferred-kill flag on the holder the worker path reads — not on a
        throwaway dict (round-5 review finding)."""
        import asyncio as aio

        async def scenario():
            labor = Labor("127.0.0.1", 0)
            # same-batch dispatches with NO await in between
            labor._dispatch(
                {
                    "kind": "task_start",
                    "taskid": 5,
                    "task": {},
                    "coordinator": "127.0.0.1:1",
                    "num_processes": 2,
                    "process_id": 1,
                }
            )
            assert labor._worker_holder is not None
            labor._dispatch({"kind": "task_abort", "taskid": 5})
            armed = labor._worker_holder.get("aborted")
            labor._worker_task.cancel()
            try:
                await labor._worker_task
            except (aio.CancelledError, Exception):  # noqa: BLE001
                pass
            return armed

        assert aio.run(scenario()) is True

    def test_labor_detach_is_noticed(self):
        fx = SchedulerFixture(runner=_fake_runner([]))
        labor = Labor("127.0.0.1", fx.port)
        fut = fx.run_coro(labor.run())
        try:
            import time

            for _ in range(100):
                if fx.scheduler.labors:
                    break
                time.sleep(0.05)
            fut.cancel()  # closes the connection
            for _ in range(100):
                if not fx.scheduler.labors:
                    break
                time.sleep(0.05)
            assert not fx.scheduler.labors
        finally:
            fx.close()


@pytest.mark.slow
class TestDistributedGolden:
    def test_distributed_task_matches_standalone_cli(self, tmp_path):
        """The reference's golden workflow (examples/README.md:4-13):
        identical uniform.dat seed => distributed run output must equal the
        standalone CLI run output, line for line."""
        from qmf_tpu.cli import gen_uniform as gen_cli
        from qmf_tpu.cli import wals as wals_cli

        rng = np.random.default_rng(0)
        lines = [
            f"{u} {i} {v}\n"
            for u, i, v in zip(
                rng.integers(1, 50, 600),
                rng.integers(1, 30, 600),
                rng.integers(1, 6, 600),
            )
        ]
        train = tmp_path / "train.txt"
        train.write_text("".join(lines))
        dist = tmp_path / "uniform.dat"
        gen_cli.main(["20000", str(dist), "--seed=7"])

        # standalone
        wals_cli.main(
            [
                f"--train_dataset={train}",
                f"--distribution_file={dist}",
                "--nepochs=2",
                "--nfactors=4",
                f"--user_factors={tmp_path / 'su.dat'}",
                f"--item_factors={tmp_path / 'si.dat'}",
            ]
        )

        # distributed submission (real scheduler, real task runner)
        fx = SchedulerFixture()  # default runner = real run_task
        try:
            task_file = tmp_path / "task.pb"
            task_file.write_text(
                "nepochs : 2\n"
                "nfactors : 4\n"
                f'distribution_file : "{dist}"\n'
                f'train_set : "{train}"\n'
                f'user_factors : "{tmp_path / "du.dat"}"\n'
                f'item_factors : "{tmp_path / "di.dat"}"\n'
            )
            rsp = submit_task_file("127.0.0.1", fx.port, str(task_file))
            assert rsp["status"] == "OK"
            import time

            # generous budget: the task run includes XLA compiles, and this
            # box is a single shared vCPU that other processes may be loading
            for _ in range(3000):
                status = scheduler_status("127.0.0.1", fx.port)
                if status["history"] and status["history"][-1]["state"] in (
                    "done",
                    "failed",
                ):
                    break
                time.sleep(0.1)
            assert status["history"][-1]["state"] == "done", status
        finally:
            fx.close()

        # sharded f32 reductions reorder vs single-chip, so compare
        # numerically (the reference's golden diff was over f64 CPU runs)
        from qmf_tpu.data import load_factors

        for a, b in (("du.dat", "su.dat"), ("di.dat", "si.dat")):
            ids_a, fa = load_factors(str(tmp_path / a))
            ids_b, fb = load_factors(str(tmp_path / b))
            np.testing.assert_array_equal(ids_a, ids_b)
            np.testing.assert_allclose(
                fa.factors, fb.factors, rtol=5e-4, atol=5e-5
            )


@pytest.mark.slow
class TestMultiProcessTraining:
    def test_two_process_run_matches_single_process(self, tmp_path):
        """A labor receiving task_start joins the
        jax.distributed rendezvous and co-executes the SPMD program.

        Scheduler worker (process 0, 4 virtual CPU devices) + 1 labor worker
        (process 1, 4 more) = an 8-device global mesh across 2 OS processes.
        The f64 result must match a single-process run bit-for-bit (the
        reference's golden technique, examples/README.md:4-13)."""
        from qmf_tpu.cli import gen_uniform as gen_cli

        rng = np.random.default_rng(5)
        lines = [
            f"{u} {i} {v}\n"
            for u, i, v in zip(
                rng.integers(1, 60, 800),
                rng.integers(1, 40, 800),
                rng.integers(1, 6, 800),
            )
        ]
        train = tmp_path / "train.txt"
        train.write_text("".join(lines))
        dist = tmp_path / "uniform.dat"
        gen_cli.main(["20000", str(dist), "--seed=3"])

        task_text = (
            "nepochs : 2\n"
            "nfactors : 4\n"
            'dtype : "float64"\n'
            f'distribution_file : "{dist}"\n'
            f'train_set : "{train}"\n'
            "user_factors : \"%s\"\n"
            "item_factors : \"%s\"\n"
        )

        # generous prepare window: under heavy box load the labor's ack can
        # trail the announce by tens of seconds; a miss silently falls back
        # to a single-process run and fails the num_processes assertion
        fx = SchedulerFixture(
            multiproc=True, n_local_devices=4, prepare_timeout=60.0
        )
        labor = Labor("127.0.0.1", fx.port)
        labor_future = fx.run_coro(labor.run())
        try:
            import time

            for _ in range(100):
                if fx.scheduler.labors:
                    break
                time.sleep(0.05)
            assert len(fx.scheduler.labors) == 1

            task_file = tmp_path / "task.pb"
            task_file.write_text(
                task_text % (tmp_path / "mu.dat", tmp_path / "mi.dat")
            )
            rsp = submit_task_file("127.0.0.1", fx.port, str(task_file))
            assert rsp["status"] == "OK"
            for _ in range(6000):  # worker subprocesses import jax (slow)
                status = scheduler_status("127.0.0.1", fx.port)
                if status["history"] and status["history"][-1]["state"] in (
                    "done",
                    "failed",
                ):
                    break
                time.sleep(0.1)
            last = status["history"][-1]
            assert last["state"] == "done", last
            # it really ran as 2 processes x 4 devices
            assert last["result"]["num_processes"] == 2
            assert last["result"]["global_devices"] == 8
            assert last["result"]["local_devices"] == 4
        finally:
            labor_future.cancel()
            fx.close()

        # single-process oracle (in-process 8-device mesh, f64)
        from qmf_tpu.distributed.taskdef import parse_taskdef
        from qmf_tpu.distributed.worker import run_worker

        td = parse_taskdef(task_text % (tmp_path / "su.dat", tmp_path / "si.dat"))
        run_worker(td, num_processes=1)

        from qmf_tpu.data import load_factors

        for a, b in (("mu.dat", "su.dat"), ("mi.dat", "si.dat")):
            ids_a, fa = load_factors(str(tmp_path / a))
            ids_b, fb = load_factors(str(tmp_path / b))
            np.testing.assert_array_equal(ids_a, ids_b)
            np.testing.assert_array_equal(fa.factors, fb.factors)

    def test_worker_killed_mid_run_is_retried_from_checkpoint(
        self, tmp_path, monkeypatch
    ):
        """SIGKILL a labor's worker mid-run; the
        scheduler must (a) have shown live mid-run progress (epoch > 0) in
        status, (b) detect the broken rendezvous, kill its own worker, and
        (c) retry the task, resuming from the shared per-epoch checkpoint —
        final factors bit-equal (f64) to an uninterrupted run.

        This is the SPMD-era equivalent of the reference's fault-tolerance
        story (dead labor -> buckets reassigned, epoch completes,
        RunOneTask.cpp:177-240)."""
        import os
        import signal
        import time

        from qmf_tpu.cli import gen_uniform as gen_cli
        from qmf_tpu.distributed.worker import default_ckpt_dir

        # stretch epochs so the kill window is deterministic
        monkeypatch.setenv("QMF_TPU_EPOCH_SLEEP_S", "0.75")

        rng = np.random.default_rng(11)
        lines = [
            f"{u} {i} {v}\n"
            for u, i, v in zip(
                rng.integers(1, 40, 500),
                rng.integers(1, 25, 500),
                rng.integers(1, 6, 500),
            )
        ]
        train = tmp_path / "train.txt"
        train.write_text("".join(lines))
        dist = tmp_path / "uniform.dat"
        gen_cli.main(["10000", str(dist), "--seed=9"])

        task_text = (
            "nepochs : 6\n"
            "nfactors : 4\n"
            'dtype : "float64"\n'
            f'distribution_file : "{dist}"\n'
            f'train_set : "{train}"\n'
            'user_factors : "%s"\n'
            'item_factors : "%s"\n'
        )

        fx = SchedulerFixture(
            multiproc=True, n_local_devices=4, prepare_timeout=30.0
        )
        labor = Labor("127.0.0.1", fx.port)
        labor_future = fx.run_coro(labor.run())
        try:
            for _ in range(100):
                if fx.scheduler.labors:
                    break
                time.sleep(0.05)
            assert len(fx.scheduler.labors) == 1

            task_file = tmp_path / "task.pb"
            task_file.write_text(
                task_text % (tmp_path / "ku.dat", tmp_path / "ki.dat")
            )
            td = parse_taskdef(task_file.read_text())
            ckpt_dir = default_ckpt_dir(td, taskid=1)
            rsp = submit_task_file("127.0.0.1", fx.port, str(task_file))
            assert rsp["status"] == "OK" and rsp["taskid"] == 1

            # (a) live progress: status must show a labor epoch > 0 mid-run
            saw_progress = False
            for _ in range(2400):
                status = scheduler_status("127.0.0.1", fx.port)
                labors = status.get("labors", {})
                cur = status.get("current") or {}
                if any(li["epoch"] > 0 for li in labors.values()) or (
                    cur.get("progress")
                ):
                    saw_progress = True
                    break
                if status["history"] and status["history"][-1]["state"] in (
                    "done",
                    "failed",
                ):
                    break
                time.sleep(0.05)
            assert saw_progress, "no mid-run progress surfaced in status"

            # wait until at least one epoch checkpoint is durable, then
            # SIGKILL the labor's worker subprocess mid-epoch
            for _ in range(2400):
                if os.path.exists(os.path.join(ckpt_dir, "LATEST")):
                    break
                time.sleep(0.05)
            assert os.path.exists(os.path.join(ckpt_dir, "LATEST"))
            pid = labor.worker_pid
            assert pid is not None, "labor worker already gone?"
            os.kill(pid, signal.SIGKILL)

            # (b)+(c): the task must still complete, on a retried attempt
            for _ in range(3000):
                status = scheduler_status("127.0.0.1", fx.port)
                if status["history"] and status["history"][-1]["state"] in (
                    "done",
                    "failed",
                ):
                    break
                time.sleep(0.1)
            last = status["history"][-1]
            assert last["state"] == "done", last
            assert last["result"]["attempts"] >= 2, last["result"]
            assert last["result"]["num_processes"] == 2
            # checkpoint dir cleaned up after success
            assert not os.path.exists(ckpt_dir)
        finally:
            labor_future.cancel()
            fx.close()

        # uninterrupted single-process oracle must match bit-for-bit (f64)
        monkeypatch.delenv("QMF_TPU_EPOCH_SLEEP_S")
        from qmf_tpu.distributed.worker import run_worker

        td = parse_taskdef(
            task_text % (tmp_path / "su.dat", tmp_path / "si.dat")
        )
        run_worker(td, num_processes=1)

        from qmf_tpu.data import load_factors

        for a, b in (("ku.dat", "su.dat"), ("ki.dat", "si.dat")):
            ids_a, fa = load_factors(str(tmp_path / a))
            ids_b, fb = load_factors(str(tmp_path / b))
            np.testing.assert_array_equal(ids_a, ids_b)
            np.testing.assert_array_equal(fa.factors, fb.factors)

    def test_new_labor_absorbed_at_failure_retry(self, tmp_path, monkeypatch):
        """The scheduler docstring's elasticity claim —
        "new labors ARE absorbed at every failure retry" — exercised with a
        labor that attaches only AFTER the first attempt started. The retry
        must re-run the quorum over the enlarged labor set and include the
        newcomer (reference analog: any-time kAttachLabor + stale-state
        re-push, Connection.cpp:186-196,307-413).

        Worker subprocesses are faked (the rendezvous itself is covered by
        the real multi-process tests above): attempt 1's process-0 worker
        blocks until the second labor is attached, then fails; attempt 2
        succeeds immediately."""
        import threading as _threading
        import time

        from qmf_tpu.distributed import scheduler as sched_mod

        l2_attached = _threading.Event()
        calls = {"p0": 0}

        async def fake_rws(td, taskid, coordinator, num_processes,
                           process_id, n_local_devices=0, timeout=3600.0,
                           proc_holder=None, on_progress=None):
            if process_id != 0:  # labor-side worker: succeed instantly
                return {"taskid": taskid, "process_id": process_id}
            calls["p0"] += 1
            if calls["p0"] == 1:
                while not l2_attached.is_set():
                    await asyncio.sleep(0.05)
                raise RuntimeError("injected attempt-1 failure")
            return {
                "taskid": taskid,
                "process_id": 0,
                "num_processes": num_processes,
            }

        monkeypatch.setattr(sched_mod, "run_worker_subprocess", fake_rws)

        fx = SchedulerFixture(multiproc=True, prepare_timeout=15.0)
        labor1 = Labor("127.0.0.1", fx.port)
        fut1 = fx.run_coro(labor1.run())
        fut2 = None
        try:
            for _ in range(100):
                if len(fx.scheduler.labors) == 1:
                    break
                time.sleep(0.05)
            assert len(fx.scheduler.labors) == 1

            task_file = tmp_path / "task.pb"
            task_file.write_text(
                'nepochs : 1\ntrain_set : "t.txt"\n'
                'user_factors : "%s"\nitem_factors : "%s"\n'
                % (tmp_path / "u.dat", tmp_path / "i.dat")
            )
            rsp = submit_task_file("127.0.0.1", fx.port, str(task_file))
            assert rsp["status"] == "OK"

            # wait until attempt 1 is in flight, THEN attach the new labor
            for _ in range(200):
                if calls["p0"] >= 1:
                    break
                time.sleep(0.05)
            assert calls["p0"] == 1, "attempt 1 never started"
            labor2 = Labor("127.0.0.1", fx.port)
            fut2 = fx.run_coro(labor2.run())
            for _ in range(100):
                if len(fx.scheduler.labors) == 2:
                    break
                time.sleep(0.05)
            assert len(fx.scheduler.labors) == 2
            l2_attached.set()  # release attempt 1 into its injected failure

            for _ in range(600):
                status = scheduler_status("127.0.0.1", fx.port)
                if status["history"] and status["history"][-1]["state"] in (
                    "done",
                    "failed",
                ):
                    break
                time.sleep(0.05)
            last = status["history"][-1]
            assert last["state"] == "done", last
            # the retry absorbed the newcomer: 2 labors + process 0
            assert last["result"]["attempts"] == 2, last["result"]
            assert len(last["result"]["labors"]) == 2, last["result"]
            assert last["result"]["num_processes"] == 3, last["result"]
        finally:
            fut1.cancel()
            if fut2 is not None:
                fut2.cancel()
            fx.close()

    def test_quorum_miss_falls_back_to_local(self, tmp_path):
        """No labors ready within the prepare window -> the task still runs
        (single-process), mirroring the reference's tolerance of a shrunken
        worker set (RunOneTask.cpp reassigns buckets rather than failing)."""
        results = []
        fx = SchedulerFixture(
            runner=_fake_runner(results), multiproc=True, prepare_timeout=0.5
        )
        # attach a raw client that never answers task_prepare
        import socket
        import time

        sock = socket.create_connection(("127.0.0.1", fx.port))
        try:
            sock.sendall(protocol.encode_frame({"kind": "attach_labor"}))
            # read the attach ack so the frame isn't confused for a reply
            buf = sock.recv(4096)
            assert buf[:4] == protocol.MAGIC
            for _ in range(100):
                if fx.scheduler.labors:
                    break
                time.sleep(0.05)

            task_file = tmp_path / "task.pb"
            task_file.write_text(
                'nepochs : 1\ntrain_set : "t.txt"\n'
                'user_factors : "u.dat"\nitem_factors : "i.dat"\n'
            )
            # exercise the quorum gate directly (the runner-loop gate would
            # route a fake-runner scheduler around multiproc entirely)
            td = parse_taskdef(task_file.read_text())

            async def go():
                return await fx.scheduler._run_multiproc(td, taskid=99)

            result = fx.run_coro(go()).result(30)
            # fell back to the (fake) local runner (first attempt)
            assert result == {"ok": True, "taskid": 99, "attempts": 1}
            assert results == [(99, "t.txt")]
        finally:
            sock.close()
            fx.close()
