"""Scheduler: job-queue daemon for distributed WALS training.

Device-side re-design of the reference Scheduler + RunOneTask (reference
distributed/scheduler/Scheduler.cpp, RunOneTask.cpp). What changed and why:

- The reference scheduler was also the data plane: it broadcast the dataset
  and fixed factors over TCP and scattered 10k-row buckets to labors
  (RunOneTask.cpp:91-150). Here the data plane is SPMD over the device mesh
  (qmf_tpu/parallel/) — compute never leaves the accelerators — so the
  scheduler keeps only the control plane: task queue, labor liveness,
  status, and failure recovery.
- select(2) loop + per-connection read state machine (Scheduler.cpp:112-223,
  Connection.cpp:26-106) -> asyncio streams.
- EQueue task queue (common/EQueue.h) -> asyncio.Queue consumed by a
  single runner task (the reference also ran one task at a time,
  Scheduler.cpp:395-417).
- Heartbeat/recovery: per-labor timestamps refreshed on any message; labors
  stale for > HEARTBEAT_INTERVAL_S get a heartbeat probe and report their
  (taskid, epoch) back (kInfoRsp analog); dead labors are dropped
  (Scheduler.cpp:363-393). Intra-task recovery is per-epoch
  checkpoint/resume (qmf_tpu/utils/checkpoint.py) instead of per-bucket
  reassignment — the epoch is the recovery unit because it is one device
  program.
- wals_submit sent a task-file *path* and assumed a shared filesystem
  (reference wals_submit.cpp:27-91, Connection.cpp:152-156). Here submit
  sends the TextFormat *content* (path mode still accepted for
  compatibility).
- Mid-task elastic attach (reference: any-time kAttachLabor + stale-state
  re-push lets a new labor pick up buckets mid-epoch, Connection.cpp:
  186-196, 307-413): DELIBERATELY NOT mirrored for healthy runs. A
  jax.distributed process group is fixed at rendezvous, so absorbing a new
  labor would mean aborting the in-flight attempt and restarting from the
  last checkpoint — strictly worse than letting the healthy attempt finish
  (the reference gained mid-epoch elasticity only because its work unit
  was a 10k-row bucket; ours is a full epoch on the mesh). New labors ARE
  absorbed at every natural boundary: the next task, AND every failure
  retry (each retry re-runs the quorum over the currently-attached set,
  see _run_multiproc) — so elasticity is lost only while a run needs no
  recovery, exactly when extra workers buy nothing.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import Any, Dict, List, Optional

from qmf_tpu.distributed import protocol
from qmf_tpu.distributed.taskdef import TaskDef, load_taskdef, parse_taskdef
from qmf_tpu.utils.logging import log


class LaborInfo:
    def __init__(self, peer: str):
        self.peer = peer
        self.last_seen = time.monotonic()
        self.taskid: int = 0
        self.epoch: int = 0
        self.writer: Optional[asyncio.StreamWriter] = None
        # monotonic time a heartbeat probe was sent, None when not probing;
        # any inbound message clears it (the probe reply arrived)
        self.probe_sent: Optional[float] = None

    def touch(self):
        self.last_seen = time.monotonic()
        self.probe_sent = None

    @property
    def stale_s(self) -> float:
        return time.monotonic() - self.last_seen


class Scheduler:
    """Async TCP server + task runner."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 8900,
        runner=None,
        heartbeat_interval: float = protocol.HEARTBEAT_INTERVAL_S,
        multiproc: bool = True,
        coordinator_host: str = "127.0.0.1",
        n_local_devices: int = 0,
        prepare_timeout: float = 10.0,
        task_retries: int = 2,
        worker_timeout: float = 3600.0,
    ):
        self.host = host
        self.port = port
        self.labors: Dict[str, LaborInfo] = {}
        self.queue: asyncio.Queue = asyncio.Queue()
        self.history: list = []
        self.current: Optional[Dict[str, Any]] = None
        self.taskid = 0
        self._runner = runner if runner is not None else run_task
        self._hb_interval = heartbeat_interval
        self._server: Optional[asyncio.AbstractServer] = None
        self._tasks: list = []
        # multi-process training (jax.distributed rendezvous across labors)
        self.multiproc = multiproc
        self.coordinator_host = coordinator_host
        self.n_local_devices = n_local_devices
        self.prepare_timeout = prepare_timeout
        # how many times a failed/timed-out multi-process attempt is retried
        # (each retry re-runs the quorum with the currently-attached labors
        # and resumes from the shared per-epoch checkpoint)
        self.task_retries = task_retries
        # hard wall per multi-process attempt (last-resort backstop behind
        # the active failure signals above)
        self.worker_timeout = worker_timeout
        self._ready_taskid = 0
        self._ready_peers: set = set()
        self._ready_event: Optional[asyncio.Event] = None
        self._done_peers: Dict[str, Dict[str, Any]] = {}
        # set when any labor reports task_done rc != 0 for the current task
        # (a broken rendezvous hangs the survivors; this is the active
        # failure-detection signal that triggers kill + retry)
        self._fail_event: Optional[asyncio.Event] = None
        # peers participating in the in-flight multi-process attempt; if one
        # of THEM detaches or is heartbeat-dropped, the rendezvous is just
        # as broken as on an rc!=0 report (the labor host died entirely, so
        # no task_done will ever arrive) — same fail signal
        self._active_peers: set = set()

    # --- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_client, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._tasks.append(asyncio.create_task(self._task_runner_loop()))
        self._tasks.append(asyncio.create_task(self._heartbeat_loop()))
        log.info("scheduler listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        await self._server.serve_forever()

    # --- connection handling --------------------------------------------------
    async def _handle_client(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        peer = "%s:%d" % writer.get_extra_info("peername")[:2]
        try:
            while True:
                msg = await protocol.read_frame(reader)
                if msg is None:
                    break
                if peer in self.labors:
                    self.labors[peer].touch()
                reply = await self._dispatch(msg, peer, writer)
                if reply is not None:
                    await protocol.write_frame(writer, reply)
        except (protocol.ProtocolError, ConnectionError) as e:
            log.warning("connection %s dropped: %s", peer, e)
        finally:
            if peer in self.labors:
                del self.labors[peer]
                log.info("labor %s detached (%d left)", peer, len(self.labors))
                self._notice_labor_loss(peer)
            writer.close()

    def _notice_labor_loss(self, peer: str) -> None:
        """A labor left; if it was part of the in-flight multi-process
        attempt, flag the attempt failed (its worker died with its host —
        no task_done will arrive; reference analog: buckets of dead labors
        get reassigned, RunOneTask.cpp:177-240)."""
        if peer in self._active_peers and self._fail_event is not None:
            log.warning(
                "labor %s lost mid-run — aborting the attempt for retry", peer
            )
            self._fail_event.set()

    async def _dispatch(
        self, msg: Dict[str, Any], peer: str, writer: asyncio.StreamWriter
    ) -> Optional[Dict[str, Any]]:
        kind = msg.get("kind")
        if kind == "submit_task":
            return await self._on_submit(msg)
        if kind == "attach_labor":
            info = LaborInfo(peer)
            info.writer = writer
            self.labors[peer] = info
            log.info("labor %s attached (%d total)", peer, len(self.labors))
            return {"kind": "attach_labor_rsp", "status": "OK", "peer": peer}
        if kind == "info_rsp":
            if peer in self.labors:
                self.labors[peer].taskid = msg.get("taskid", 0)
                self.labors[peer].epoch = msg.get("epoch", 0)
            return None
        if kind == "task_ready":
            # readiness ack for the two-phase multi-process start (quorum
            # analog of kPushRateRsp acks, reference RunOneTask.cpp:91-107)
            if (
                msg.get("taskid") == self._ready_taskid
                and peer in self.labors
            ):
                self._ready_peers.add(peer)
                if self._ready_event is not None:
                    self._ready_event.set()
            return None
        if kind == "task_done":
            self._done_peers[peer] = msg
            log.info(
                "labor %s finished task %s (rc=%s)",
                peer,
                msg.get("taskid"),
                msg.get("rc"),
            )
            if (
                msg.get("rc", 0) != 0
                and self.current is not None
                and msg.get("taskid") == self.current.get("taskid")
                and self._fail_event is not None
                # retries reuse the taskid, so a stale failure report from an
                # aborted labor that missed this attempt's quorum window must
                # not abort the healthy attempt: only participants of the
                # in-flight attempt can fail it
                and peer in self._active_peers
            ):
                self._fail_event.set()
            return None
        if kind == "progress":
            # mid-task observability (per-bucket progress analog, reference
            # RunOneTask.cpp:208-212): labors forward their worker's
            # per-epoch progress; status_rsp exposes it live
            if peer in self.labors:
                self.labors[peer].epoch = msg.get("epoch", 0)
                self.labors[peer].taskid = msg.get(
                    "taskid", self.labors[peer].taskid
                )
            self._record_progress(peer, msg)
            return None
        if kind == "status":
            return {
                "kind": "status_rsp",
                "queued": self.queue.qsize(),
                "current": self.current,
                "labors": {
                    p: {
                        "stale_s": round(li.stale_s, 1),
                        "taskid": li.taskid,
                        "epoch": li.epoch,
                    }
                    for p, li in self.labors.items()
                },
                "history": self.history[-20:],
            }
        if kind == "heartbeat":
            return {
                "kind": "info_rsp",
                "taskid": self.taskid,
                "epoch": self._current_epoch(),
            }
        return {"kind": "error", "message": f"unknown kind {kind!r}"}

    async def _on_submit(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        try:
            if "task_text" in msg:
                td = parse_taskdef(msg["task_text"])
            elif "task_path" in msg:  # reference compatibility mode
                td = load_taskdef(msg["task_path"])
            elif "task" in msg:
                td = TaskDef.from_dict(msg["task"])
                td.validate()
            else:
                raise ValueError("submit_task needs task_text|task_path|task")
        except (ValueError, OSError) as e:
            return {"kind": "submit_task_rsp", "status": "FAIL", "error": str(e)}
        self.taskid += 1
        item = {"taskid": self.taskid, "task": td.to_dict(), "state": "queued"}
        await self.queue.put(item)
        log.info("task %d queued: %s", self.taskid, td.train_set)
        return {"kind": "submit_task_rsp", "status": "OK", "taskid": self.taskid}

    # --- background loops -------------------------------------------------------
    async def _task_runner_loop(self) -> None:
        while True:
            item = await self.queue.get()
            self.current = item
            item["state"] = "running"
            item["started"] = time.time()
            await self._announce_task(item)
            try:
                td = TaskDef.from_dict(item["task"])
                if self.multiproc and self.labors and self._runner is run_task:
                    result = await self._run_multiproc(td, item["taskid"])
                else:
                    result = await self._run_local(td, item["taskid"])
                item["state"] = "done"
                item["result"] = result
            except Exception as e:  # task failures must not kill the daemon
                log.error("task %d failed: %s", item["taskid"], e)
                item["state"] = "failed"
                item["error"] = str(e)
            item["finished"] = time.time()
            self.history.append(
                {k: item[k] for k in item if k not in ("task",)}
            )
            self.current = None

    async def _broadcast(self, msg: Dict[str, Any], peers=None) -> list:
        """Send a frame to labors (all, or the given peers); drops dead ones.
        Returns the peers actually reached."""
        sent = []
        dead = []
        targets = list(peers) if peers is not None else list(self.labors)
        for peer in targets:
            li = self.labors.get(peer)
            if li is None:
                continue
            try:
                await protocol.write_frame(li.writer, msg)
                sent.append(peer)
            except (ConnectionError, RuntimeError):
                dead.append(peer)
        for peer in dead:
            self._drop_labor(peer)
        return sent

    def _drop_labor(self, peer: str) -> None:
        """Remove a labor AND close its connection: closing the socket makes
        the labor's read loop return EOF so its CLI reconnect-with-backoff
        kicks in — without the close a slow-but-alive labor would keep its
        healthy TCP connection, think it is still attached, and become a
        permanent zombie the scheduler never uses again."""
        li = self.labors.pop(peer, None)
        if li is None:
            return
        if li.writer is not None:
            try:
                li.writer.close()
            except RuntimeError:
                pass
        self._notice_labor_loss(peer)

    def _current_epoch(self) -> int:
        """Epoch the running task has reached (max over worker progress
        reports; the reference put the live epchoid in every reply header,
        Message.h:100-104)."""
        if self.current is None:
            return 0
        prog = self.current.get("progress") or {}
        return max((p.get("epoch", 0) for p in prog.values()), default=0)

    def _record_progress(self, who: str, prog: Dict[str, Any]) -> None:
        """Attach per-worker progress to the running task (status_rsp shows
        it live); `who` is a labor peer or "scheduler" for process 0."""
        if self.current is not None and prog.get("taskid") == self.current.get(
            "taskid"
        ):
            self.current.setdefault("progress", {})[who] = {
                "epoch": prog.get("epoch", 0),
                "nepochs": prog.get("nepochs", 0),
                "loss": prog.get("loss"),
                "wall_s": prog.get("wall_s"),
            }

    async def _run_local(self, td: TaskDef, taskid: int) -> Dict[str, Any]:
        """Single-process task execution. With the real runner this spawns a
        fresh worker SUBPROCESS (num_processes=1): the long-lived daemon
        must never initialize the accelerator in-process — a JAX process
        reserves most of a card's memory when it first touches it and keeps
        it for its lifetime, so every later worker pinned to that card
        would fail for want of memory. Injected runners (tests) still run
        in-thread."""
        if self._runner is run_task:
            result = await run_worker_subprocess(
                td,
                taskid=taskid,
                coordinator="",
                num_processes=1,
                process_id=0,
                n_local_devices=self.n_local_devices,
                timeout=self.worker_timeout,
                on_progress=lambda p: self._record_progress("scheduler", p),
            )
            # success: the per-epoch recovery state is obsolete (run_task
            # cleans up after itself; the subprocess path must too)
            import shutil

            from qmf_tpu.distributed.worker import default_ckpt_dir

            shutil.rmtree(default_ckpt_dir(td, taskid), ignore_errors=True)
            return result
        return await asyncio.to_thread(self._runner, td, taskid)

    async def _run_multiproc(self, td: TaskDef, taskid: int) -> Dict[str, Any]:
        """Fault-tolerant multi-process training: run attempts until one
        succeeds (up to 1 + task_retries). Every attempt checkpoints per
        epoch to a shared directory keyed by taskid and auto-resumes from
        LATEST, so a killed worker costs at most one epoch — the recovery
        semantics of the reference's per-bucket reassignment + stale-state
        re-push (RunOneTask.cpp:177-240, Connection.cpp:307-413), with the
        epoch as the recovery unit. The final attempt's failure propagates.
        """
        from qmf_tpu.distributed.worker import default_ckpt_dir

        last_err: Optional[Exception] = None
        for attempt in range(1 + self.task_retries):
            if attempt:
                log.warning(
                    "task %d: attempt %d failed (%s) — retrying with %d "
                    "attached labors (resume from checkpoint)",
                    taskid, attempt, last_err, len(self.labors),
                )
            try:
                result = await self._run_multiproc_once(td, taskid)
                result["attempts"] = attempt + 1
                # task finished: the per-epoch recovery state is obsolete
                import shutil

                shutil.rmtree(
                    default_ckpt_dir(td, taskid), ignore_errors=True
                )
                return result
            except Exception as e:  # noqa: BLE001 — every attempt may fail
                last_err = e
        raise RuntimeError(
            f"task {taskid} failed after {1 + self.task_retries} attempts: "
            f"{last_err}"
        )

    async def _run_multiproc_once(
        self, td: TaskDef, taskid: int
    ) -> Dict[str, Any]:
        """One attempt of two-phase multi-process training.

        Phase 1 (readiness/quorum, reference RunOneTask.cpp:91-107): announce
        `task_prepare`, wait up to prepare_timeout for acks; require at least
        floor(n/2)+1 or fall back to a local single-process run.
        Phase 2: assign process ids, send `task_start` with the
        jax.distributed coordinator address, and run this process's worker
        as process 0; every process co-executes the sharded SPMD program
        (qmf_tpu/distributed/worker.py). If any labor reports a failed
        worker mid-run, process 0's worker is killed immediately (the
        rendezvous is broken; survivors would hang on collectives) and the
        attempt raises for the retry loop.
        """
        import socket as _socket

        n_labors = len(self.labors)
        quorum = n_labors // 2 + 1
        self._ready_taskid = taskid
        self._ready_peers = set()
        self._done_peers = {}
        self._ready_event = asyncio.Event()
        asked = await self._broadcast(
            {"kind": "task_prepare", "taskid": taskid}
        )
        deadline = time.monotonic() + self.prepare_timeout
        while len(self._ready_peers) < len(asked):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            self._ready_event.clear()
            try:
                await asyncio.wait_for(self._ready_event.wait(), remaining)
            except asyncio.TimeoutError:
                break
        ready = sorted(self._ready_peers & set(self.labors))
        if len(ready) < quorum:
            log.warning(
                "task %d: only %d/%d labors ready (quorum %d) — "
                "running single-process locally",
                taskid,
                len(ready),
                n_labors,
                quorum,
            )
            return await self._run_local(td, taskid)

        # pick a coordinator port (process 0 = this host's worker)
        with _socket.socket() as s:
            s.bind((self.coordinator_host, 0))
            coord_port = s.getsockname()[1]
        coordinator = f"{self.coordinator_host}:{coord_port}"
        num_processes = 1 + len(ready)
        check_local_quorum(
            1 + sum(_is_local_peer(p, self.coordinator_host) for p in ready),
            self.n_local_devices,
        )
        log.info(
            "task %d: starting %d-process run (coordinator %s, labors %s)",
            taskid,
            num_processes,
            coordinator,
            ready,
        )
        self._fail_event = asyncio.Event()
        self._active_peers = set(ready)
        for i, peer in enumerate(ready):
            await self._broadcast(
                {
                    "kind": "task_start",
                    "taskid": taskid,
                    "task": td.to_dict(),
                    "coordinator": coordinator,
                    "num_processes": num_processes,
                    "process_id": i + 1,
                    "n_local_devices": self.n_local_devices,
                    "worker_timeout": self.worker_timeout,
                },
                peers=[peer],
            )
        holder: Dict[str, Any] = {}
        worker = asyncio.create_task(
            run_worker_subprocess(
                td,
                taskid=taskid,
                coordinator=coordinator,
                num_processes=num_processes,
                process_id=0,
                n_local_devices=self.n_local_devices,
                timeout=self.worker_timeout,
                proc_holder=holder,
                on_progress=lambda p: self._record_progress("scheduler", p),
            )
        )
        fail = asyncio.create_task(self._fail_event.wait())
        try:
            done, _ = await asyncio.wait(
                {worker, fail}, return_when=asyncio.FIRST_COMPLETED
            )
            if worker not in done:
                # a labor's worker died: the rendezvous is broken and the
                # survivors (incl. our process 0) would hang on the next
                # collective — kill ours, tell every surviving labor to
                # kill ITS worker too (otherwise they stay wedged on dead
                # collectives and cannot ack the retry's quorum), and let
                # the retry loop recover
                proc = holder.get("proc")
                if proc is not None and proc.returncode is None:
                    proc.kill()
                else:
                    # fail event raced the subprocess spawn: arm the
                    # deferred kill run_worker_subprocess executes as soon
                    # as 'proc' exists (same race the labor side closes)
                    holder["aborted"] = True
                await self._broadcast(
                    {"kind": "task_abort", "taskid": taskid},
                    peers=self._active_peers & set(self.labors),
                )
                try:
                    await worker
                except Exception:  # noqa: BLE001 — expected: we killed it
                    pass
                raise RuntimeError(
                    "a labor worker failed mid-task; rendezvous aborted"
                )
            result = await worker
        except BaseException:
            # process-0 worker failure/timeout: abort the survivors too
            await self._broadcast(
                {"kind": "task_abort", "taskid": taskid},
                peers=self._active_peers & set(self.labors),
            )
            raise
        finally:
            fail.cancel()
            self._fail_event = None
            self._active_peers = set()
        result["labors"] = ready
        return result

    async def _announce_task(self, item: Dict[str, Any]) -> None:
        """Tell attached labors which task is active (kPushRate-era sync,
        control part only — the data rides the accelerator interconnect).
        Delegates to _broadcast, which snapshots the labor set first — a
        labor attaching/detaching while a write awaits must not blow up the
        task-runner loop with a dict-mutation RuntimeError."""
        await self._broadcast(
            {
                "kind": "task_announce",
                "taskid": item["taskid"],
                "task": item["task"],
            }
        )

    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(min(self._hb_interval / 3, 1.0))
            dead = []
            # snapshot: the probe write awaits, during which labors may
            # attach/detach — iterating the live dict would raise and
            # silently kill this loop (disabling failure detection forever)
            for peer, li in list(self.labors.items()):
                if peer not in self.labors:
                    continue  # detached while an earlier probe awaited
                if li.probe_sent is not None:
                    # probed and still silent: one interval to reply, then drop
                    # (a hung-but-connected labor must not be re-touched,
                    # reference drops on staleness, Scheduler.cpp:380-389)
                    if time.monotonic() - li.probe_sent > self._hb_interval:
                        dead.append(peer)
                elif li.stale_s > self._hb_interval:
                    try:
                        await protocol.write_frame(
                            li.writer, {"kind": "heartbeat"}
                        )
                        li.probe_sent = time.monotonic()
                    except (ConnectionError, RuntimeError):
                        dead.append(peer)
            for peer in dead:
                log.warning("labor %s dead, dropping", peer)
                self._drop_labor(peer)


def visible_cards(environ: Optional[Dict[str, str]] = None) -> List[str]:
    """The NVIDIA cards this host exposes to a child process, found without
    opening them (the daemon and labor agents stay off the accelerator):
    the CUDA_VISIBLE_DEVICES list when set, else the /dev/nvidia<N> nodes."""
    import re

    env = os.environ if environ is None else environ
    listed = env.get("CUDA_VISIBLE_DEVICES")
    if listed is not None:
        return [c.strip() for c in listed.split(",") if c.strip()]
    try:
        nodes = os.listdir("/dev")
    except OSError:
        return []
    return sorted(
        (n[len("nvidia"):] for n in nodes if re.fullmatch(r"nvidia\d+", n)),
        key=int,
    )


def _is_local_peer(peer: str, coordinator_host: str) -> bool:
    host = peer.rsplit(":", 1)[0]
    return host in ("127.0.0.1", "localhost", "::1", coordinator_host)


def check_local_quorum(n_local_processes: int, n_local_devices: int,
                       cards: Optional[List[str]] = None) -> None:
    """Refuse a run that puts more worker processes on this host than it
    has cards: a JAX process reserves most of its card's memory, so two
    workers cannot share one. Virtual-CPU workers need no card."""
    if n_local_devices:
        return
    cards = visible_cards() if cards is None else cards
    if cards and n_local_processes > len(cards):
        raise RuntimeError(
            f"{n_local_processes} worker processes on this host but only "
            f"{len(cards)} cards: each worker needs a card of its own"
        )


def worker_env(process_id: int, n_local_devices: int,
               environ: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment for worker ``process_id``: pinned to one card.

    Each worker sees exactly one card (CUDA_VISIBLE_DEVICES), chosen from
    this host's visible cards by process id, so co-located workers never
    open the same card. Virtual-CPU workers (n_local_devices > 0) and
    hosts without cards get the environment unchanged.
    """
    env = dict(os.environ if environ is None else environ)
    if n_local_devices:
        return env
    cards = visible_cards(env)
    if cards:
        env["CUDA_VISIBLE_DEVICES"] = cards[process_id % len(cards)]
    return env


async def run_worker_subprocess(
    td: TaskDef,
    taskid: int,
    coordinator: str,
    num_processes: int,
    process_id: int,
    n_local_devices: int = 0,
    timeout: float = 3600.0,
    proc_holder: Optional[Dict[str, Any]] = None,
    on_progress=None,
) -> Dict[str, Any]:
    """Spawn one training worker process and await its result JSON.

    A fresh subprocess per task because a jax.distributed rendezvous is
    once-per-process-lifetime (the reference kept long-lived labors because
    its protocol was stateless per bucket; ours binds a process group).

    ``proc_holder`` (if given) receives {"proc": Process, "pid": int} as
    soon as the worker is spawned, so the caller can kill it on external
    failure signals. ``on_progress`` (if given) is called with each new
    per-epoch progress dict the worker writes (see worker.run_worker).
    """
    import json
    import sys
    import tempfile

    with tempfile.NamedTemporaryFile(
        mode="w", suffix=f".task{taskid}.json", delete=False
    ) as f:
        json.dump(td.to_dict(), f)
        task_path = f.name
    result_path = task_path + ".result"
    progress_path = task_path + ".progress"
    cmd = [
        sys.executable,
        "-m",
        "qmf_tpu.distributed.worker",
        "--task-json",
        "@" + task_path,
        "--coordinator",
        coordinator,
        "--num-processes",
        str(num_processes),
        "--process-id",
        str(process_id),
        "--n-local-devices",
        str(n_local_devices),
        "--taskid",
        str(taskid),
        "--result",
        result_path,
        "--progress",
        progress_path,
    ]
    proc = await asyncio.create_subprocess_exec(
        *cmd,
        stdout=asyncio.subprocess.PIPE,
        stderr=asyncio.subprocess.STDOUT,
        env=worker_env(process_id, n_local_devices),
    )
    if proc_holder is not None:
        proc_holder["proc"] = proc
        proc_holder["pid"] = proc.pid
        if proc_holder.get("aborted"):
            # an abort signal raced the spawn (the caller saw no 'proc' to
            # kill and armed this flag instead — both the scheduler's
            # fail-event path and the labor's task_abort use it)
            proc.kill()

    async def _tail_progress():
        last = None
        while True:
            await asyncio.sleep(0.25)
            try:
                with open(progress_path) as pf:
                    raw = pf.read()
            except OSError:
                continue
            if raw and raw != last:
                last = raw
                try:
                    prog = json.loads(raw)
                except ValueError:
                    continue  # torn read is impossible (atomic replace),
                    # but stay defensive
                if on_progress is not None:
                    on_progress(prog)

    poller = asyncio.create_task(_tail_progress()) if on_progress else None
    try:
        out, _ = await asyncio.wait_for(proc.communicate(), timeout)
    except asyncio.TimeoutError:
        proc.kill()
        raise RuntimeError(f"worker process {process_id} timed out")
    except asyncio.CancelledError:
        # the awaiting task was cancelled (labor connection closed,
        # scheduler shutdown): the subprocess must die with it, or a live
        # training process keeps the accelerator wedged on dead collectives
        # until its own timeout wall
        if proc.returncode is None:
            proc.kill()
        raise
    finally:
        if poller is not None:
            poller.cancel()
        import os as _os

        for p in (task_path, progress_path):
            try:
                _os.unlink(p)
            except OSError:
                pass
    if proc.returncode != 0:
        tail = out.decode(errors="replace")[-2000:]
        raise RuntimeError(
            f"worker process {process_id} failed (rc={proc.returncode}):\n{tail}"
        )
    import os as _os

    with open(result_path) as f:
        result = json.load(f)
    _os.unlink(result_path)
    return result


def run_task(td: TaskDef, taskid: int) -> Dict[str, Any]:
    """Execute one training task on the local mesh (the RunOneTask analog,
    reference RunOneTask.cpp:38-158) with per-epoch checkpoint/resume.

    Uses the same shared checkpoint directory as the multi-process workers
    (worker.default_ckpt_dir), so a task falling back from a broken
    multi-process attempt resumes instead of restarting."""
    import shutil

    import jax

    from qmf_tpu.config import WALSConfig
    from qmf_tpu.data import read_dataset
    from qmf_tpu.distributed.worker import default_ckpt_dir
    from qmf_tpu.parallel import ShardedWALSEngine

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
    # x64 is a process-global switch and this daemon is long-lived: scope
    # it to the task so a later float32 task isn't traced under x64
    x64_before = jax.config.read("jax_enable_x64")
    if td.dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        engine = ShardedWALSEngine(cfg)
        engine.init(read_dataset(td.train_set))
        engine.enable_checkpointing(default_ckpt_dir(td, taskid))
        t0 = time.time()
        engine.optimize()
        engine.save_user_factors(td.user_factors)
        engine.save_item_factors(td.item_factors)
    finally:
        jax.config.update("jax_enable_x64", x64_before)
    shutil.rmtree(default_ckpt_dir(td, taskid), ignore_errors=True)
    return {
        "nusers": engine.nusers,
        "nitems": engine.nitems,
        "devices": len(jax.devices()),
        "wall_s": round(time.time() - t0, 3),
    }
