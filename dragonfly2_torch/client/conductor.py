"""Peer task conductor — one per (task, peer): the client hot path.

Counterpart of the reference's ``client/conductor.py``.

Role parity: upstream client/daemon/peer/peertask_conductor.go:68-1584 —
register with the scheduler (:249), ingest parent assignments from the
announce stream (:659-774), fan piece downloads across workers
(:976-1108), fall back to the origin when told to (:485-523), and report
every piece + the final result back up the stream (which is what produces
the scheduler's Download training records).

The v2 AnnouncePeer bidi stream replaces the upstream's v1
RegisterPeerTask/ReportPieceResult pair; piece *bytes* still ride HTTP
from the parent's upload server.
"""

# dfanalyze: hot — per-piece accounting and the per-peer run loop

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from dragonfly2_torch.rpc import protos
common_pb2 = protos.load("common_pb2")
dfdaemon_pb2 = protos.load("dfdaemon_pb2")
scheduler_pb2 = protos.load("scheduler_pb2")

from dragonfly2_torch.rpc import glue, resilience
from dragonfly2_torch.scheduler import fleet
from dragonfly2_torch.utils import tracing

from dragonfly2_torch.client import downloader
from dragonfly2_torch.client.downloader import PieceDownloadError
from dragonfly2_torch.client.synchronizer import PieceTaskSynchronizer
from dragonfly2_torch.client.piece_manager import (
    ParentInfo,
    PieceDispatcher,
    PieceManager,
    PieceResult,
    TRAFFIC_REMOTE_PEER,
)
from dragonfly2_torch.client.pieces import PieceRange, parse_byte_range, piece_ranges
from dragonfly2_torch.client.storage import StorageManager
from dragonfly2_torch.client import metrics as M
from dragonfly2_torch.utils import dflog, faults, flight, profiling

logger = dflog.get("client.conductor")

# dfprof phase: time spent waiting for an in-progress parent to produce
# a piece it hasn't written yet — the piece path's third wall leg next
# to daemon.piece_read / daemon.piece_write (piece_manager)
PH_PARENT_WAIT = profiling.phase_type("daemon.parent_wait")

# fault point: the announce-stream open — chaos schedules kill the
# scheduler link here to drill the reconnect-with-resume path
FP_ANNOUNCE_STREAM = faults.point("daemon.announce_stream")

# flight-recorder emitters: the peer/piece lifecycle as the daemon saw
# it — the always-on black box a wedged peer postmortem replays
EV_PEER_START = flight.event_type("daemon.peer_start")
EV_PEER_DECISION = flight.event_type("daemon.peer_decision")
EV_PEER_FINISHED = flight.event_type("daemon.peer_finished")
EV_PEER_FAILED = flight.event_type("daemon.peer_failed")
EV_PEER_BACK_TO_SOURCE = flight.event_type("daemon.peer_back_to_source")
EV_PIECE_DONE = flight.event_type("daemon.piece_done")
EV_PIECE_FAILED = flight.event_type("daemon.piece_failed")
EV_PARENT_BLOCKED = flight.event_type("daemon.parent_blocked")
EV_RESCHEDULE = flight.event_type("daemon.reschedule")
EV_ANNOUNCE_RECONNECT = flight.event_type("daemon.announce_reconnect")
EV_WRONG_SHARD_REPICK = flight.event_type("daemon.wrong_shard_repick")


@dataclass
class Progress:
    completed_length: int = 0
    content_length: int = -1
    done: bool = False
    error: str = ""


@dataclass
class ConductorOptions:
    piece_workers: int = 4
    schedule_timeout: float = 10.0
    piece_retry: int = 3
    # consecutive hard failures before a parent is blocked for the task —
    # one transient timeout must not escalate to back-to-source
    parent_fail_limit: int = 3
    # wait between retries when a parent 404s a piece it may write soon
    not_found_backoff: float = 0.05
    # total time budget to wait for an in-progress parent to produce an
    # unadvertised piece — separate from piece_retry, so a slightly-slow
    # swarm doesn't force a full reschedule round-trip every ~150ms
    wait_piece_timeout: float = 5.0
    disable_back_source: bool = False
    piece_length: int = 0  # 0 = derive from content length
    # announce-stream resume: a broken scheduler stream (restart, network
    # blip) re-opens and re-registers this many times before the old
    # fail/back-to-source behavior kicks in — the peer task survives the
    # scheduler's incident instead of paying an origin round trip for it
    stream_reconnect_attempts: int = 3
    stream_reconnect_backoff: float = 0.2
    # WRONG_SHARD retry budget (docs/fleet.md): a refused announce
    # re-picks from the refreshed ring for this long before the regular
    # reconnect/back-to-source ladder takes over. Sized to cover one
    # lease TTL + one membership poll — the window in which a SIGKILL'd
    # owner is still leased and every member keeps pointing at it
    wrong_shard_retry_window: float = 15.0
    wrong_shard_backoff: float = 0.1


class PeerTaskConductor:
    """Drives one peer's download of one task end to end."""

    def __init__(
        self,
        task_id: str,
        peer_id: str,
        host_id: str,
        url: str,
        url_meta: common_pb2.UrlMeta,
        storage: StorageManager,
        scheduler_client,
        piece_manager: PieceManager | None = None,
        options: ConductorOptions | None = None,
        task_type: int = 0,
        headers: dict | None = None,
        need_back_to_source: bool = False,
        on_done=None,
    ):
        self.task_id = task_id
        self.peer_id = peer_id
        self.host_id = host_id
        self.url = url
        self.url_meta = url_meta
        self.storage = storage
        self.scheduler = scheduler_client
        self.pm = piece_manager or PieceManager()
        self.opts = options or ConductorOptions()
        self.task_type = task_type
        self.headers = headers or {}
        self.need_back_to_source = need_back_to_source
        self.on_done = on_done

        self.ts = storage.register_task(
            task_id,
            peer_id,
            url=url,
            piece_length=self.opts.piece_length,
            tag=url_meta.tag,
            application=url_meta.application,
        )
        self.ts.busy = True  # owned by this conductor until finish/fail
        self._requests: "queue.Queue[scheduler_pb2.AnnouncePeerRequest | None]" = queue.Queue()
        self._decisions: "queue.Queue[object]" = queue.Queue()
        self._progress_subs: list["queue.Queue[Progress]"] = []
        self._lock = threading.Lock()
        self._completed = 0
        self._blocked_parents: set[str] = set()
        self._parent_failures: dict[str, int] = {}
        self._done = threading.Event()
        self._error: str | None = None
        self._started_at = 0.0
        self._stream_thread: threading.Thread | None = None
        self._run_thread: threading.Thread | None = None
        self._stream_reconnects = 0
        self._wrong_shard_deadline = 0.0
        self._wrong_shard_retries = 0
        self._owner_hint = ""  # WRONG_SHARD told us who owns the shard
        self._outage_started = 0.0  # announce-plane blackout clock
        # members this conductor's streams just failed against: a cached
        # channel to a dead scheduler fails at CALL time, not dial time,
        # so the selector needs this feedback to walk past it
        self._avoid_addrs: set[str] = set()
        self._last_sched_addr = ""

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> None:
        M.TASK_TOTAL.labels("file").inc()
        # span per peer task (upstream peertask_conductor.go:123-124)
        self._span = tracing.get("dfdaemon").start_span(
            "peer_task", task_id=self.task_id, peer_id=self.peer_id, url=self.url
        )
        with tracing.use_span(self._span):
            EV_PEER_START(task_id=self.task_id, peer_id=self.peer_id, url=self.url)
        self._started_at = time.monotonic()
        self._stream_thread = threading.Thread(
            target=self._stream_loop,
            name=f"daemon.announce-{self.peer_id[:8]}",
            daemon=True,
        )
        self._stream_thread.start()
        self._run_thread = threading.Thread(
            target=self._run, name=f"daemon.conductor-{self.peer_id[:8]}", daemon=True
        )
        self._run_thread.start()

    def wait(self, timeout: float | None = None) -> Progress:
        self._done.wait(timeout)
        return self.progress()

    def progress(self) -> Progress:
        with self._lock:
            return Progress(
                completed_length=self._completed,
                content_length=self.ts.meta.content_length,
                done=self._done.is_set() and self._error is None,
                error=self._error or "",
            )

    def subscribe(self) -> "queue.Queue[Progress]":
        q: "queue.Queue[Progress]" = queue.Queue()
        with self._lock:
            self._progress_subs.append(q)
        if self._done.is_set():  # already finished — deliver terminal state
            q.put(self.progress())
        return q

    def _publish(self) -> None:
        p = self.progress()
        with self._lock:
            subs = list(self._progress_subs)
        for q in subs:
            q.put(p)

    # ------------------------------------------------------------------
    # announce stream plumbing
    # ------------------------------------------------------------------
    def _req_iter(self, requests):
        # the queue is a parameter, not read off self per iteration: a
        # reconnect swaps self._requests, and the dead stream's feeder
        # must keep draining ITS queue (where its None sentinel went),
        # never steal the replacement stream's re-register
        while True:
            r = requests.get()
            if r is None:
                return
            yield r

    def _send(self, **kwargs) -> None:
        self._requests.put(
            scheduler_pb2.AnnouncePeerRequest(
                host_id=self.host_id, task_id=self.task_id, peer_id=self.peer_id, **kwargs
            )
        )

    def _resolve_scheduler(self):
        """The client for THIS stream attempt. A multi-scheduler selector
        re-resolves per connect — the fleet ring moves at runtime, and a
        reconnect after an owner move must land on the new owner, not the
        member the conductor was born under. A WRONG_SHARD owner hint
        (when fresher than our ring) wins outright."""
        sched = self.scheduler
        if not hasattr(sched, "for_task"):
            return sched  # plain single-scheduler client
        if self._owner_hint and hasattr(sched, "client_for"):
            hint, self._owner_hint = self._owner_hint, ""
            # never chase a hint into a member we just failed against:
            # during a failover the whole fleet keeps naming the dead
            # owner until its lease expires
            if hint not in self._avoid_addrs:
                try:
                    client = sched.client_for(hint)
                    self._last_sched_addr = hint
                    return client
                except Exception as e:
                    logger.warning(
                        "wrong-shard owner hint %s undialable: %s", hint, e
                    )
        if hasattr(sched, "resolve_for_task"):
            addr, client = sched.resolve_for_task(
                self.task_id, avoid=self._avoid_addrs
            )
            self._last_sched_addr = addr
            return client
        return sched.for_task(self.task_id)

    def _stream_loop(self) -> None:
        """Own thread: consumes scheduler responses, queues decisions for
        the run loop (upstream receivePeerPacket :659)."""
        requests = self._requests  # bound once, before any later swap
        try:
            FP_ANNOUNCE_STREAM()
            client = self._resolve_scheduler()
            # the peer_task span is this thread's context for the
            # AnnouncePeer call, so the scheduler's rpc.AnnouncePeer span
            # (and its scheduling children) join the download's trace
            with tracing.use_span(getattr(self, "_span", None)):
                responses = client.AnnouncePeer(self._req_iter(requests))
            for resp in responses:
                which = resp.WhichOneof("response")
                self._decisions.put((which, getattr(resp, which)))
        except Exception as e:  # stream teardown or scheduler gone
            if not self._done.is_set():
                logger.warning("announce stream for %s ended: %s", self.peer_id, e)
                self._decisions.put(("stream_error", str(e)))

    # ------------------------------------------------------------------
    # main run loop
    # ------------------------------------------------------------------
    def _run(self) -> None:
        with tracing.use_span(getattr(self, "_span", None)):
            self._run_traced()

    def _register_request(self) -> "scheduler_pb2.RegisterPeerRequest":
        """The registration message — shared by first registration and
        the announce-stream reconnect re-register, so the two can never
        drift apart field by field."""
        return scheduler_pb2.RegisterPeerRequest(
            task_id=self.task_id,
            peer_id=self.peer_id,
            url=self.url,
            url_meta=self.url_meta,
            task_type=self.task_type,
            need_back_to_source=self.need_back_to_source,
        )

    def _run_traced(self) -> None:
        try:
            self._send(register_peer=self._register_request())
            self._drive()
        except Exception as e:
            logger.exception("conductor %s failed", self.peer_id)
            self._fail(str(e))
        finally:
            self._requests.put(None)

    def _drive(self) -> None:
        while not self._done.is_set():
            try:
                which, body = self._decisions.get(timeout=self.opts.schedule_timeout)
                EV_PEER_DECISION(peer_id=self.peer_id, decision=which)
                if which != "stream_error":
                    self._avoid_addrs.clear()  # the member we're on works
                    # a later failover gets its own retry window AND its
                    # own backoff ramp — the budget bounds one outage,
                    # not the task's lifetime
                    self._wrong_shard_deadline = 0.0
                    self._wrong_shard_retries = 0
                    if self._outage_started:
                        # announce plane recovered: the blackout is the
                        # gap from first stream error to this decision,
                        # and the decision's KIND says whether the
                        # failover was lossless — a parent assignment
                        # means the successor recognized this peer, a
                        # back-to-source means its swarm state was lost
                        fleet.BLACKOUT_MS.observe(
                            (time.monotonic() - self._outage_started) * 1e3
                        )
                        self._outage_started = 0.0
                        kind = (
                            "recognized"
                            if which in ("normal_task", "small_task")
                            else "fallback"
                            if which == "need_back_to_source"
                            else "other"
                        )
                        fleet.FAILOVER_RESUME_TOTAL.labels(kind).inc()
                elif not self._outage_started:
                    self._outage_started = time.monotonic()
            except queue.Empty:
                EV_PEER_DECISION(peer_id=self.peer_id, decision="schedule_timeout")
                # No decision in time: back-source if allowed, else fail
                # (upstream needBackSource fallback :485-523).
                if self.opts.disable_back_source:
                    self._fail("schedule timeout and back-to-source disabled")
                else:
                    self._back_to_source()
                return

            if which == "empty_task":
                self.ts.meta.piece_length = self.ts.meta.piece_length or 1
                if self._complete(0):
                    self._finish(piece_count=0)
                return
            if which == "tiny_task":
                content = body.content
                self.ts.meta.piece_length = max(len(content), 1)
                t0 = time.monotonic()
                pm = self.ts.write_piece(
                    0, 0, content, traffic_type=TRAFFIC_REMOTE_PEER,
                    cost_ns=int((time.monotonic() - t0) * 1e9),
                )
                self._piece_done(PieceResult(pm.number, pm.offset, pm.length, pm.digest, pm.traffic_type, pm.cost_ns, ""))
                if self._complete(len(content)):
                    self._finish(piece_count=1)
                return
            if which == "need_back_to_source":
                if self.opts.disable_back_source:
                    self._fail(f"need back-to-source but disabled: {body.description}")
                    return
                self._back_to_source()
                return
            if which in ("normal_task", "small_task"):
                parents = (
                    list(body.candidate_parents)
                    if which == "normal_task"
                    else [body.candidate_parent]
                )
                if self._download_from_parents(parents):
                    return
                continue  # rescheduled — wait for next decision
            if which == "stream_error":
                # WRONG_SHARD refusal (fleet sharding, docs/fleet.md):
                # this member isn't the task's ring owner — refresh
                # membership, re-pick, and resume with the same peer_id.
                # Its retry budget is time-based and separate from the
                # reconnect attempts: during a failover the whole fleet
                # may point at a still-leased dead owner until the lease
                # expires, and those refusals must not burn the budget
                # that guards against a genuinely broken scheduler.
                ws = fleet.parse_wrong_shard(str(body))
                if ws is not None and self._wrong_shard_repick(*ws):
                    continue
                if ws is None and self._last_sched_addr:
                    # a wire-dead member, not a refusal: route the next
                    # resolve past it (its cached channel can't raise at
                    # resolve time, only here)
                    self._avoid_addrs.add(self._last_sched_addr)
                # resilience: re-open the stream and re-register before
                # giving up — pieces already on disk are resumed by
                # _download_from_parents, and the scheduler re-dispatches
                # a known peer_id by its current state, so a scheduler
                # restart costs a reconnect, not the whole peer task
                if self._reconnect_stream(str(body)):
                    continue
                if self.opts.disable_back_source:
                    self._fail(f"announce stream error: {body}")
                else:
                    self._back_to_source()
                return

    # ------------------------------------------------------------------
    def _restart_stream(self, tag: str) -> None:
        """Swap in a fresh request queue + stream thread and re-register
        with the SAME peer_id (shared by reconnect and wrong-shard
        re-pick so the two resume paths can never drift). The old
        stream's feeder is released first — gRPC's sender thread may
        still be blocked on the old queue."""
        self._requests.put(None)
        self._requests = queue.Queue()
        self._stream_thread = threading.Thread(
            target=self._stream_loop,
            name=f"daemon.announce-{self.peer_id[:8]}-{tag}",
            daemon=True,
        )
        self._stream_thread.start()
        self._send(register_peer=self._register_request())

    def _reconnect_stream(self, cause: str) -> bool:
        """Announce-stream resume: jittered wait, fresh request queue, a
        new stream thread, and a re-register carrying the same peer_id.
        False once the attempt budget is spent (callers then run the old
        fail/back-to-source path)."""
        if self._stream_reconnects >= self.opts.stream_reconnect_attempts:
            return False
        self._stream_reconnects += 1
        attempt = self._stream_reconnects
        EV_ANNOUNCE_RECONNECT(
            peer_id=self.peer_id, attempt=attempt, cause=cause[:200]
        )
        logger.warning(
            "announce stream for %s reconnecting (attempt %d/%d): %s",
            self.peer_id, attempt, self.opts.stream_reconnect_attempts, cause,
        )
        time.sleep(
            resilience.full_jitter_backoff(
                attempt - 1, base_s=self.opts.stream_reconnect_backoff, cap_s=2.0
            )
        )
        self._restart_stream(f"r{attempt}")
        return True

    def _wrong_shard_repick(self, owner: str, ring_version: int) -> bool:
        """WRONG_SHARD retry: refresh membership, detect staleness via
        the ring version, adopt the refuser's owner hint when our ring
        did NOT move (the refusal came from a fresher view than ours),
        and resume the stream on the re-picked member. Time-bounded, not
        attempt-bounded — see the _drive caller."""
        now = time.monotonic()
        if self._wrong_shard_deadline == 0.0:
            self._wrong_shard_deadline = now + self.opts.wrong_shard_retry_window
        if now >= self._wrong_shard_deadline:
            logger.warning(
                "wrong-shard retries for %s exhausted after %.1fs",
                self.peer_id, self.opts.wrong_shard_retry_window,
            )
            return False
        self._wrong_shard_retries += 1
        fleet.WRONG_SHARD_TOTAL.labels("daemon").inc()
        sched = self.scheduler
        refreshed = False
        if hasattr(sched, "refresh_membership"):
            refreshed = sched.refresh_membership()
        if not refreshed and owner and owner not in self._avoid_addrs:
            # our ring didn't move: the refuser knows something our
            # membership feed hasn't delivered yet — believe its hint
            # (unless it names a member we've already failed against:
            # then the hint is the still-leased corpse, and the right
            # move is to keep riding the retry window until it expires)
            self._owner_hint = owner
        EV_WRONG_SHARD_REPICK(
            peer_id=self.peer_id,
            owner=owner,
            ring_version=ring_version,
            attempt=self._wrong_shard_retries,
            ring_refreshed=refreshed,
        )
        time.sleep(
            resilience.full_jitter_backoff(
                min(self._wrong_shard_retries - 1, 4),
                base_s=self.opts.wrong_shard_backoff,
                cap_s=1.0,
            )
        )
        self._restart_stream(f"ws{self._wrong_shard_retries}")
        return True

    # ------------------------------------------------------------------
    def _back_to_source(self) -> None:
        M.BACK_TO_SOURCE_TOTAL.inc()
        EV_PEER_BACK_TO_SOURCE(peer_id=self.peer_id, task_id=self.task_id)
        if getattr(self, "_span", None) is not None:
            self._span.event("back_to_source")
        self._send(
            download_peer_back_to_source_started=scheduler_pb2.DownloadPeerBackToSourceStartedRequest(
                description="falling back to origin"
            )
        )
        try:
            # UrlMeta.range (dfget --range): the task IS that slice of
            # the origin object (the range is baked into the task id, so
            # P2P parents already hold sliced content; only the origin
            # fetch needs the offset applied)
            r_off, r_len = parse_byte_range(self.url_meta.range)
            n = self.pm.download_source(
                self.ts,
                self.url,
                headers=self.headers,
                on_piece=self._piece_done,
                offset=r_off,
                length=r_len,
                expected_digest=self.url_meta.digest,
            )
        except Exception as e:
            self._fail(f"back-to-source failed: {e}")
            return
        self._finish(piece_count=len(self.ts.meta.pieces), content_length=n)

    # ------------------------------------------------------------------
    def _download_from_parents(self, candidates) -> bool:
        """Pull all pieces from candidate parents; True when the task
        finished (success or failure), False to wait for a reschedule."""
        # adopt task geometry from the first parent that knows it — the
        # task's piece grid was fixed by whoever wrote the first piece, so
        # an advertised piece_length overrides the local config default
        # (which only governs this peer's own back-to-source writes)
        content_length = self.ts.meta.content_length
        piece_length = self.ts.meta.piece_length
        for c in candidates:
            # the scheduler's piece length is the task's only once its
            # geometry is known (a finished peer set the content length);
            # before that it is the 4 MiB default, which a seed peer
            # started moments ago need not use, so the parents say it
            if c.task_content_length > 0 and content_length < 0:
                content_length = c.task_content_length
                if c.task_piece_length > 0 and not self.ts.meta.pieces:
                    piece_length = c.task_piece_length
        # ask the parent daemons directly for the piece inventory
        # (upstream piece-metadata sync between daemons,
        # peertask_piecetask_synchronizer.go). A parent learns the
        # geometry with its first piece: a seed peer the scheduler named
        # the moment it registered has none yet, so wait for it on the
        # unadvertised-piece budget before blocking the parents (the
        # reference reschedules at once with them blocked, and its
        # children of a seed that was just triggered go to the origin)
        deadline = time.monotonic() + self.opts.wait_piece_timeout
        while content_length < 0 or not piece_length:
            content_length, piece_length = self._fetch_task_geometry(
                candidates, content_length, piece_length
            )
            if (content_length >= 0 and piece_length) or time.monotonic() >= deadline:
                break
            time.sleep(self.opts.not_found_backoff)
        if content_length < 0 or not piece_length:
            self._reschedule([c.peer_id for c in candidates], "parents lack task metadata")
            return False
        self.ts.meta.content_length = content_length
        self.ts.meta.piece_length = piece_length

        parents = [
            ParentInfo(
                peer_id=c.peer_id,
                upload_addr=f"{c.host.ip}:{c.host.download_port}",
                finished_pieces=set(c.finished_pieces),
            )
            for c in candidates
            if c.peer_id not in self._blocked_parents
        ]
        if not parents:
            self._reschedule([], "all candidate parents blocked")
            return False

        # live piece-metadata sync with each parent daemon (upstream
        # peertask_piecetask_synchronizer.go): keeps finished_pieces
        # fresh while in-progress parents keep downloading, so the
        # dispatcher stops guessing
        daemon_addrs = {
            c.peer_id: f"{c.host.ip}:{c.host.port}"
            for c in candidates
            if c.host.port
        }
        total_pieces = len(piece_ranges(content_length, piece_length))
        synchronizer = PieceTaskSynchronizer(self.task_id, self.peer_id)
        for p in parents:
            if len(p.finished_pieces) >= total_pieces:
                continue  # completed parent: the snapshot is already final
            addr = daemon_addrs.get(p.peer_id)
            if addr:
                synchronizer.watch(p, addr)

        self._send(download_peer_started=scheduler_pb2.DownloadPeerStartedRequest())
        dispatcher = PieceDispatcher()
        todo = [
            pr for pr in piece_ranges(content_length, piece_length)
            if pr.number not in self.ts.meta.pieces
        ]
        # account pieces already on disk (resume)
        with self._lock:
            self._completed = sum(p.length for p in self.ts.meta.pieces.values())

        failed: list[PieceRange] = []
        lock = threading.Lock()

        def work(pr: PieceRange) -> None:
            last_err: Exception | None = None
            failed_here: set[str] = set()
            hard_failures = 0
            # one wait budget per parent — a stalled parent exhausting its
            # deadline must not instantly hard-fail the other parents'
            # optimistic probes
            wait_deadlines: dict[str, float] = {}
            while hard_failures < self.opts.piece_retry:
                with lock:
                    live = [p for p in parents if p.peer_id not in self._blocked_parents]
                parent = dispatcher.pick(live, pr.number, exclude=failed_here)
                if parent is None:
                    break
                try:
                    result = self.pm.download_piece_from_parent(
                        self.ts, parent, pr, self.peer_id
                    )
                    with lock:
                        self._parent_failures[parent.peer_id] = 0
                    self._piece_done(result)
                    return
                except PieceDownloadError as e:
                    last_err = e
                    if e.not_found and pr.number not in parent.finished_pieces:
                        # optimistic probe of an in-progress parent that
                        # never claimed the piece — wait for it to appear
                        # on its own deadline, don't penalize the parent
                        # or burn the hard-failure retry budget
                        now = time.monotonic()
                        deadline = wait_deadlines.setdefault(
                            parent.peer_id, now + self.opts.wait_piece_timeout
                        )
                        if now < deadline:
                            with PH_PARENT_WAIT:
                                time.sleep(self.opts.not_found_backoff)
                            continue
                        # waited out the piece — fall through as a hard
                        # failure so the task reschedules instead of
                        # spinning forever on a stalled parent
                    # hard failure — including a 404 on a piece the parent
                    # *advertised*: its inventory lies (evicted piece), so
                    # deprioritize it or it wins every retry on EWMA weight
                    hard_failures += 1
                    failed_here.add(parent.peer_id)
                    EV_PIECE_FAILED(
                        peer_id=self.peer_id,
                        piece=pr.number,
                        parent_id=parent.peer_id,
                        error=str(e),
                    )
                    self._send(
                        download_piece_failed=scheduler_pb2.DownloadPieceFailedRequest(
                            piece_number=pr.number, parent_id=parent.peer_id, temporary=True
                        )
                    )
                    # block only after repeated hard failures — one transient
                    # timeout must not knock the parent out of the swarm
                    with lock:
                        n = self._parent_failures.get(parent.peer_id, 0) + 1
                        self._parent_failures[parent.peer_id] = n
                        if n >= self.opts.parent_fail_limit:
                            self._blocked_parents.add(parent.peer_id)
                            EV_PARENT_BLOCKED(
                                peer_id=self.peer_id,
                                parent_id=parent.peer_id,
                                failures=n,
                            )
            logger.warning("piece %d failed from all parents: %s", pr.number, last_err)
            with lock:
                failed.append(pr)

        try:
            with ThreadPoolExecutor(max_workers=self.opts.piece_workers) as pool:
                list(pool.map(work, todo))
        finally:
            synchronizer.stop()
            # the piece fetches rode the shared transfer pool's
            # keep-alive connections; this task is done with these
            # parents, so let the pool retire the idle sockets (a
            # 10k-parent swarm must not pin one fd per parent forever)
            downloader.release_parents(p.upload_addr for p in parents)

        if not failed:
            # _complete failure is terminal (pinned-content mismatch),
            # not reschedulable — fresh parents would feed the same task
            if self._complete(content_length):
                self._finish(piece_count=len(self.ts.meta.pieces), content_length=content_length)
            return True

        # some pieces failed everywhere → reschedule with blocklist;
        # scheduler may answer with fresh parents or back-to-source
        self._reschedule(sorted(self._blocked_parents), f"{len(failed)} pieces failed")
        return False

    def _fetch_task_geometry(
        self, candidates, content_length: int, piece_length: int
    ) -> tuple[int, int]:
        """GetPieceTasks against candidate parents' daemon gRPC ports to
        learn (content_length, piece_length)."""
        for c in candidates:
            if not c.host.port:
                continue
            try:
                addr = f"{c.host.ip}:{c.host.port}"
                channel = glue.dial(addr, retries=1)
                try:
                    # target=addr: each parent gets its own breaker —
                    # one dead parent must not fail-fast the healthy ones
                    parent = glue.ServiceClient(
                        channel, glue.DFDAEMON_SERVICE, target=addr
                    )
                    packet = parent.GetPieceTasks(
                        dfdaemon_pb2.PieceTaskRequest(
                            task_id=self.task_id,
                            src_peer_id=self.peer_id,
                            dst_peer_id=c.peer_id,
                            limit=1,
                        )
                    )
                finally:
                    channel.close()
            except Exception as e:
                logger.debug("GetPieceTasks from %s failed: %s", c.peer_id, e)
                continue
            if packet.content_length >= 0 and packet.piece_infos:
                if content_length < 0:
                    content_length = packet.content_length
                if not piece_length:
                    piece_length = packet.piece_infos[0].length
                return content_length, piece_length
        return content_length, piece_length

    def _reschedule(self, blocked: list[str], description: str) -> None:
        EV_RESCHEDULE(
            peer_id=self.peer_id, blocked=list(blocked), reason=description
        )
        self._send(
            reschedule=scheduler_pb2.RescheduleRequest(
                blocked_parent_ids=blocked, description=description
            )
        )

    # ------------------------------------------------------------------
    def _piece_done(self, r: PieceResult) -> None:
        EV_PIECE_DONE(
            peer_id=self.peer_id,
            piece=r.number,
            parent_id=r.parent_id,
            length=r.length,
            traffic=r.traffic_type,
            cost_ms=round(r.cost_ns / 1e6, 3),
        )
        with self._lock:
            self._completed += r.length
        self._send(
            download_piece_finished=scheduler_pb2.DownloadPieceFinishedRequest(
                piece=common_pb2.PieceInfo(
                    number=r.number,
                    parent_id=r.parent_id,
                    offset=r.offset,
                    length=r.length,
                    digest=r.digest,
                    traffic_type=r.traffic_type,
                    cost_ns=r.cost_ns,
                    created_at_ns=time.time_ns(),
                )
            )
        )
        self._publish()

    def _complete(self, content_length: int) -> bool:
        """mark_done with the digest pin applied; False = verification
        failed and the task was failed (the one mismatch-handling site
        for every completion path)."""
        try:
            self.ts.mark_done(content_length, expected_digest=self.url_meta.digest)
        except Exception as e:
            self._fail(str(e))
            return False
        return True

    def _finish(self, piece_count: int, content_length: int | None = None) -> None:
        self.ts.busy = False
        # Whole-task integrity (UrlMeta.digest) is enforced INSIDE
        # TaskStorage.mark_done before `done` ever flips, so every
        # completion path races nothing: a reuse lookup can only see a
        # verified task. The stream frontend hands out pieces as they
        # arrive by design; its guarantee is that no COMPLETED task
        # (reuse index, parents serving children, dfget success) ever
        # carries mismatching content.
        if getattr(self, "_span", None) is not None:
            self._span.set(piece_count=piece_count).end("ok")
        self._release_shaper()
        cost_ns = int((time.monotonic() - self._started_at) * 1e9)
        EV_PEER_FINISHED(
            peer_id=self.peer_id,
            task_id=self.task_id,
            pieces=piece_count,
            cost_ms=round(cost_ns / 1e6, 3),
        )
        self._send(
            download_peer_finished=scheduler_pb2.DownloadPeerFinishedRequest(
                content_length=(
                    content_length
                    if content_length is not None
                    else max(self.ts.meta.content_length, 0)
                ),
                piece_count=piece_count,
                cost_ns=cost_ns,
            )
        )
        self._drain_stream()
        self._done.set()
        self._publish()
        if self.on_done:
            self.on_done(self)

    def _release_shaper(self) -> None:
        shaper = getattr(self.pm, "shaper", None)
        if shaper is not None:
            shaper.release(self.task_id)

    def _fail(self, description: str) -> None:
        self.ts.busy = False
        if getattr(self, "_span", None) is not None:
            self._span.set(error=description).end("error")
        self._release_shaper()
        M.TASK_FAILURE_TOTAL.inc()
        EV_PEER_FAILED(
            peer_id=self.peer_id, task_id=self.task_id, error=description
        )
        self._error = description
        self._send(
            download_peer_failed=scheduler_pb2.DownloadPeerFailedRequest(
                description=description
            )
        )
        self._drain_stream()
        self._done.set()
        self._publish()
        if self.on_done:
            self.on_done(self)

    def _drain_stream(self) -> None:
        """Close the request side and wait for the server to close the
        response side — the server handles requests in order, so when the
        stream ends the final peer event (and its Download record) has
        been processed."""
        self._requests.put(None)
        if self._stream_thread is not None and self._stream_thread is not threading.current_thread():
            self._stream_thread.join(timeout=5.0)
