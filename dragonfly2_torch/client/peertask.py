"""Peer task manager: conductor dedup + completed-task reuse.

Counterpart of the reference's ``client/peertask.py``.

Role parity: upstream client/daemon/peer/peertask_manager.go:47-505 —
StartFileTask/StartStreamTask with one conductor per task (concurrent
requests for the same task share it) and reuse of completed local tasks
(upstream peertask_reuse.go).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from dataclasses import dataclass
from typing import Iterator

from dragonfly2_torch.rpc import protos
common_pb2 = protos.load("common_pb2")

from dragonfly2_torch.client.conductor import ConductorOptions, PeerTaskConductor, Progress
from dragonfly2_torch.client.piece_manager import PieceManager
from dragonfly2_torch.client.storage import StorageManager
from dragonfly2_torch.utils import dflog
from dragonfly2_torch.utils.idgen import URLMeta, peer_id_v2, task_id_v1

logger = dflog.get("client.peertask")


@dataclass
class FileTaskRequest:
    url: str
    output: str = ""  # empty = leave in the piece store (stream use)
    url_meta: common_pb2.UrlMeta | None = None
    disable_back_source: bool = False
    # origin-first: tell the scheduler to send this peer straight to the
    # source (seed-trigger path, upstream seed_peer.go ObtainSeeds)
    need_back_to_source: bool = False
    task_type: int = 0
    headers: dict | None = None


class TaskManager:
    def __init__(
        self,
        host_id: str,
        storage: StorageManager,
        scheduler_client,
        piece_manager: PieceManager | None = None,
        options: ConductorOptions | None = None,
        host_info_fn=None,  # () -> common_pb2.HostInfo, for AnnounceTask
    ):
        self.host_id = host_id
        self.storage = storage
        self.scheduler = scheduler_client
        self.pm = piece_manager or PieceManager()
        self.options = options or ConductorOptions()
        self.host_info_fn = host_info_fn
        self.conductors: dict[str, PeerTaskConductor] = {}
        self.lock = threading.Lock()

    def _scheduler_for(self, task_id: str):
        """Consistent-hash task affinity when a multi-scheduler selector
        is wired (upstream pkg/balancer); a plain client passes through."""
        if hasattr(self.scheduler, "for_task"):
            return self.scheduler.for_task(task_id)
        return self.scheduler

    # ------------------------------------------------------------------
    def task_id_for(self, url: str, url_meta: common_pb2.UrlMeta | None) -> str:
        from dragonfly2_torch.client.pieces import normalize_byte_range

        meta = None
        if url_meta is not None:
            if url_meta.digest:
                # reject malformed pins at registration — discovering a
                # bad 'sha1:…' AFTER downloading gigabytes wastes the
                # whole transfer
                from dragonfly2_torch.utils.digest import parse_digest

                parse_digest(url_meta.digest)
            meta = URLMeta(
                digest=url_meta.digest,
                tag=url_meta.tag,
                # canonicalized: equivalent range spellings share one
                # task (and malformed specs fail at registration)
                range=normalize_byte_range(url_meta.range),
                filter=url_meta.filter,
                application=url_meta.application,
            )
        return task_id_v1(url, meta)

    def start_file_task(self, req: FileTaskRequest) -> tuple[str, str, PeerTaskConductor | None]:
        """Returns (task_id, peer_id, conductor|None). None conductor =
        served from completed local storage (reuse path)."""
        url_meta = req.url_meta or common_pb2.UrlMeta()
        task_id = self.task_id_for(req.url, url_meta)

        done = self.storage.find_completed_task(task_id)
        if done is not None:
            logger.info("task %s reused from local storage", task_id[:16])
            if req.output:
                done.store(req.output)
            return task_id, done.meta.peer_id, None

        with self.lock:
            conductor = self.conductors.get(task_id)
            if conductor is not None and not conductor.progress().error:
                return task_id, conductor.peer_id, conductor
            peer_id = peer_id_v2()
            opts = dataclasses.replace(
                self.options,
                disable_back_source=req.disable_back_source or self.options.disable_back_source,
            )
            conductor = PeerTaskConductor(
                task_id=task_id,
                peer_id=peer_id,
                host_id=self.host_id,
                url=req.url,
                url_meta=url_meta,
                storage=self.storage,
                # the selector itself, not a resolved client: the
                # conductor re-resolves the task's ring owner per stream
                # connect, so fleet membership moves (WRONG_SHARD
                # re-pick, successor failover) land mid-task
                scheduler_client=self.scheduler,
                piece_manager=self.pm,
                options=opts,
                task_type=req.task_type,
                # origin headers: explicit request field, else
                # UrlMeta.header — EVERY frontend (Download, ExportTask,
                # proxy, gateway) gets auth to the back-to-source fetch
                # without per-entry-point special-casing
                headers=req.headers or dict(url_meta.header),
                need_back_to_source=req.need_back_to_source,
                on_done=self._forget,
            )
            self.conductors[task_id] = conductor
            conductor.start()
        return task_id, peer_id, conductor

    # ------------------------------------------------------------------
    # stream frontend (upstream peertask_stream.go): bytes flow to the
    # caller as pieces land, instead of waiting for the whole task —
    # the proxy/transport/object-gateway path for large blobs
    # ------------------------------------------------------------------
    def start_stream_task(
        self, req: FileTaskRequest, timeout: float | None = None
    ) -> tuple[str, str, int, dict, "Iterator[bytes]"]:
        """Returns (task_id, peer_id, content_length, origin_headers,
        piece iterator). Blocks only until the task geometry and first
        piece are known (time-to-first-byte), then hands back a generator
        yielding pieces in order as they complete. The generator raises
        ``IOError`` if the underlying task fails mid-stream."""
        task_id, peer_id, conductor = self.start_file_task(
            dataclasses.replace(req, output="")
        )
        if conductor is None:  # completed local task: stream from disk
            ts = self.storage.load(task_id)
            return (
                task_id,
                peer_id,
                ts.meta.content_length,
                dict(ts.meta.headers),
                self._stored_pieces(ts),
            )

        # subscribe BEFORE inspecting state so no completion wakeup is lost
        sub = conductor.subscribe()
        deadline = None if timeout is None else time.monotonic() + timeout

        def wait_tick(ctx: str) -> None:
            p = conductor.progress()
            if p.error:
                raise IOError(f"stream task {task_id[:16]} failed {ctx}: {p.error}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"stream task {task_id[:16]} timed out {ctx}")
            try:
                sub.get(timeout=0.2)
            except queue.Empty:
                pass

        # time-to-first-byte: geometry + piece 0 (upstream
        # peertask_stream.go waits for the first piece the same way)
        while True:
            ts = self.storage.load(task_id)
            if ts is not None and ts.meta.content_length >= 0 and (
                0 in ts.meta.pieces or conductor.progress().done
            ):
                break
            wait_tick("before first byte")

        def pieces() -> "Iterator[bytes]":
            n = 0
            sent = 0
            while True:
                if n in ts.meta.pieces:
                    data = ts.read_piece(n)
                    sent += len(data)
                    yield data
                    n += 1
                    # the byte count, not the done flag, ends the stream —
                    # the conductor's finish handshake with the scheduler
                    # lags the last piece and must not hold the response
                    if ts.meta.content_length >= 0 and sent >= ts.meta.content_length:
                        return
                    continue
                p = conductor.progress()
                if p.done:
                    # pieces are written before done is published, so a
                    # finished task has the full contiguous set
                    if n >= len(ts.meta.pieces):
                        return
                    if n not in ts.meta.pieces:  # pragma: no cover - defensive
                        raise IOError(f"stream task {task_id[:16]}: gap at piece {n}")
                wait_tick(f"at piece {n}")

        return task_id, peer_id, ts.meta.content_length, dict(ts.meta.headers), pieces()

    @staticmethod
    def _stored_pieces(ts) -> "Iterator[bytes]":
        for number in sorted(ts.meta.pieces):
            yield ts.read_piece(number)

    # ------------------------------------------------------------------
    # seed frontend (upstream peertask_seed.go / seeder ObtainSeeds):
    # origin-first download that makes THIS daemon the swarm's feed
    # ------------------------------------------------------------------
    def start_seed_task(
        self,
        url: str,
        url_meta: common_pb2.UrlMeta | None = None,
        headers: dict | None = None,
        task_type: int = 0,
    ) -> tuple[str, str, PeerTaskConductor | None]:
        """Registers with need_back_to_source so the scheduler sends this
        peer straight to the origin; children are then fed from here
        (upstream seed_peer.go:92-213 trigger → seeder.go ObtainSeeds)."""
        return self.start_file_task(
            FileTaskRequest(
                url=url,
                url_meta=url_meta,
                need_back_to_source=True,
                headers=headers,
                task_type=task_type,
            )
        )

    def _forget(self, conductor: PeerTaskConductor) -> None:
        """Completion callback: drop the finished conductor so the dict
        doesn't grow unboundedly and a failed task can be retried. A
        timed-out waiter must NOT pop — the conductor is still running
        and concurrent requests should keep sharing it."""
        with self.lock:
            if self.conductors.get(conductor.task_id) is conductor:
                self.conductors.pop(conductor.task_id)

    def import_completed_task(
        self,
        task_id: str,
        url: str,
        read_chunk,
        size: int,
        piece_length: int = 0,
        task_type: int = 0,
    ) -> None:
        """Seed local bytes as a completed task and announce it: shared by
        dfcache ImportTask and the gateway's seed-on-write path (upstream
        rpcserver.go ImportTask → announcePeerTask). ``read_chunk(n)``
        yields up to n bytes per call (file handle or BytesIO reader).
        The announce is best-effort — a scheduler outage must not fail a
        local import."""
        from dragonfly2_torch.client.pieces import compute_piece_length

        pl = piece_length or compute_piece_length(size)
        ts = self.storage.register_task(
            task_id, peer_id_v2(), url=url, piece_length=pl, content_length=size
        )
        number = 0
        while True:
            chunk = read_chunk(pl)
            if not chunk and number > 0:
                break
            ts.write_piece(number, number * pl, chunk, traffic_type="local_peer")
            number += 1
            if len(chunk) < pl:
                break
        ts.mark_done(size)
        try:
            self.announce_completed_task(ts, task_type=task_type)
        except Exception as e:
            logger.warning("announce imported task %s failed: %s", task_id[:16], e)

    def announce_completed_task(self, ts, task_type: int = 0) -> None:
        """Tell the scheduler this daemon holds the complete task (dfcache
        import / gateway seed-on-write) so it becomes the first candidate
        parent instead of every other peer back-sourcing (upstream
        client/daemon/rpcserver announcePeerTask → scheduler AnnounceTask)."""
        from dragonfly2_torch.rpc import protos
        scheduler_pb2 = protos.load("scheduler_pb2")

        self._scheduler_for(ts.meta.task_id).AnnounceTask(
            scheduler_pb2.AnnounceTaskRequest(
                host_id=self.host_id,
                host=self.host_info_fn() if self.host_info_fn else None,
                task_id=ts.meta.task_id,
                peer_id=ts.meta.peer_id,
                url=ts.meta.url,
                url_meta=common_pb2.UrlMeta(tag=ts.meta.tag, application=ts.meta.application),
                task_type=task_type,
                content_length=ts.meta.content_length,
                piece_length=ts.meta.piece_length,
                pieces=[
                    common_pb2.PieceInfo(
                        number=p.number,
                        offset=p.offset,
                        length=p.length,
                        digest=p.digest,
                        traffic_type=p.traffic_type,
                        cost_ns=p.cost_ns,
                    )
                    for _, p in sorted(ts.meta.pieces.items())
                ],
            )
        )

    def wait_file_task(self, req: FileTaskRequest, timeout: float | None = None) -> tuple[str, str, Progress]:
        task_id, peer_id, conductor = self.start_file_task(req)
        if conductor is None:
            ts = self.storage.load(task_id)
            return task_id, peer_id, Progress(
                completed_length=ts.meta.content_length,
                content_length=ts.meta.content_length,
                done=True,
            )
        progress = conductor.wait(timeout)
        if progress.done and req.output:
            self.storage.load(task_id).store(req.output)
        return task_id, peer_id, progress
