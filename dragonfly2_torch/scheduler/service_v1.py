"""Scheduler gRPC service, v1 wire shape (upstream
scheduler/service/service_v1.go:95-1632).

The v1 protocol predates the AnnouncePeer consolidation: registration is a
unary ``RegisterPeerTask`` whose response dispatches on size scope
(empty/tiny/small/normal, reference :1005-1110), parent assignment rides a
``ReportPieceResult`` bidi stream as ``PeerPacket`` pushes (:187-293), and
the final ``ReportPeerResult`` is the Download-record sink (:294-477 →
createDownloadRecord :1418-1632). This adapter maps that wire shape onto
the same domain layer the v2 service drives (resource FSMs, Scheduling,
Storage) so both generations of clients see one cluster state.
"""

from __future__ import annotations

import queue
import threading
import time

import grpc

from dragonfly2_torch.rpc import protos

common_pb2 = protos.load("common_pb2")
v1 = protos.load("scheduler_v1_pb2")

from dragonfly2_torch.rpc.glue import SCHEDULER_V1_SERVICE
from dragonfly2_torch.scheduler import resource as res
from dragonfly2_torch.scheduler.fleet import WrongShardError
from dragonfly2_torch.scheduler import metrics as M
from dragonfly2_torch.scheduler import swarm
from dragonfly2_torch.scheduler.scheduling import (
    NeedBackToSourceResponse,
    NormalTaskResponse,
    Scheduling,
    SchedulingError,
)
from dragonfly2_torch.scheduler.service import (
    load_or_create_task,
    url_meta_of,
    write_download_record,
)
from dragonfly2_torch.scheduler.storage import Storage, build_download_record
from dragonfly2_torch.utils import dflog
from dragonfly2_torch.utils.idgen import URLMeta, task_id_v1

logger = dflog.get("scheduler.rpc.v1")

# begin-of-piece sentinel on the v1 wire: the peer is asking for
# (re)scheduling, no piece was transferred (reference common.BeginOfPiece)
BEGIN_OF_PIECE = -1
# end-of-piece sentinel: the peer has no more piece results to report
END_OF_PIECE = -2


def _dest_peer(p: res.Peer) -> v1.DestPeer:
    return v1.DestPeer(
        peer_id=p.id,
        ip=p.host.ip,
        rpc_port=p.host.port,
        down_port=p.host.download_port,
    )


class _V1StreamAdapter:
    """Translates scheduling decisions into v1 ``PeerPacket`` pushes.

    The Scheduling algorithm is v1/v2-agnostic — it emits
    ``NormalTaskResponse``/``NeedBackToSourceResponse`` dataclasses to
    whatever stream handle the peer stores. The v2 service renders them as
    AnnouncePeerResponse; this adapter renders the same decisions as the
    v1 main-peer + candidates packet (upstream scheduling.go:575-769
    constructs PeerPacket the same way: best-ranked candidate becomes the
    main peer, the rest ride as candidates)."""

    def __init__(self, task_id: str, src_pid: str, peer: res.Peer | None = None):
        self.task_id = task_id
        self.src_pid = src_pid
        self.peer = peer
        self.out: "queue.Queue[v1.PeerPacket | None]" = queue.Queue()

    def send(self, decision) -> None:
        if isinstance(decision, NormalTaskResponse):
            # Scheduling only emits NormalTaskResponse with candidates
            # (scheduling.py sends back-to-source otherwise)
            parents = decision.candidate_parents
            task = parents[0].task
            pkt = v1.PeerPacket(
                task_id=self.task_id,
                src_pid=self.src_pid,
                parallel_count=len(parents),
                main_peer=_dest_peer(parents[0]),
                candidate_peers=[_dest_peer(p) for p in parents[1:]],
                code=v1.CODE_SUCCESS,
                task_content_length=task.content_length,
                task_total_piece_count=task.total_piece_count,
                task_piece_length=task.piece_length,
            )
        elif isinstance(decision, NeedBackToSourceResponse):
            # unlike v2, the v1 client never sends an explicit
            # back-to-source-started event — the code on this packet IS
            # the transition, so mirror the v2 bookkeeping here
            # (service.py download_peer_back_to_source_started handling):
            # the FSM move makes the in-flight peer schedulable as a
            # parent, and back_to_source_peers consumes the task's
            # back-to-source budget
            if self.peer is not None:
                if self.peer.fsm.can(res.PEER_EVENT_DOWNLOAD_BACK_TO_SOURCE):
                    self.peer.fsm.event(res.PEER_EVENT_DOWNLOAD_BACK_TO_SOURCE)
                    self.peer.task.back_to_source_peers.add(self.peer.id)
            pkt = v1.PeerPacket(
                task_id=self.task_id,
                src_pid=self.src_pid,
                code=v1.CODE_NEED_BACK_SOURCE,
            )
        else:  # pragma: no cover - defensive: unknown decision kind
            logger.warning("v1 adapter dropping decision %r", decision)
            return
        self.out.put(pkt)

    def close(self) -> None:
        self.out.put(None)


class SchedulerServiceV1:
    """v1 servicer sharing domain state with the v2 ``SchedulerService``."""

    def __init__(
        self,
        resource: res.Resource,
        scheduling: Scheduling,
        storage: Storage | None = None,
        networktopology=None,
        fleet=None,  # scheduler.fleet.FleetMembership; None = no sharding
        replication=None,  # scheduler.swarm_replication.SwarmReplicator
    ):
        self.resource = resource
        self.scheduling = scheduling
        self.storage = storage
        self.networktopology = networktopology
        self.fleet = fleet
        self.replication = replication

    # ------------------------------------------------------------------
    # RegisterPeerTask (unary, size-scope dispatch)
    # ------------------------------------------------------------------
    def RegisterPeerTask(self, request: v1.PeerTaskRequest, context):
        try:
            return self._register_peer_task(request)
        except WrongShardError as e:
            # same typed refusal the v2 stream gets — a redirect, not a
            # registration failure, so the failure counter stays honest
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except Exception:
            M.REGISTER_PEER_FAILURE_TOTAL.inc()
            raise

    def _register_peer_task(self, request: v1.PeerTaskRequest):
        meta = url_meta_of(request.url_meta)
        task_id = request.task_id or task_id_v1(request.url, meta)
        if self.fleet is not None:
            existing = self.resource.task_manager.load(task_id)
            try:
                self.fleet.check_owner(
                    task_id,
                    task_in_flight=existing is not None and existing.peer_count() > 0,
                )
            except WrongShardError as e:
                # migrate the replica with the refusal (v2 parity): the
                # new owner adopts it inside the grace window
                if existing is not None and self.replication is not None:
                    self.replication.migrate(task_id, e.owner)
                raise
            if existing is None and self.replication is not None:
                self.replication.adopt_task(task_id)
        host = self._store_host(request.peer_host)
        task, _ = load_or_create_task(
            self.resource, request.url, meta, task_id, request.task_type
        )

        peer = res.Peer(
            request.peer_id, task, host, tag=meta.tag, application=meta.application
        )
        peer, existed = self.resource.peer_manager.load_or_store(peer)
        peer.need_back_to_source = request.need_back_to_source

        result = v1.RegisterResult(
            task_type=request.task_type,
            task_id=task_id,
            size_scope=common_pb2.SIZE_SCOPE_NORMAL,
        )
        if existed and not peer.fsm.is_state(res.PEER_STATE_PENDING):
            # re-register with a live peer id: report the task's actual
            # scope (with direct content where the fast path applies) but
            # fire no FSM events — the peer already left Pending
            scope = task.size_scope()
            if scope is res.SizeScope.EMPTY:
                result.size_scope = common_pb2.SIZE_SCOPE_EMPTY
                result.piece_content = b""
            elif scope is res.SizeScope.TINY and task.can_reuse_direct_piece():
                result.size_scope = common_pb2.SIZE_SCOPE_TINY
                result.piece_content = task.direct_piece
            return result

        scope = task.size_scope()
        M.REGISTER_PEER_TOTAL.labels(scope).inc()
        if scope is res.SizeScope.EMPTY:
            peer.fsm.event(res.PEER_EVENT_REGISTER_EMPTY)
            result.size_scope = common_pb2.SIZE_SCOPE_EMPTY
            result.piece_content = b""
        elif scope is res.SizeScope.TINY and task.can_reuse_direct_piece():
            peer.fsm.event(res.PEER_EVENT_REGISTER_TINY)
            result.size_scope = common_pb2.SIZE_SCOPE_TINY
            result.piece_content = task.direct_piece
        elif scope is res.SizeScope.SMALL:
            single = self._single_piece(peer, task)
            if single is not None:
                peer.fsm.event(res.PEER_EVENT_REGISTER_SMALL)
                result.size_scope = common_pb2.SIZE_SCOPE_SMALL
                result.single_piece.CopyFrom(single)
            else:
                # no feedable parent or unknown piece geometry: downgrade
                # to normal registration (reference registerSmallTask
                # falls through the same way)
                peer.fsm.event(res.PEER_EVENT_REGISTER_NORMAL)
        else:
            peer.fsm.event(res.PEER_EVENT_REGISTER_NORMAL)
        return result

    def _single_piece(self, peer: res.Peer, task: res.Task) -> v1.SinglePiece | None:
        """Small-file fast path: one finished parent serves the single
        piece directly (upstream service_v1.go registerSmallTask)."""
        piece0 = task.load_piece(0)
        if piece0 is None:
            return None
        candidates = [
            c
            for c in task.load_random_peers(16)
            if c.id != peer.id
            and c.host.id != peer.host.id
            and c.fsm.is_state(res.PEER_STATE_SUCCEEDED)
            and c.host.free_upload_count() > 0
            and not self.scheduling.evaluator.is_bad_node(c)
        ]
        if not candidates:
            return None
        ranked = self.scheduling.evaluator.evaluate_parents(
            candidates, peer, task.total_piece_count
        )
        parent = ranked[0]
        return v1.SinglePiece(
            dst_pid=parent.id,
            dst_ip=parent.host.ip,
            dst_down_port=parent.host.download_port,
            piece_info=common_pb2.PieceInfo(
                number=piece0.number,
                offset=piece0.offset,
                length=piece0.length,
                digest=piece0.digest,
            ),
        )

    def _store_host(self, ph: v1.PeerHost) -> res.Host:
        host = self.resource.host_manager.load(ph.id)
        if host is None:
            host = res.Host(
                id=ph.id,
                hostname=ph.hostname,
                ip=ph.ip,
                port=ph.rpc_port,
                download_port=ph.down_port,
            )
            host.network.location = ph.location
            host.network.idc = ph.idc
            self.resource.host_manager.store(host)
        else:
            # refresh addressing in place — a daemon restarted with the
            # same host id but new ports must not leave children dialing
            # the stale endpoint (v2 AnnounceHost refreshes the same way)
            if ph.ip:
                host.ip = ph.ip
            if ph.rpc_port:
                host.port = ph.rpc_port
            if ph.down_port:
                host.download_port = ph.down_port
            host.touch()
        return host

    # ------------------------------------------------------------------
    # ReportPieceResult (bidi stream — the scheduling loop)
    # ------------------------------------------------------------------
    def ReportPieceResult(self, request_iterator, context):
        ready = threading.Event()
        adapter_box: dict = {"adapter": None, "peer": None}

        def pump():
            try:
                for req in request_iterator:
                    self._handle_piece_result(req, adapter_box)
                    ready.set()  # adapter installed by the first request
            except grpc.RpcError:
                pass  # client hung up — normal stream teardown
            except Exception:
                logger.exception("v1 piece-result stream failed")
            finally:
                peer = adapter_box.get("peer")
                if peer is not None:
                    peer.delete_stream()
                adapter = adapter_box.get("adapter")
                if adapter is not None:
                    adapter.close()
                ready.set()  # wake the response side even on empty streams

        t = threading.Thread(
            target=pump, name="scheduler.announce-pump-v1", daemon=True
        )
        t.start()
        # Block until the first request installs the adapter; a client that
        # opens the stream and sends nothing just ends it.
        ready.wait()
        adapter = adapter_box.get("adapter")
        if adapter is None:
            return
        while True:
            pkt = adapter.out.get()
            if pkt is None:
                return
            yield pkt

    def _handle_piece_result(self, req: v1.PieceResult, box: dict) -> None:
        peer = box.get("peer")
        if peer is None:
            peer = self.resource.peer_manager.load(req.src_pid)
            if peer is None:
                # peer never registered (scheduler restarted): tell it to
                # re-register (upstream handles this with Code_PeerGone)
                box["adapter"] = adapter = _V1StreamAdapter(req.task_id, req.src_pid)
                adapter.out.put(
                    v1.PeerPacket(
                        task_id=req.task_id, src_pid=req.src_pid, code=v1.CODE_PEER_GONE
                    )
                )
                adapter.close()
                return
            box["peer"] = peer
            box["adapter"] = _V1StreamAdapter(req.task_id, req.src_pid, peer=peer)
            peer.store_stream(box["adapter"])
        adapter = box["adapter"]

        number = req.piece_info.number
        if number == END_OF_PIECE:
            return
        if number == BEGIN_OF_PIECE:
            if peer.fsm.can(res.PEER_EVENT_DOWNLOAD):
                peer.fsm.event(res.PEER_EVENT_DOWNLOAD)
            if peer.task.fsm.can(res.TASK_EVENT_DOWNLOAD):
                peer.task.fsm.event(res.TASK_EVENT_DOWNLOAD)
            self._schedule(peer)
            return

        if req.success:
            M.DOWNLOAD_PIECE_FINISHED_TOTAL.labels(
                req.piece_info.traffic_type or "remote_peer"
            ).inc()
            M.TRAFFIC_BYTES_TOTAL.labels(
                req.piece_info.traffic_type or "remote_peer"
            ).inc(req.piece_info.length)
            M.HOST_TRAFFIC_BYTES_TOTAL.labels(
                req.piece_info.traffic_type or "remote_peer",
                peer.host.id,
                peer.host.ip,
            ).inc(req.piece_info.length)
            cost_ms = req.piece_info.cost_ns / 1e6
            piece = res.Piece(
                number=number,
                parent_id=req.dst_pid,
                offset=req.piece_info.offset,
                length=req.piece_info.length,
                digest=req.piece_info.digest,
                traffic_type=req.piece_info.traffic_type,
                cost_ms=cost_ms,
                created_at=req.piece_info.created_at_ns / 1e9
                if req.piece_info.created_at_ns
                else time.time(),
            )
            peer.finish_piece(number, cost_ms=cost_ms, piece=piece)
            # task-level piece metadata feeds the SMALL single-piece fast
            # path (reference handlePieceSuccess stores pieces on the task)
            peer.task.store_piece(piece)
            if number == 0 and req.piece_info.length:
                peer.task.piece_length = req.piece_info.length
            if req.dst_pid:
                parent = self.resource.peer_manager.load(req.dst_pid)
                if parent is not None:
                    parent.host.record_upload(success=True)
        elif req.code == v1.CODE_CLIENT_WAIT_PIECE:
            # the parent is healthy but has no new pieces yet — wait for
            # more, don't penalise it and don't burn a reschedule
            # (reference handlePieceFail treats Code_ClientWaitPieceReady
            # as non-fatal)
            return
        else:
            M.DOWNLOAD_PIECE_FAILURE_TOTAL.inc()
            # failed piece: penalise the parent and re-schedule (reference
            # service_v1.go:1210 handlePieceFail → reschedule)
            if req.dst_pid:
                peer.block_parents.add(req.dst_pid)
                parent = self.resource.peer_manager.load(req.dst_pid)
                if parent is not None:
                    parent.host.record_upload(success=False)
            self._schedule(peer)

    def _schedule(self, peer: res.Peer) -> None:
        try:
            self.scheduling.schedule_candidate_parents(peer, set(peer.block_parents))
        except SchedulingError as e:
            logger.warning("v1 scheduling peer %s failed: %s", peer.id, e)

    # ------------------------------------------------------------------
    # ReportPeerResult (unary — the record sink)
    # ------------------------------------------------------------------
    def ReportPeerResult(self, request: v1.PeerResult, context):
        peer = self.resource.peer_manager.load(request.peer_id)
        if peer is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND, f"peer {request.peer_id} not found"
            )
        peer.cost_ns = request.cost_ns
        if request.success:
            M.DOWNLOAD_PEER_FINISHED_TOTAL.inc()
            if request.cost_ns > 0:
                M.DOWNLOAD_PEER_DURATION_MS.observe(request.cost_ns / 1e6)
            if peer.fsm.can(res.PEER_EVENT_DOWNLOAD_SUCCEEDED):
                peer.fsm.event(res.PEER_EVENT_DOWNLOAD_SUCCEEDED)
            # 0 is a legitimate value here (empty file), not "unset" —
            # a successful ReportPeerResult always carries the true size.
            # Trusting the report verbatim matches the reference, which
            # Stores unconditionally on first task success
            # (service_v1.go:1350-1352 handleTaskSuccess); proto3 cannot
            # distinguish an omitted int from a true 0 either way.
            if peer.task.content_length < 0:
                peer.task.content_length = request.content_length
            if peer.task.total_piece_count < 0:
                peer.task.total_piece_count = request.total_piece_count
            # observatory learns the total too — its last on_piece
            # predates this report (see service.py's twin site)
            swarm.on_total(peer.task.id, peer.task.total_piece_count)
            if peer.task.fsm.can(res.TASK_EVENT_DOWNLOAD_SUCCEEDED):
                peer.task.fsm.event(res.TASK_EVENT_DOWNLOAD_SUCCEEDED)
            self._write_download_record(peer)
        else:
            M.DOWNLOAD_PEER_FAILURE_TOTAL.inc()
            if peer.fsm.can(res.PEER_EVENT_DOWNLOAD_FAILED):
                peer.fsm.event(res.PEER_EVENT_DOWNLOAD_FAILED)
            if peer.task.fsm.can(res.TASK_EVENT_DOWNLOAD_FAILED):
                peer.task.fsm.event(res.TASK_EVENT_DOWNLOAD_FAILED)
            # proto3 enums are open — a code outside the defined range
            # must still land in the record, not crash the sink
            code = request.code
            if not code:
                error_code = "download_failed"
            elif code in v1.Code.values():
                error_code = v1.Code.Name(code)
            else:
                error_code = str(code)
            self._write_download_record(peer, error_code=error_code)
        return v1.Empty()

    def _write_download_record(
        self, peer: res.Peer, error_code: str = "", error_message: str = ""
    ) -> None:
        write_download_record(self.storage, peer, error_code, error_message)

    # ------------------------------------------------------------------
    # unary task/host RPCs
    # ------------------------------------------------------------------
    def StatTask(self, request: v1.StatTaskRequest, context):
        M.STAT_TASK_TOTAL.inc()
        task = self.resource.task_manager.load(request.task_id)
        if task is None:
            M.STAT_TASK_FAILURE_TOTAL.inc()
            context.abort(grpc.StatusCode.NOT_FOUND, f"task {request.task_id} not found")
        return v1.Task(
            id=task.id,
            state=task.fsm.current,
            content_length=task.content_length,
            total_piece_count=task.total_piece_count,
            peer_count=task.peer_count(),
            has_available_peer=task.has_available_peer(),
        )

    def LeaveTask(self, request: v1.PeerTarget, context):
        M.LEAVE_PEER_TOTAL.inc()
        peer = self.resource.peer_manager.load(request.peer_id)
        if peer is None:
            # tolerated (idempotent leave) but counted, matching v2
            # LeavePeer — docs/metrics.md documents one series for both
            M.LEAVE_PEER_FAILURE_TOTAL.inc()
        if peer is not None:
            if peer.fsm.can(res.PEER_EVENT_LEAVE):
                peer.fsm.event(res.PEER_EVENT_LEAVE)
            peer.task.delete_peer_in_edges(peer.id)
            peer.task.delete_peer_out_edges(peer.id)
        return v1.Empty()

    def LeaveHost(self, request: v1.LeaveHostRequest, context):
        M.LEAVE_HOST_TOTAL.inc()
        host = self.resource.host_manager.load(request.host_id)
        if host is not None:
            host.leave_peers()
            self.resource.host_manager.delete(request.host_id)
        if self.networktopology is not None:
            self.networktopology.delete_host(request.host_id)
        return v1.Empty()

    def AnnounceTask(self, request: v1.AnnounceTaskRequest, context):
        """Register an already-completed local task on the v1 wire
        (upstream scheduler/service/service_v1.go:349-433): the
        announcing peer lands in Succeeded with every announced piece
        finished, so dfcache imports / object-gateway writes become
        schedulable parents for v1 clients. Same domain transitions as
        the v2 AnnounceTask (service.py), keyed off the PiecePacket."""
        peer_id = request.piece_packet.dst_pid
        if not peer_id:
            # reject BEFORE any state mutation: a bad announce must not
            # leave a ghost Pending task / refreshed host behind (the v2
            # handler aborts first the same way)
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "announce task carried no piece_packet.dst_pid",
            )
        host = self._store_host(request.peer_host)
        meta = url_meta_of(request.url_meta)
        task_id = request.task_id or task_id_v1(request.url, meta)
        task, _ = load_or_create_task(
            self.resource, request.url, meta, task_id, request.task_type
        )
        peer = res.Peer(
            peer_id, task, host, tag=meta.tag, application=meta.application
        )
        peer, _ = self.resource.peer_manager.load_or_store(peer)

        # task not yet succeeded: adopt the announced piece inventory and
        # advance it (reference :368-405 — pieces stored on both the peer
        # and the task, then handleTaskSuccess with the packet's totals)
        if not task.fsm.is_state(res.TASK_STATE_SUCCEEDED):
            if task.fsm.can(res.TASK_EVENT_DOWNLOAD):
                task.fsm.event(res.TASK_EVENT_DOWNLOAD)
            for pi in request.piece_packet.piece_infos:
                piece = res.Piece(
                    number=pi.number,
                    parent_id=peer_id,
                    offset=pi.offset,
                    length=pi.length,
                    digest=pi.digest,
                    traffic_type="local_peer",
                    # announced pieces were produced locally, no transfer
                    # happened — reference :361 sets Cost 0
                    cost_ms=0.0,
                    created_at=time.time(),
                )
                peer.finish_piece(pi.number, cost_ms=0.0, piece=piece)
                task.store_piece(piece)
            # adopt the packet's totals verbatim — 0 is a legitimate value
            # (empty file announced), not "unset"; proto3 can't distinguish
            # the two and the reference trusts the packet the same way
            # (:400-403 handleTaskSuccess with the packet's totals). Only
            # unknown (-1) task values are overwritten.
            if task.content_length < 0:
                task.content_length = request.piece_packet.content_length
            if task.total_piece_count < 0:
                task.total_piece_count = request.piece_packet.total_piece
            swarm.on_total(task.id, task.total_piece_count)
            if task.fsm.can(res.TASK_EVENT_DOWNLOAD_SUCCEEDED):
                task.fsm.event(res.TASK_EVENT_DOWNLOAD_SUCCEEDED)

        # peer not yet succeeded: walk it Pending → Running → Succeeded
        # (reference :407-431)
        if not peer.fsm.is_state(res.PEER_STATE_SUCCEEDED):
            if peer.fsm.is_state(res.PEER_STATE_PENDING):
                peer.fsm.event(res.PEER_EVENT_REGISTER_NORMAL)
            if peer.fsm.can(res.PEER_EVENT_DOWNLOAD):
                peer.fsm.event(res.PEER_EVENT_DOWNLOAD)
            if peer.fsm.can(res.PEER_EVENT_DOWNLOAD_SUCCEEDED):
                peer.fsm.event(res.PEER_EVENT_DOWNLOAD_SUCCEEDED)
        return v1.Empty()

    # v1 AnnounceHost/SyncProbes delegate to the v2 service's handlers —
    # identical message shapes, one domain layer (reference binds both
    # generations over shared resource/networktopology state). Results
    # are RE-WRAPPED into v1 types: glue registers this service with the
    # v1 serializers, and returning v2 instances would only work while
    # the shapes coincide byte-for-byte — a later v2-only field would
    # silently leak undeclared bytes to v1 clients instead of failing
    # loudly here
    def AnnounceHost(self, request, context):
        from dragonfly2_torch.scheduler.service import SchedulerService

        # the domain helpers (not the public handlers, which wrap them
        # with metric accounting bound to SchedulerService's layout) —
        # this servicer does NOT inherit from the v2 class, it borrows
        # the shared body with its own resource/topology state
        M.HOST_TOTAL.inc()
        try:
            SchedulerService._announce_host(self, request)
        except Exception:
            M.ANNOUNCE_HOST_FAILURE_TOTAL.inc()
            raise
        return v1.Empty()

    def SyncProbes(self, request_iterator, context):
        from dragonfly2_torch.scheduler.service import SchedulerService

        try:
            for resp in SchedulerService._sync_probes(self, request_iterator):
                yield v1.SyncProbesResponse(
                    hosts=[v1.ProbeHost(host=h.host) for h in resp.hosts]
                )
        except Exception:
            M.SYNC_PROBES_FAILURE_TOTAL.inc()
            raise
