"""Dfdaemon gRPC service: the daemon's RPC surface.

Counterpart of the reference's ``client/rpcserver.py``.

Role parity: upstream client/daemon/rpcserver/rpcserver.go:129-1123 —
``Download`` server-stream for dfget (:379-401), ``GetPieceTasks``
(:151), ``SyncPieceTasks`` bidi (:268), ``StatTask`` / ``ImportTask`` /
``ExportTask`` / ``DeleteTask`` (dfcache ops).
"""

from __future__ import annotations

import os

import grpc

from dragonfly2_torch.rpc import protos
common_pb2 = protos.load("common_pb2")
dfdaemon_pb2 = protos.load("dfdaemon_pb2")

from dragonfly2_torch.client.peertask import FileTaskRequest, TaskManager
from dragonfly2_torch.client.storage import StorageManager
from dragonfly2_torch.utils import dflog, flows

logger = dflog.get("client.rpc")

from dragonfly2_torch.rpc.glue import DFDAEMON_SERVICE as SERVICE_NAME


class DfdaemonService:
    def __init__(
        self,
        task_manager: TaskManager,
        storage: StorageManager,
        upload_addr: str,
    ):
        self.tasks = task_manager
        self.storage = storage
        self.upload_addr = upload_addr

    # ------------------------------------------------------------------
    def Download(self, request, context):
        """Server-stream of progress results for dfget
        (upstream rpcserver.go:379-401)."""
        req = FileTaskRequest(
            url=request.url,
            output=request.output,
            # UrlMeta.header (dfget --header origin auth) is applied
            # centrally in TaskManager.start_file_task
            url_meta=request.url_meta,
            disable_back_source=request.disable_back_source,
            need_back_to_source=request.need_back_to_source,
        )
        if request.need_back_to_source:
            # the preheat plane is the only caller that forces
            # back-to-source over this RPC (scheduler seed trigger) —
            # mark the task so the ledger attributes its origin bytes
            # to "preheat" seeding, not demand
            flows.mark_preheat(
                self.tasks.task_id_for(request.url, request.url_meta)
            )
        task_id, peer_id, conductor = self.tasks.start_file_task(req)
        if conductor is None:  # reuse path — start_file_task already stored
            ts = self.storage.load(task_id)
            if ts.meta.content_length > 0:
                flows.serve(flows.task_plane(task_id), ts.meta.content_length)
                flows.account(
                    flows.task_plane(task_id),
                    "local_cache",
                    ts.meta.content_length,
                )
            yield dfdaemon_pb2.DownloadResult(
                task_id=task_id,
                peer_id=peer_id,
                done=True,
                completed_length=ts.meta.content_length,
                content_length=ts.meta.content_length,
                output=request.output,
            )
            return

        sub = conductor.subscribe()
        while True:
            p = sub.get()
            if p.error:
                context.abort(grpc.StatusCode.INTERNAL, p.error)
            if p.done and request.output:
                # write the output before the terminal result goes out —
                # the client treats done=True as "bytes are on disk"
                self.storage.load(task_id).store(request.output)
            yield dfdaemon_pb2.DownloadResult(
                task_id=task_id,
                peer_id=peer_id,
                done=p.done,
                completed_length=p.completed_length,
                content_length=p.content_length,
                output=request.output,
            )
            if p.done:
                if p.completed_length > 0:
                    flows.serve(flows.task_plane(task_id), p.completed_length)
                return

    # ------------------------------------------------------------------
    def GetPieceTasks(self, request, context):
        return self._piece_packet(request)

    def SyncPieceTasks(self, request_iterator, context):
        """Bidi metadata sync between daemons (upstream
        peertask_piecetask_synchronizer.go): each request is answered
        with the current piece inventory."""
        for req in request_iterator:
            yield self._piece_packet(req)

    def _piece_packet(self, request) -> dfdaemon_pb2.PiecePacket:
        ts = self.storage.load(request.task_id)
        if ts is None:
            return dfdaemon_pb2.PiecePacket(
                task_id=request.task_id, dst_addr=self.upload_addr
            )
        start = request.start_num or 0
        # limit=0 = whole inventory (the synchronizer streams the full
        # piece set; GetPieceTasks geometry probes pass limit=1)
        limit = request.limit if request.limit else None
        infos = []
        for n in sorted(ts.meta.pieces):
            if n < start or (limit is not None and len(infos) >= limit):
                continue
            pm = ts.meta.pieces[n]
            infos.append(
                common_pb2.PieceInfo(
                    number=pm.number,
                    offset=pm.offset,
                    length=pm.length,
                    digest=pm.digest,
                    traffic_type=pm.traffic_type,
                    cost_ns=pm.cost_ns,
                )
            )
        return dfdaemon_pb2.PiecePacket(
            task_id=request.task_id,
            dst_peer_id=ts.meta.peer_id,
            dst_addr=self.upload_addr,
            piece_infos=infos,
            content_length=ts.meta.content_length,
            total_piece_count=ts.meta.total_piece_count,
            piece_md5_sign_ok=True,
        )

    # ------------------------------------------------------------------
    def StatTask(self, request, context):
        task_id = self.tasks.task_id_for(request.url, request.url_meta)
        ts = self.storage.find_completed_task(task_id)
        if ts is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"task {task_id} not cached")
        return dfdaemon_pb2.Empty()

    def ImportTask(self, request, context):
        """Load a local file into the piece store as a completed task and
        announce it so the importer is discoverable as the first parent
        (dfcache import, upstream rpcserver.go ImportTask)."""
        task_id = self.tasks.task_id_for(request.url, request.url_meta)
        if self.storage.find_completed_task(task_id) is not None:
            return dfdaemon_pb2.Empty()
        try:
            size = os.path.getsize(request.path)
        except OSError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        with open(request.path, "rb") as f:
            self.tasks.import_completed_task(
                task_id, request.url, f.read, size,
                task_type=common_pb2.TASK_TYPE_DFCACHE,
            )
        return dfdaemon_pb2.Empty()

    def ExportTask(self, request, context):
        task_id = self.tasks.task_id_for(request.url, request.url_meta)
        ts = self.storage.find_completed_task(task_id)
        if ts is None:
            if request.local_only:
                context.abort(grpc.StatusCode.NOT_FOUND, f"task {task_id} not cached")
            _, _, progress = self.tasks.wait_file_task(
                FileTaskRequest(url=request.url, output=request.output, url_meta=request.url_meta)
            )
            if not progress.done:
                context.abort(grpc.StatusCode.INTERNAL, progress.error)
            return dfdaemon_pb2.Empty()
        ts.store(request.output)
        return dfdaemon_pb2.Empty()

    def DeleteTask(self, request, context):
        task_id = self.tasks.task_id_for(request.url, request.url_meta)
        self.storage.delete_task(task_id)
        return dfdaemon_pb2.Empty()
