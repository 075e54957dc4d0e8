"""Scheduler storage — the training-data sink.

On every finished (or failed) download the service layer builds a
``DownloadRecord`` from live resource state and appends it here (upstream
service_v1.go:1418-1632 createDownloadRecord → storage.CreateDownload);
the topology snapshotter appends ``NetworkTopologyRecord`` rows. Files
rotate by size with bounded backups (upstream
scheduler/storage/storage.go:92-139) and are what the announcer uploads to
the trainer.

Dual sink: CSV (reference-compatible information content) + npz columnar
blocks (the trainer's ingestion fast path).
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

from dataclasses import dataclass, field

from dragonfly2_torch.schema import records as R, wire
from dragonfly2_torch.schema.columnar import RotatingBlockWriter, RotatingCSVWriter
from dragonfly2_torch.scheduler.resource import Peer
from dragonfly2_torch.scheduler.resource.host import Host
from dragonfly2_torch.scheduler.resource.task import Task
from dragonfly2_torch.utils import dflog, profiling

logger = dflog.get("scheduler.storage")

NS_PER_S = 1_000_000_000

# dfprof phase: the per-download training-record append (the storage/KV
# leg of a decision's lifecycle, next to scheduler.evaluate and
# scheduler.topology_rtt in the ledger)
PH_STORE_RECORD = profiling.phase_type("scheduler.store_record")

BLOCK_RECORDS = wire.BLOCK_RECORDS  # block batch floor for the binary sink


@dataclass
class UploadSnapshot:
    """Files moved aside for one Train-stream upload round, per dataset
    and payload format. The announcer ships ONE format per dataset
    (binary when negotiated and present, CSV otherwise) and discards the
    whole snapshot on success — the two forms carry the same records."""

    download_csv: list[Path] = field(default_factory=list)
    topology_csv: list[Path] = field(default_factory=list)
    download_blocks: list[Path] = field(default_factory=list)
    topology_blocks: list[Path] = field(default_factory=list)
    # the CSV files hold records the block files DON'T (a blocks-off era
    # predating this process, see Storage.__init__): the announcer must
    # ship CSV this round even on a binary-capable trainer, or that era
    # would be discarded unshipped after a binary upload
    csv_superset_download: bool = False
    csv_superset_topology: bool = False

    def all_files(self) -> list[Path]:
        return (
            self.download_csv
            + self.topology_csv
            + self.download_blocks
            + self.topology_blocks
        )

    def __bool__(self) -> bool:
        return bool(self.all_files())


class Storage:
    def __init__(
        self,
        directory: str | Path,
        max_size: int = 100 * 1024 * 1024,
        max_backups: int = 10,
        buffer_size: int = 64,
        write_blocks: bool = True,
        rtt_lookup=None,  # topology.TopologyEngine.rtt_affinity_batch
    ):
        self.rtt_lookup = rtt_lookup
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._download = RotatingCSVWriter(
            self.dir, "download", R.DownloadRecord, max_size, max_backups, buffer_size
        )
        self._topology = RotatingCSVWriter(
            self.dir,
            "networktopology",
            R.NetworkTopologyRecord,
            max_size,
            max_backups,
            buffer_size,
        )
        # binary columnar sink: one `train` block (pair features + GRU
        # sequences, extracted in batch HERE) per flushed record buffer —
        # the wire payload the trainer ingests with zero parsing. The
        # block batch is floored at BLOCK_RECORDS (above the CSV buffer):
        # it amortizes both the extraction here and the per-block decode
        # overhead trainer-side, and is the block size the bench
        # synthesizes so its decode rate reflects production blocks.
        # rtt_lookup (installed by the scheduler server when the
        # topology engine is on) joins live adjacency RTT into the
        # rtt_affinity column at block-encode time — so the trained
        # model sees the same feature distribution the live evaluator
        # feeds it, instead of a constant missing-value
        self._blocks_download = (
            RotatingBlockWriter(
                self.dir / "blocks",
                "download",
                lambda recs: wire.encode_train_block(
                    recs, rtt_lookup=self.rtt_lookup
                ),
                max_size,
                max_backups,
                max(buffer_size, BLOCK_RECORDS),
            )
            if write_blocks
            else None
        )
        self._blocks_topology = (
            RotatingBlockWriter(
                self.dir / "blocks",
                "networktopology",
                wire.encode_topology_block,
                max_size,
                max_backups,
                max(buffer_size, BLOCK_RECORDS),
            )
            if write_blocks
            else None
        )
        self._lock = threading.Lock()
        # optional same-thread observer for each download record written
        # (the preheat demand window folds arrivals through this); called
        # OUTSIDE self._lock so a slow observer never stalls record writes
        self.on_download = None
        # blocks-off-era detection: the CSV sink ALWAYS runs while the
        # block sink is optional, so CSV ⊇ blocks — records written by a
        # previous process with write_blocks=False exist ONLY as CSV. If
        # startup finds CSV data with no blocks beside it, the next
        # upload round must ship CSV even when the trainer negotiates
        # binary, or the era would be discarded unshipped. (A partial
        # blockless era INSIDE a mixed history is undetectable and
        # bounded by CSV rotation; config toggles are restarts, so the
        # common case is exactly this startup shape.)
        self._csv_superset_download = bool(
            self._blocks_download is not None
            and self._download.all_files()
            and not self._blocks_download.all_files()
        )
        self._csv_superset_topology = bool(
            self._blocks_topology is not None
            and self._topology.all_files()
            and not self._blocks_topology.all_files()
        )

    # -- writes ----------------------------------------------------------
    def create_download(self, rec: R.DownloadRecord) -> None:
        with PH_STORE_RECORD:
            with self._lock:
                self._download.create(rec)
                if self._blocks_download is not None:
                    self._blocks_download.create(rec)
            if self.on_download is not None:
                try:
                    self.on_download(rec)
                except Exception:
                    # demand folding is advisory; the record sink is not
                    logger.exception("download observer failed")

    def create_network_topology(self, rec: R.NetworkTopologyRecord) -> None:
        with self._lock:
            self._topology.create(rec)
            if self._blocks_topology is not None:
                self._blocks_topology.create(rec)

    def flush(self) -> None:
        with self._lock:
            self._download.flush()
            self._topology.flush()
            if self._blocks_download is not None:
                self._blocks_download.flush()
            if self._blocks_topology is not None:
                self._blocks_topology.flush()

    # -- reads (trainer upload path) --------------------------------------
    def list_download(self) -> list[R.DownloadRecord]:
        with self._lock:
            return self._download.read_all()

    def list_network_topology(self) -> list[R.NetworkTopologyRecord]:
        with self._lock:
            return self._topology.read_all()

    def open_download_files(self) -> list[Path]:
        with self._lock:
            self._download.flush()
            return self._download.all_files()

    def open_network_topology_files(self) -> list[Path]:
        with self._lock:
            self._topology.flush()
            return self._topology.all_files()

    def snapshot_for_upload(self) -> UploadSnapshot:
        """Atomically move the current download/topology files — BOTH
        payload forms — into a pending-upload dir and return them (any
        leftovers from a prior failed upload are included for retry).
        Records written during the subsequent slow Train stream go to
        fresh files and survive — unlike a clear()-after-upload, which
        would destroy them."""
        with self._lock:
            pending = self.dir / "upload-pending"
            snap = UploadSnapshot(
                download_csv=self._download.snapshot(pending / "download"),
                topology_csv=self._topology.snapshot(pending / "networktopology"),
                csv_superset_download=self._csv_superset_download,
                csv_superset_topology=self._csv_superset_topology,
            )
            if self._blocks_download is not None:
                snap.download_blocks = self._blocks_download.snapshot(
                    pending / "download-blocks"
                )
            if self._blocks_topology is not None:
                snap.topology_blocks = self._blocks_topology.snapshot(
                    pending / "networktopology-blocks"
                )
            return snap

    def discard_uploaded(self, files: list[Path]) -> None:
        """Drop a successfully uploaded snapshot. Only now does the
        blocks-off-era flag clear: a FAILED upload leaves the mixed-era
        CSV files in the pending dir for the next round's snapshot,
        which must keep preferring CSV until they actually ship."""
        for p in files:
            p.unlink(missing_ok=True)
        with self._lock:
            self._csv_superset_download = False
            self._csv_superset_topology = False

    def clear_download(self) -> None:
        with self._lock:
            self._download.clear()
            if self._blocks_download is not None:
                self._blocks_download.clear()

    def clear_network_topology(self) -> None:
        with self._lock:
            self._topology.clear()
            if self._blocks_topology is not None:
                self._blocks_topology.clear()


# ---------------------------------------------------------------------------
# Record construction from live resource state
# ---------------------------------------------------------------------------


def host_record(h: Host) -> R.HostRecord:
    return R.HostRecord(
        id=h.id,
        type=h.type.value,
        hostname=h.hostname,
        ip=h.ip,
        port=h.port,
        download_port=h.download_port,
        os=h.os,
        platform=h.platform,
        platform_family=h.platform_family,
        platform_version=h.platform_version,
        kernel_version=h.kernel_version,
        concurrent_upload_limit=h.concurrent_upload_limit,
        concurrent_upload_count=h.concurrent_upload_count,
        upload_count=h.upload_count,
        upload_failed_count=h.upload_failed_count,
        cpu=h.cpu,
        memory=h.memory,
        network=h.network,
        disk=h.disk,
        build=h.build,
        scheduler_cluster_id=h.scheduler_cluster_id,
        created_at=int(h.created_at * NS_PER_S),
        updated_at=int(h.updated_at * NS_PER_S),
    )


def task_record(t: Task) -> R.TaskRecord:
    return R.TaskRecord(
        id=t.id,
        url=t.url,
        type=t.type.value,
        content_length=t.content_length,
        total_piece_count=t.total_piece_count,
        back_to_source_limit=t.back_to_source_limit,
        back_to_source_peer_count=len(t.back_to_source_peers),
        state=t.fsm.current,
        created_at=int(t.created_at * NS_PER_S),
        updated_at=int(t.updated_at * NS_PER_S),
    )


def build_download_record(
    peer: Peer, error_code: str = "", error_message: str = ""
) -> R.DownloadRecord:
    """Snapshot a finished/failed peer into the MLP training schema
    (upstream service_v1.go:1418-1632): the peer itself, its task and
    host, and up to 20 parents each with up to 10 per-piece costs."""
    task = peer.task
    parents: list[R.ParentRecord] = []
    for parent in task.peer_parents(peer.id)[: R.MAX_PARENTS]:
        pieces = [
            R.PieceRecord(
                length=pc.length,
                cost=int(pc.cost_ms * 1e6),
                created_at=int(pc.created_at * NS_PER_S) if pc.created_at else 0,
            )
            for pc in _parent_pieces(peer, parent.id)[: R.MAX_PIECES_PER_PARENT]
        ]
        parents.append(
            R.ParentRecord(
                id=parent.id,
                tag=parent.tag,
                application=parent.application,
                state=parent.fsm.current,
                cost=parent.cost_ns,
                upload_piece_count=len(pieces),
                finished_piece_count=parent.finished_piece_count(),
                host=host_record(parent.host),
                pieces=pieces,
                created_at=int(parent.created_at * NS_PER_S),
                updated_at=int(parent.updated_at * NS_PER_S),
            )
        )
    return R.DownloadRecord(
        id=peer.id,
        tag=peer.tag,
        application=peer.application,
        state=peer.fsm.current,
        error=R.ErrorInfo(code=error_code, message=error_message),
        cost=peer.cost_ns,
        finished_piece_count=peer.finished_piece_count(),
        task=task_record(task),
        host=host_record(peer.host),
        parents=parents,
        created_at=int(peer.created_at * NS_PER_S),
        updated_at=int(peer.updated_at * NS_PER_S),
    )


def _parent_pieces(peer: Peer, parent_id: str):
    """Pieces this child downloaded from this specific parent (piece
    provenance lives on the downloading peer)."""
    out = []
    for number in sorted(peer.finished_pieces):
        piece = peer.pieces.get(number)
        if piece is not None and piece.parent_id == parent_id:
            out.append(piece)
    return out
