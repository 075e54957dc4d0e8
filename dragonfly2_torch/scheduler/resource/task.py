"""Task — one downloadable object, shared by all its peers (counterpart of
the reference's ``scheduler/resource/task.py``; upstream Dragonfly2's
scheduler/resource/task.go:56-530).

Carries the per-task peer DAG: an edge parent→child means the child
downloads pieces from the parent. The DAG's cycle prevention and degree
queries drive the candidate-parent filter rules (upstream
scheduling.go:500-571).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from enum import Enum

from dragonfly2_torch.scheduler.resource.fsm import FSM, Transition
from dragonfly2_torch.scheduler.resource.peer import (
    PEER_STATE_BACK_TO_SOURCE,
    PEER_STATE_FAILED,
    PEER_STATE_LEAVE,
    PEER_STATE_RUNNING,
    PEER_STATE_SUCCEEDED,
    Peer,
)
from dragonfly2_torch.utils.dag import DAG

EMPTY_FILE_SIZE = 0
TINY_FILE_SIZE = 128  # bytes embeddable directly in registration responses

TASK_STATE_PENDING = "Pending"
TASK_STATE_RUNNING = "Running"
TASK_STATE_SUCCEEDED = "Succeeded"
TASK_STATE_FAILED = "Failed"
TASK_STATE_LEAVE = "Leave"

TASK_EVENT_DOWNLOAD = "Download"
TASK_EVENT_DOWNLOAD_SUCCEEDED = "DownloadSucceeded"
TASK_EVENT_DOWNLOAD_FAILED = "DownloadFailed"
TASK_EVENT_LEAVE = "Leave"

_TRANSITIONS = [
    Transition(
        TASK_EVENT_DOWNLOAD,
        (TASK_STATE_PENDING, TASK_STATE_SUCCEEDED, TASK_STATE_FAILED, TASK_STATE_LEAVE),
        TASK_STATE_RUNNING,
    ),
    Transition(
        TASK_EVENT_DOWNLOAD_SUCCEEDED,
        (TASK_STATE_LEAVE, TASK_STATE_RUNNING, TASK_STATE_FAILED),
        TASK_STATE_SUCCEEDED,
    ),
    Transition(TASK_EVENT_DOWNLOAD_FAILED, (TASK_STATE_RUNNING,), TASK_STATE_FAILED),
    Transition(
        TASK_EVENT_LEAVE,
        (TASK_STATE_PENDING, TASK_STATE_RUNNING, TASK_STATE_SUCCEEDED, TASK_STATE_FAILED),
        TASK_STATE_LEAVE,
    ),
]


class SizeScope(Enum):
    EMPTY = "empty"
    TINY = "tiny"
    SMALL = "small"
    NORMAL = "normal"
    UNKNOW = "unknow"


class TaskType(Enum):
    STANDARD = "standard"  # dfdaemon download (can back-to-source)
    DFSTORE = "dfstore"
    DFCACHE = "dfcache"  # cache-only: no origin, no back-to-source


@dataclass
class Piece:
    number: int
    parent_id: str = ""
    offset: int = 0
    length: int = 0
    digest: str = ""
    traffic_type: str = ""
    cost_ms: float = 0.0
    created_at: float = 0.0


class Task:
    def __init__(
        self,
        task_id: str,
        url: str = "",
        task_type: TaskType = TaskType.STANDARD,
        digest: str = "",
        tag: str = "",
        application: str = "",
        filters: list[str] | None = None,
        url_range: str = "",
        headers: dict[str, str] | None = None,
        piece_length: int = 4 * 1024 * 1024,
        back_to_source_limit: int = 3,
    ):
        self.id = task_id
        self.url = url
        self.type = task_type
        self.digest = digest
        self.tag = tag
        self.application = application
        self.filters = filters or []
        self.url_range = url_range
        self.headers = headers or {}
        self.piece_length = piece_length
        self.content_length = -1
        self.total_piece_count = -1
        self.back_to_source_limit = back_to_source_limit
        self.back_to_source_peers: set[str] = set()
        self.direct_piece = b""  # tiny-file payload served straight from metadata
        self.fsm = FSM(TASK_STATE_PENDING, _TRANSITIONS)
        self.created_at = time.time()
        self.updated_at = time.time()

        self._peers: dict[str, Peer] = {}
        self._pieces: dict[int, Piece] = {}
        self._dag: DAG[Peer] = DAG()
        self._lock = threading.RLock()

    # -- peers -----------------------------------------------------------
    def load_peer(self, peer_id: str) -> Peer | None:
        with self._lock:
            return self._peers.get(peer_id)

    def store_peer(self, peer: Peer) -> None:
        with self._lock:
            self._peers[peer.id] = peer
            if peer.id not in self._dag:
                self._dag.add_vertex(peer.id, peer)

    def delete_peer(self, peer_id: str) -> None:
        with self._lock:
            # release upload slots held by this peer's edges before the
            # vertex vanishes — otherwise parents leak concurrent capacity
            if peer_id in self._dag:
                self.delete_peer_in_edges(peer_id)
                self.delete_peer_out_edges(peer_id)
            self._peers.pop(peer_id, None)
            self._dag.delete_vertex(peer_id)
            self.back_to_source_peers.discard(peer_id)

    def peer_count(self) -> int:
        with self._lock:
            return len(self._peers)

    def load_random_peers(self, n: int) -> list[Peer]:
        """Up to n peers, randomly sampled — the filter pool (upstream
        task.go:243-251 LoadRandomPeers)."""
        with self._lock:
            ids = list(self._peers)
        random.shuffle(ids)
        with self._lock:
            return [self._peers[i] for i in ids[:n] if i in self._peers]

    # -- peer DAG --------------------------------------------------------
    def add_peer_edge(self, parent: Peer, child: Peer) -> None:
        with self._lock:
            self._dag.add_edge(parent.id, child.id)
            parent.host.acquire_upload()

    def delete_peer_in_edges(self, peer_id: str) -> None:
        with self._lock:
            if peer_id not in self._dag:
                return
            v = self._dag.get_vertex(peer_id)
            for pid in list(v.parents):
                p = self._peers.get(pid)
                if p is not None:
                    p.host.release_upload()
            self._dag.delete_vertex_in_edges(peer_id)

    def delete_peer_out_edges(self, peer_id: str) -> None:
        with self._lock:
            if peer_id not in self._dag:
                return
            v = self._dag.get_vertex(peer_id)
            host = self._peers[peer_id].host if peer_id in self._peers else None
            for _ in range(len(v.children)):
                if host is not None:
                    host.release_upload()
            self._dag.delete_vertex_out_edges(peer_id)

    def can_add_peer_edge(self, from_id: str, to_id: str) -> bool:
        with self._lock:
            return self._dag.can_add_edge(from_id, to_id)

    def peer_in_degree(self, peer_id: str) -> int:
        with self._lock:
            return self._dag.get_vertex(peer_id).in_degree  # raises if absent

    def peer_out_degree(self, peer_id: str) -> int:
        with self._lock:
            return self._dag.get_vertex(peer_id).out_degree

    def peer_children(self, peer_id: str) -> list[Peer]:
        with self._lock:
            v = self._dag.get_vertex(peer_id)
            return [self._peers[c] for c in v.children if c in self._peers]

    def peer_parents(self, peer_id: str) -> list[Peer]:
        with self._lock:
            v = self._dag.get_vertex(peer_id)
            return [self._peers[p] for p in v.parents if p in self._peers]

    # -- availability / scope --------------------------------------------
    def has_available_peer(self, blocklist: set[str] | None = None) -> bool:
        blocklist = blocklist or set()
        with self._lock:
            for peer in self._peers.values():
                if peer.id in blocklist:
                    continue
                if peer.fsm.is_state(
                    PEER_STATE_SUCCEEDED, PEER_STATE_RUNNING, PEER_STATE_BACK_TO_SOURCE
                ):
                    return True
        return False

    def load_seed_peer(self) -> Peer | None:
        """Latest seed-host peer that isn't failed/left (upstream
        task.go:388-414)."""
        with self._lock:
            seeds = [
                p
                for p in self._peers.values()
                if p.host.type.is_seed
                and not p.fsm.is_state(PEER_STATE_FAILED, PEER_STATE_LEAVE)
            ]
        if not seeds:
            return None
        return max(seeds, key=lambda p: p.updated_at)

    def is_seed_peer_failed(self) -> bool:
        with self._lock:
            return any(
                p.host.type.is_seed and p.fsm.is_state(PEER_STATE_FAILED)
                for p in self._peers.values()
            )

    def size_scope(self) -> SizeScope:
        if self.content_length < 0 or self.total_piece_count < 0:
            return SizeScope.UNKNOW
        if self.content_length == EMPTY_FILE_SIZE:
            return SizeScope.EMPTY
        if self.content_length <= TINY_FILE_SIZE:
            return SizeScope.TINY
        if self.total_piece_count == 1:
            return SizeScope.SMALL
        return SizeScope.NORMAL

    def can_back_to_source(self) -> bool:
        with self._lock:
            return (
                len(self.back_to_source_peers) <= self.back_to_source_limit
                and self.type in (TaskType.STANDARD, TaskType.DFSTORE)
            )

    def can_reuse_direct_piece(self) -> bool:
        return len(self.direct_piece) > 0 and len(self.direct_piece) == self.content_length

    # -- pieces ----------------------------------------------------------
    def load_piece(self, number: int) -> Piece | None:
        with self._lock:
            return self._pieces.get(number)

    def store_piece(self, piece: Piece) -> None:
        with self._lock:
            self._pieces[piece.number] = piece

    def delete_piece(self, number: int) -> None:
        with self._lock:
            self._pieces.pop(number, None)

    def touch(self) -> None:
        self.updated_at = time.time()
