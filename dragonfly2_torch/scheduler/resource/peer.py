"""Peer — one download attempt of one task by one host (upstream
scheduler/resource/peer.go:51-330).

Lifecycle FSM:
  Pending → Received{Empty,Tiny,Small,Normal} → Running
          → BackToSource | Succeeded | Failed | Leave
(upstream peer.go:226-247 transition table, reproduced exactly — the
filter rules and bad-node checks key off these states).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from dragonfly2_torch.scheduler import swarm
from dragonfly2_torch.scheduler.resource.fsm import FSM, Transition
from dragonfly2_torch.scheduler.resource.host import Host

# states
PEER_STATE_PENDING = "Pending"
PEER_STATE_RECEIVED_EMPTY = "ReceivedEmpty"
PEER_STATE_RECEIVED_TINY = "ReceivedTiny"
PEER_STATE_RECEIVED_SMALL = "ReceivedSmall"
PEER_STATE_RECEIVED_NORMAL = "ReceivedNormal"
PEER_STATE_RUNNING = "Running"
PEER_STATE_BACK_TO_SOURCE = "BackToSource"
PEER_STATE_SUCCEEDED = "Succeeded"
PEER_STATE_FAILED = "Failed"
PEER_STATE_LEAVE = "Leave"

# events
PEER_EVENT_REGISTER_EMPTY = "RegisterEmpty"
PEER_EVENT_REGISTER_TINY = "RegisterTiny"
PEER_EVENT_REGISTER_SMALL = "RegisterSmall"
PEER_EVENT_REGISTER_NORMAL = "RegisterNormal"
PEER_EVENT_DOWNLOAD = "Download"
PEER_EVENT_DOWNLOAD_BACK_TO_SOURCE = "DownloadBackToSource"
PEER_EVENT_DOWNLOAD_SUCCEEDED = "DownloadSucceeded"
PEER_EVENT_DOWNLOAD_FAILED = "DownloadFailed"
PEER_EVENT_LEAVE = "Leave"

_RECEIVED = (
    PEER_STATE_RECEIVED_EMPTY,
    PEER_STATE_RECEIVED_TINY,
    PEER_STATE_RECEIVED_SMALL,
    PEER_STATE_RECEIVED_NORMAL,
)

_TRANSITIONS = [
    Transition(PEER_EVENT_REGISTER_EMPTY, (PEER_STATE_PENDING,), PEER_STATE_RECEIVED_EMPTY),
    Transition(PEER_EVENT_REGISTER_TINY, (PEER_STATE_PENDING,), PEER_STATE_RECEIVED_TINY),
    Transition(PEER_EVENT_REGISTER_SMALL, (PEER_STATE_PENDING,), PEER_STATE_RECEIVED_SMALL),
    Transition(PEER_EVENT_REGISTER_NORMAL, (PEER_STATE_PENDING,), PEER_STATE_RECEIVED_NORMAL),
    Transition(PEER_EVENT_DOWNLOAD, _RECEIVED, PEER_STATE_RUNNING),
    Transition(
        PEER_EVENT_DOWNLOAD_BACK_TO_SOURCE,
        _RECEIVED + (PEER_STATE_RUNNING,),
        PEER_STATE_BACK_TO_SOURCE,
    ),
    Transition(
        PEER_EVENT_DOWNLOAD_SUCCEEDED,
        _RECEIVED + (PEER_STATE_RUNNING, PEER_STATE_BACK_TO_SOURCE),
        PEER_STATE_SUCCEEDED,
    ),
    Transition(
        PEER_EVENT_DOWNLOAD_FAILED,
        (PEER_STATE_PENDING,)
        + _RECEIVED
        + (PEER_STATE_RUNNING, PEER_STATE_BACK_TO_SOURCE, PEER_STATE_SUCCEEDED),
        PEER_STATE_FAILED,
    ),
    Transition(
        PEER_EVENT_LEAVE,
        (PEER_STATE_PENDING,)
        + _RECEIVED
        + (
            PEER_STATE_RUNNING,
            PEER_STATE_BACK_TO_SOURCE,
            PEER_STATE_FAILED,
            PEER_STATE_SUCCEEDED,
        ),
        PEER_STATE_LEAVE,
    ),
]


class Peer:
    def __init__(
        self,
        peer_id: str,
        task,  # Task — untyped to avoid import cycle
        host: Host,
        tag: str = "",
        application: str = "",
        priority: int = 0,
        range_header: str = "",
    ):
        self.id = peer_id
        self.task = task
        self.host = host
        self.tag = tag
        self.application = application
        self.priority = priority
        self.range_header = range_header

        # one observatory hook covers every fsm.event() call site; the
        # FSM invokes it after its lock is released (swarm takes its own)
        self.fsm = FSM(
            PEER_STATE_PENDING,
            _TRANSITIONS,
            on_transition=lambda state, _t=task.id, _p=peer_id: swarm.on_state(
                _t, _p, state
            ),
        )
        self.finished_pieces: set[int] = set()
        # piece number → Piece (with parent provenance) for this download
        self.pieces: dict[int, object] = {}
        self.piece_costs_ms: list[float] = []
        self.piece_updated_at = time.time()
        self.need_back_to_source = False
        self.block_parents: set[str] = set()
        self.cost_ns: int = 0
        self.created_at = time.time()
        self.updated_at = time.time()
        self._lock = threading.RLock()
        # transport handle for pushing scheduling decisions (the v2
        # AnnouncePeer stream / v1 ReportPieceResult stream equivalent)
        self._stream = None

    # -- stream handle ---------------------------------------------------
    def store_stream(self, stream) -> None:
        self._stream = stream

    def load_stream(self):
        return self._stream

    def delete_stream(self) -> None:
        self._stream = None

    # -- piece accounting ------------------------------------------------
    def append_piece_cost(self, cost_ms: float) -> None:
        with self._lock:
            self.piece_costs_ms.append(cost_ms)
            self.piece_updated_at = time.time()

    def piece_costs(self) -> list[float]:
        with self._lock:
            return list(self.piece_costs_ms)

    def finish_piece(self, number: int, cost_ms: float | None = None, piece=None) -> None:
        with self._lock:
            self.finished_pieces.add(number)
            if piece is not None:
                self.pieces[number] = piece
            if cost_ms is not None:
                self.piece_costs_ms.append(cost_ms)
            self.piece_updated_at = time.time()
            self.updated_at = time.time()
            done = len(self.finished_pieces)
        # observatory hook outside our lock (it takes the module ledger
        # lock; locks never nest across the two)
        swarm.on_piece(self.task.id, self.id, done, self.task.total_piece_count)

    def finished_piece_count(self) -> int:
        with self._lock:
            return len(self.finished_pieces)

    def touch(self) -> None:
        self.updated_at = time.time()

    def __repr__(self) -> str:
        return f"Peer({self.id[:12]}…, {self.fsm.current}, host={self.host.id[:8]}…)"
