"""Batching delta queue between probe ingestion and the device adjacency
(copy of the reference's ``topology/delta.py``).

Probes arrive per RPC; refreshing device arrays per probe would serialize
scheduling on host-to-device copies. The queue absorbs updates cheaply and
the engine drains it in batches at flush time.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass(frozen=True)
class EdgeDelta:
    """One probe measurement headed for the adjacency."""

    src: str
    dest: str
    rtt_ns: int
    created_at: float = field(default_factory=time.time)


class DeltaQueue:
    """FIFO of edge deltas with a drop-oldest cap: a wedged flusher must not
    grow the queue without bound, and the EWMA (0.9 on the newest sample)
    makes the oldest deltas the least informative."""

    def __init__(self, max_pending: int = 100_000):
        self._lock = threading.Lock()
        self._items: list[EdgeDelta] = []
        self._dropped = 0
        self.max_pending = max_pending

    def put(self, delta: EdgeDelta) -> None:
        with self._lock:
            self._items.append(delta)
            if len(self._items) > self.max_pending:
                overflow = len(self._items) - self.max_pending
                del self._items[:overflow]
                self._dropped += overflow

    def drain(self) -> list[EdgeDelta]:
        """Take everything queued so far (order preserved)."""
        with self._lock:
            items, self._items = self._items, []
            return items

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def discard_host(self, host_id: str) -> int:
        """Drop pending deltas touching a departed host."""
        with self._lock:
            before = len(self._items)
            self._items = [
                d for d in self._items if d.src != host_id and d.dest != host_id
            ]
            return before - len(self._items)
