"""Host — one machine running a peer daemon (counterpart of the
reference's ``scheduler/resource/host.py``; upstream Dragonfly2's
scheduler/resource/host.go:126-419).

Holds identity, service ports, resource stats (CPU/memory/network/disk),
and the upload accounting the evaluator scores (concurrent slots, success
counters). Hosts own the peers running on them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum

from dragonfly2_torch.schema.records import CPU, Build, Disk, Memory, Network


class HostType(Enum):
    NORMAL = "normal"
    SUPER = "super"  # seed peer
    STRONG = "strong"
    WEAK = "weak"

    @property
    def is_seed(self) -> bool:
        return self is not HostType.NORMAL


# Default upload concurrency when the daemon doesn't announce one
# (upstream config.DefaultPeerConcurrentUploadLimit = 50).
DEFAULT_CONCURRENT_UPLOAD_LIMIT = 50


@dataclass
class Host:
    id: str
    type: HostType = HostType.NORMAL
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    os: str = ""
    platform: str = ""
    platform_family: str = ""
    platform_version: str = ""
    kernel_version: str = ""
    concurrent_upload_limit: int = DEFAULT_CONCURRENT_UPLOAD_LIMIT
    concurrent_upload_count: int = 0
    upload_count: int = 0
    upload_failed_count: int = 0
    cpu: CPU = field(default_factory=CPU)
    memory: Memory = field(default_factory=Memory)
    network: Network = field(default_factory=Network)
    disk: Disk = field(default_factory=Disk)
    build: Build = field(default_factory=Build)
    scheduler_cluster_id: int = 0
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)

    def __post_init__(self) -> None:
        self._peers: dict[str, object] = {}
        self._lock = threading.RLock()

    # -- peer ownership --------------------------------------------------
    def load_peer(self, peer_id: str):
        with self._lock:
            return self._peers.get(peer_id)

    def store_peer(self, peer) -> None:
        with self._lock:
            self._peers[peer.id] = peer

    def delete_peer(self, peer_id: str) -> None:
        with self._lock:
            self._peers.pop(peer_id, None)

    def peer_count(self) -> int:
        with self._lock:
            return len(self._peers)

    def leave_peers(self) -> None:
        """Mark every peer on this host as left (host shutdown/LeaveHost)."""
        with self._lock:
            peers = list(self._peers.values())
        for p in peers:
            if p.fsm.can(_PEER_EVENT_LEAVE):
                p.fsm.event(_PEER_EVENT_LEAVE)

    # -- upload accounting ----------------------------------------------
    def free_upload_count(self) -> int:
        with self._lock:
            return self.concurrent_upload_limit - self.concurrent_upload_count

    def acquire_upload(self) -> None:
        with self._lock:
            self.concurrent_upload_count += 1

    def record_upload(self, success: bool) -> None:
        """Per-piece upload outcome accounting (success counters only;
        concurrent slots are tracked by edge add/remove)."""
        with self._lock:
            self.upload_count += 1
            if not success:
                self.upload_failed_count += 1

    def release_upload(self) -> None:
        """Free one concurrent upload slot (edge removed)."""
        with self._lock:
            self.concurrent_upload_count = max(0, self.concurrent_upload_count - 1)

    def touch(self) -> None:
        self.updated_at = time.time()


# literal rather than an import from peer.py (peer.py imports Host; keeping
# the event name here breaks the cycle)
_PEER_EVENT_LEAVE = "Leave"
