"""Resource managers: in-memory cluster state with interval GC (counterpart
of the reference's ``scheduler/resource/managers.py``; upstream
Dragonfly2's scheduler/resource/{peer,task,host}_manager.go). The swarm
observatory's hooks (peer, peer gone, task gone) come with the server
slice.

GC policy mirrors upstream: peers older than their TTL (or stuck in a
terminal state) are reclaimed, tasks with no peers left are dropped, hosts
with no peers and stale announcements leave.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from dragonfly2_torch.scheduler.resource.host import Host
from dragonfly2_torch.scheduler.resource.peer import (
    PEER_EVENT_LEAVE,
    PEER_STATE_LEAVE,
    Peer,
)
from dragonfly2_torch.scheduler.resource.task import Task
from dragonfly2_torch.utils.gc import GC, GCTask


@dataclass
class GCConfig:
    peer_gc_interval: float = 60.0
    peer_ttl: float = 24 * 3600
    task_gc_interval: float = 120.0
    host_gc_interval: float = 300.0
    host_ttl: float = 6 * 3600


class PeerManager:
    def __init__(self) -> None:
        self._peers: dict[str, Peer] = {}
        self._lock = threading.RLock()

    def load(self, peer_id: str) -> Peer | None:
        with self._lock:
            return self._peers.get(peer_id)

    def store(self, peer: Peer) -> None:
        with self._lock:
            self._peers[peer.id] = peer
        peer.task.store_peer(peer)
        peer.host.store_peer(peer)

    def load_or_store(self, peer: Peer) -> tuple[Peer, bool]:
        with self._lock:
            existing = self._peers.get(peer.id)
            if existing is not None:
                return existing, True
            self._peers[peer.id] = peer
        peer.task.store_peer(peer)
        peer.host.store_peer(peer)
        return peer, False

    def delete(self, peer_id: str) -> None:
        with self._lock:
            peer = self._peers.pop(peer_id, None)
        if peer is not None:
            peer.task.delete_peer(peer_id)
            peer.host.delete_peer(peer_id)

    def all(self) -> list[Peer]:
        with self._lock:
            return list(self._peers.values())

    def run_gc(self, ttl: float) -> int:
        """Reclaim left/stale peers; returns count removed."""
        now = time.time()
        dead = []
        for peer in self.all():
            if peer.fsm.is_state(PEER_STATE_LEAVE):
                dead.append(peer.id)
            elif now - peer.updated_at > ttl:
                if peer.fsm.can(PEER_EVENT_LEAVE):
                    peer.fsm.event(PEER_EVENT_LEAVE)
                dead.append(peer.id)
        for pid in dead:
            self.delete(pid)
        return len(dead)


class TaskManager:
    def __init__(self) -> None:
        self._tasks: dict[str, Task] = {}
        self._lock = threading.RLock()

    def load(self, task_id: str) -> Task | None:
        with self._lock:
            return self._tasks.get(task_id)

    def store(self, task: Task) -> None:
        with self._lock:
            self._tasks[task.id] = task

    def load_or_store(self, task: Task) -> tuple[Task, bool]:
        with self._lock:
            existing = self._tasks.get(task.id)
            if existing is not None:
                return existing, True
            self._tasks[task.id] = task
            return task, False

    def delete(self, task_id: str) -> None:
        with self._lock:
            self._tasks.pop(task_id, None)

    def all(self) -> list[Task]:
        with self._lock:
            return list(self._tasks.values())

    def run_gc(self) -> int:
        """Drop tasks with no peers (upstream task_manager gc: peer-empty
        tasks are unreachable state)."""
        dead = [t.id for t in self.all() if t.peer_count() == 0]
        for tid in dead:
            self.delete(tid)
        return len(dead)


class HostManager:
    def __init__(self) -> None:
        self._hosts: dict[str, Host] = {}
        self._lock = threading.RLock()

    def load(self, host_id: str) -> Host | None:
        with self._lock:
            return self._hosts.get(host_id)

    def store(self, host: Host) -> None:
        with self._lock:
            self._hosts[host.id] = host

    def load_or_store(self, host: Host) -> tuple[Host, bool]:
        with self._lock:
            existing = self._hosts.get(host.id)
            if existing is not None:
                return existing, True
            self._hosts[host.id] = host
            return host, False

    def delete(self, host_id: str) -> None:
        with self._lock:
            self._hosts.pop(host_id, None)

    def all(self) -> list[Host]:
        with self._lock:
            return list(self._hosts.values())

    def run_gc(self, ttl: float) -> int:
        now = time.time()
        dead = []
        for host in self.all():
            if host.peer_count() == 0 and now - host.updated_at > ttl:
                dead.append(host.id)
        for hid in dead:
            self.delete(hid)
        return len(dead)


class Resource:
    """Bundle of the three managers + their GC registration (upstream
    scheduler/resource/resource.go:31-150)."""

    def __init__(self, gc: GC | None = None, config: GCConfig | None = None):
        cfg = config or GCConfig()
        self.config = cfg
        self.peer_manager = PeerManager()
        self.task_manager = TaskManager()
        self.host_manager = HostManager()
        if gc is not None:
            gc.add(GCTask("peer", cfg.peer_gc_interval, 10.0, lambda: self.peer_manager.run_gc(cfg.peer_ttl)))
            gc.add(GCTask("task", cfg.task_gc_interval, 10.0, self.task_manager.run_gc))
            gc.add(GCTask("host", cfg.host_gc_interval, 10.0, lambda: self.host_manager.run_gc(cfg.host_ttl)))
