"""Generic DAG (counterpart of the reference's ``utils/dag.py``; upstream
Dragonfly2's pkg/graph/dag/dag.go, vertex.go).

Backs the per-task peer tree in the scheduler: vertices are peers, an edge
parent→child means the child downloads pieces from the parent. Cycle
prevention keeps the download graph acyclic; in/out-degree queries drive the
candidate-parent filter rules (upstream scheduling.go:500-571).

Thread-safe: the scheduler mutates the tree from concurrent RPC handlers.
"""

from __future__ import annotations

import threading
from typing import Generic, Iterator, TypeVar

V = TypeVar("V")


class DAGError(Exception):
    pass


class VertexNotFoundError(DAGError):
    pass


class VertexAlreadyExistsError(DAGError):
    pass


class EdgeAlreadyExistsError(DAGError):
    pass


class CycleError(DAGError):
    pass


class Vertex(Generic[V]):
    __slots__ = ("id", "value", "parents", "children")

    def __init__(self, vid: str, value: V):
        self.id = vid
        self.value = value
        self.parents: set[str] = set()
        self.children: set[str] = set()

    @property
    def in_degree(self) -> int:
        return len(self.parents)

    @property
    def out_degree(self) -> int:
        return len(self.children)


class DAG(Generic[V]):
    def __init__(self) -> None:
        self._vertices: dict[str, Vertex[V]] = {}
        self._lock = threading.RLock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._vertices)

    def __contains__(self, vid: str) -> bool:
        with self._lock:
            return vid in self._vertices

    def add_vertex(self, vid: str, value: V) -> None:
        with self._lock:
            if vid in self._vertices:
                raise VertexAlreadyExistsError(vid)
            self._vertices[vid] = Vertex(vid, value)

    def delete_vertex(self, vid: str) -> None:
        with self._lock:
            v = self._vertices.pop(vid, None)
            if v is None:
                return
            for pid in v.parents:
                self._vertices[pid].children.discard(vid)
            for cid in v.children:
                self._vertices[cid].parents.discard(vid)

    def get_vertex(self, vid: str) -> Vertex[V]:
        with self._lock:
            try:
                return self._vertices[vid]
            except KeyError:
                raise VertexNotFoundError(vid) from None

    def vertex_ids(self) -> list[str]:
        with self._lock:
            return list(self._vertices)

    def add_edge(self, from_id: str, to_id: str) -> None:
        """Add edge from→to, refusing self-loops, duplicates and cycles."""
        with self._lock:
            if from_id == to_id:
                raise CycleError(f"self loop on {from_id}")
            f = self.get_vertex(from_id)
            t = self.get_vertex(to_id)
            if to_id in f.children:
                raise EdgeAlreadyExistsError(f"{from_id}->{to_id}")
            if self._reachable(to_id, from_id):
                raise CycleError(f"{from_id}->{to_id} would create a cycle")
            f.children.add(to_id)
            t.parents.add(from_id)

    def delete_edge(self, from_id: str, to_id: str) -> None:
        with self._lock:
            f = self.get_vertex(from_id)
            t = self.get_vertex(to_id)
            f.children.discard(to_id)
            t.parents.discard(from_id)

    def delete_vertex_in_edges(self, vid: str) -> None:
        """Drop every parent edge of ``vid`` (peer switches parents)."""
        with self._lock:
            v = self.get_vertex(vid)
            for pid in list(v.parents):
                self._vertices[pid].children.discard(vid)
            v.parents.clear()

    def delete_vertex_out_edges(self, vid: str) -> None:
        with self._lock:
            v = self.get_vertex(vid)
            for cid in list(v.children):
                self._vertices[cid].parents.discard(vid)
            v.children.clear()

    def can_add_edge(self, from_id: str, to_id: str) -> bool:
        with self._lock:
            if from_id == to_id:
                return False
            if from_id not in self._vertices or to_id not in self._vertices:
                return False
            if to_id in self._vertices[from_id].children:
                return False
            return not self._reachable(to_id, from_id)

    def lenient_random_vertices(self, n: int) -> list[Vertex[V]]:
        """Up to ``n`` vertices in arbitrary order (dict order is fine)."""
        with self._lock:
            out = []
            for v in self._vertices.values():
                if len(out) >= n:
                    break
                out.append(v)
            return out

    def source_vertices(self) -> list[Vertex[V]]:
        with self._lock:
            return [v for v in self._vertices.values() if v.in_degree == 0]

    def sink_vertices(self) -> list[Vertex[V]]:
        with self._lock:
            return [v for v in self._vertices.values() if v.out_degree == 0]

    def descendants(self, vid: str) -> Iterator[str]:
        """BFS over children, excluding ``vid`` itself."""
        with self._lock:
            seen: set[str] = set()
            frontier = list(self.get_vertex(vid).children)
            while frontier:
                nxt = frontier.pop()
                if nxt in seen:
                    continue
                seen.add(nxt)
                frontier.extend(self._vertices[nxt].children)
            return iter(seen)

    def _reachable(self, src: str, dst: str) -> bool:
        """True if dst is reachable from src following child edges."""
        if src == dst:
            return True
        seen: set[str] = set()
        frontier = [src]
        while frontier:
            cur = frontier.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            v = self._vertices.get(cur)
            if v is not None:
                frontier.extend(v.children)
        return False
