"""Read-through cache in front of the manager database (counterpart of the
reference's ``manager/cache.py``; role parity:
upstream manager/cache — Redis keys in front of GORM lookups with TTL,
invalidated on writes; manager/database + pkg/cache).

``CachedDatabase`` is a drop-in for ``Database``: ``query``/``query_one``
results are cached by (sql, params) and tagged with the tables the
statement reads; any ``execute`` that changes rows invalidates every
cached result touching the tables it writes. The manager's hot path —
dynconfig polls of GetScheduler/ListSchedulers/GetSchedulerClusterConfig
from every scheduler and daemon in the fleet — hits sqlite once per TTL
instead of once per poll, the same pressure-relief upstream buys
with Redis.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any

from dragonfly2_torch.manager.database import Database

_TABLE_RX = re.compile(r"(?:FROM|INTO|UPDATE|JOIN)\s+([A-Za-z_][A-Za-z0-9_]*)", re.I)


def tables_of(sql: str) -> frozenset[str]:
    """Tables a statement touches (read or write), for tag invalidation."""
    return frozenset(t.lower() for t in _TABLE_RX.findall(sql))


class CachedDatabase:
    """TTL read cache over ``Database`` with write invalidation.

    Correctness stance: a write through THIS wrapper invalidates
    immediately (read-your-writes within the process); concurrent writers
    sharing the sqlite file are bounded by ``ttl`` staleness, same as
    upstream's Redis TTLs.

    The store path is generation-stamped per table: a reader that fetched
    rows before a write landed can never install them after the write's
    invalidation (the classic read-aside race) — its snapshot of the
    table generations no longer matches, so the store is discarded.
    """

    def __init__(self, db: Database, ttl: float = 30.0):
        self.db = db
        self.ttl = ttl
        self._lock = threading.Lock()
        # key -> (expires_at, tables, rows)
        self._entries: dict[tuple, tuple[float, frozenset[str], list[dict]]] = {}
        self._gens: dict[str, int] = {}  # table -> invalidation generation
        self.hits = 0
        self.misses = 0

    # -- reads -----------------------------------------------------------
    def query(self, sql: str, params: tuple = ()) -> list[dict[str, Any]]:
        key = (sql, params)
        tabs = tables_of(sql)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0] > time.monotonic():
                self.hits += 1
                return [dict(r) for r in entry[2]]  # callers may mutate rows
            self.misses += 1
            snapshot = {t: self._gens.get(t, 0) for t in tabs}
        rows = self.db.query(sql, params)
        with self._lock:
            if all(self._gens.get(t, 0) == g for t, g in snapshot.items()):
                self._entries[key] = (time.monotonic() + self.ttl, tabs, rows)
            # else: a write to one of these tables raced the read — the
            # rows may predate it, so they must not outlive this call
        return [dict(r) for r in rows]

    def query_one(self, sql: str, params: tuple = ()) -> dict[str, Any] | None:
        rows = self.query(sql, params)
        return rows[0] if rows else None

    # -- writes ----------------------------------------------------------
    def execute(self, sql: str, params: tuple = ()):
        cur = self.db.execute(sql, params)
        # a 0-row UPDATE/DELETE changed nothing — keep the cache warm
        # (ListSchedulers' _expire_stale sweep runs on every poll and
        # usually matches nothing; unconditional invalidation would make
        # the hot path miss every time). rowcount is -1 for non-DML —
        # invalidate conservatively then.
        if cur.rowcount != 0:
            self.invalidate(*tables_of(sql))
        return cur

    def invalidate(self, *tables: str) -> None:
        """Drop every cached result reading any of ``tables`` (all tables
        when called with none)."""
        targets = {t.lower() for t in tables}
        with self._lock:
            if not targets:
                targets = set(self._gens) | {
                    t for _, tabs, _ in self._entries.values() for t in tabs
                }
            for t in targets:
                self._gens[t] = self._gens.get(t, 0) + 1
            dead = [
                k
                for k, (_, tabs, _) in self._entries.items()
                if not targets or tabs & targets
            ]
            for k in dead:
                del self._entries[k]

    # -- passthrough -----------------------------------------------------
    def transaction(self):
        # leasing-style select-then-update must see live rows: flush all
        # cached reads so queries inside the lock go to the database
        self.invalidate()
        return self.db.transaction()

    def close(self) -> None:
        self.db.close()

    def ensure_default_cluster(self) -> int:
        self.invalidate("scheduler_clusters")
        return self.db.ensure_default_cluster()

    dumps = staticmethod(Database.dumps)
    loads = staticmethod(Database.loads)
