"""Manager database on sqlite3 (counterpart of the reference's
``manager/database.py``; role parity: upstream manager/database —
GORM over MySQL/Postgres; sqlite keeps the same relational shape with
no database server to run).

Tables: scheduler_clusters, schedulers, seed_peer_clusters, seed_peers,
models (the registry rows; weight blobs live in object storage, upstream
manager/models/model.go:19-46), applications, configs.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from pathlib import Path
from typing import Any

_SCHEMA = """
CREATE TABLE IF NOT EXISTS scheduler_clusters (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  config TEXT NOT NULL DEFAULT '{}',
  client_config TEXT NOT NULL DEFAULT '{}',
  scopes TEXT NOT NULL DEFAULT '{}',
  is_default INTEGER NOT NULL DEFAULT 0,
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS schedulers (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  hostname TEXT NOT NULL,
  ip TEXT NOT NULL,
  port INTEGER NOT NULL,
  idc TEXT NOT NULL DEFAULT '',
  location TEXT NOT NULL DEFAULT '',
  state TEXT NOT NULL DEFAULT 'inactive',
  scheduler_cluster_id INTEGER NOT NULL,
  last_keepalive REAL NOT NULL DEFAULT 0,
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL,
  UNIQUE(hostname, ip, scheduler_cluster_id)
);
CREATE TABLE IF NOT EXISTS seed_peer_clusters (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  config TEXT NOT NULL DEFAULT '{}',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS seed_peers (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  hostname TEXT NOT NULL,
  ip TEXT NOT NULL,
  port INTEGER NOT NULL,
  download_port INTEGER NOT NULL DEFAULT 0,
  type TEXT NOT NULL DEFAULT 'super',
  idc TEXT NOT NULL DEFAULT '',
  location TEXT NOT NULL DEFAULT '',
  state TEXT NOT NULL DEFAULT 'inactive',
  seed_peer_cluster_id INTEGER NOT NULL,
  last_keepalive REAL NOT NULL DEFAULT 0,
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL,
  UNIQUE(hostname, ip, seed_peer_cluster_id)
);
CREATE TABLE IF NOT EXISTS models (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  model_id TEXT NOT NULL,
  type TEXT NOT NULL,
  version INTEGER NOT NULL,
  state TEXT NOT NULL DEFAULT 'inactive',
  evaluation TEXT NOT NULL DEFAULT '{}',
  object_key TEXT NOT NULL,
  ip TEXT NOT NULL DEFAULT '',
  hostname TEXT NOT NULL DEFAULT '',
  scheduler_cluster_id INTEGER NOT NULL DEFAULT 0,
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL DEFAULT 0,
  UNIQUE(model_id, version)
);
CREATE TABLE IF NOT EXISTS jobs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  type TEXT NOT NULL,
  state TEXT NOT NULL DEFAULT 'queued',
  args TEXT NOT NULL DEFAULT '{}',
  result TEXT NOT NULL DEFAULT '{}',
  scheduler_cluster_id INTEGER NOT NULL DEFAULT 0,
  leased_by TEXT NOT NULL DEFAULT '',
  group_id TEXT NOT NULL DEFAULT '',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS users (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  email TEXT NOT NULL DEFAULT '',
  password_salt TEXT NOT NULL DEFAULT '',
  password_hash TEXT NOT NULL DEFAULT '',
  role TEXT NOT NULL DEFAULT 'guest',
  state TEXT NOT NULL DEFAULT 'enabled',
  oauth_provider TEXT NOT NULL DEFAULT '',
  oauth_subject TEXT NOT NULL DEFAULT '',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS personal_access_tokens (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  user_id INTEGER NOT NULL,
  name TEXT NOT NULL,
  token_hash TEXT UNIQUE NOT NULL,
  state TEXT NOT NULL DEFAULT 'active',
  expires_at REAL NOT NULL DEFAULT 0,
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS applications (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  url TEXT NOT NULL DEFAULT '',
  priority TEXT NOT NULL DEFAULT '{}',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS settings (
  key TEXT PRIMARY KEY,
  value TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS configs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  value TEXT NOT NULL DEFAULT '',
  bio TEXT NOT NULL DEFAULT '',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS peers (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  host_id TEXT NOT NULL,
  hostname TEXT NOT NULL DEFAULT '',
  ip TEXT NOT NULL DEFAULT '',
  type TEXT NOT NULL DEFAULT 'normal',
  state TEXT NOT NULL DEFAULT 'active',
  peer_count INTEGER NOT NULL DEFAULT 0,
  upload_count INTEGER NOT NULL DEFAULT 0,
  scheduler_cluster_id INTEGER NOT NULL DEFAULT 0,
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL,
  UNIQUE(host_id, scheduler_cluster_id)
);
CREATE TABLE IF NOT EXISTS oauth (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  bio TEXT NOT NULL DEFAULT '',
  client_id TEXT NOT NULL,
  client_secret TEXT NOT NULL,
  redirect_url TEXT NOT NULL DEFAULT '',
  auth_url TEXT NOT NULL,
  token_url TEXT NOT NULL,
  userinfo_url TEXT NOT NULL,
  scopes TEXT NOT NULL DEFAULT '',
  created_at REAL NOT NULL,
  updated_at REAL NOT NULL
);
"""


class Database:
    def __init__(self, path: str | Path = ":memory:"):
        self._conn = sqlite3.connect(str(path), check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._conn.executescript(_SCHEMA)
        self._migrate()
        self._lock = threading.RLock()

    def _migrate(self) -> None:
        """Additive column migrations for databases created by earlier
        versions (CREATE TABLE IF NOT EXISTS never alters existing
        tables)."""
        for table, column, decl in [
            ("models", "updated_at", "REAL NOT NULL DEFAULT 0"),
            # group jobs: one logical job fanned to N scheduler clusters
            # (upstream manager/job createGroupJob / machinery groups)
            ("jobs", "group_id", "TEXT NOT NULL DEFAULT ''"),
            # OAuth identity linkage: which provider+subject this user
            # belongs to ('' = local password account). Sign-in matches
            # on these, never on the display name.
            ("users", "oauth_provider", "TEXT NOT NULL DEFAULT ''"),
            ("users", "oauth_subject", "TEXT NOT NULL DEFAULT ''"),
        ]:
            cols = {r[1] for r in self._conn.execute(f"PRAGMA table_info({table})")}
            if column not in cols:
                self._conn.execute(f"ALTER TABLE {table} ADD COLUMN {column} {decl}")
        self._conn.commit()

    def execute(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        with self._lock:
            cur = self._conn.execute(sql, params)
            self._conn.commit()
            return cur

    def transaction(self):
        """Hold the DB lock across several statements (e.g. job leasing's
        select-then-update must be atomic against other workers)."""
        return self._lock

    def query(self, sql: str, params: tuple = ()) -> list[dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._conn.execute(sql, params).fetchall()]

    def query_one(self, sql: str, params: tuple = ()) -> dict[str, Any] | None:
        rows = self.query(sql, params)
        return rows[0] if rows else None

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- helpers ----------------------------------------------------------
    def ensure_default_cluster(self) -> int:
        row = self.query_one("SELECT id FROM scheduler_clusters WHERE is_default = 1")
        if row:
            return row["id"]
        now = time.time()
        cur = self.execute(
            "INSERT INTO scheduler_clusters (name, is_default, created_at, updated_at)"
            " VALUES ('default', 1, ?, ?)",
            (now, now),
        )
        return cur.lastrowid

    @staticmethod
    def dumps(obj: Any) -> str:
        return json.dumps(obj, separators=(",", ":"))

    @staticmethod
    def loads(s: str) -> Any:
        return json.loads(s) if s else {}
