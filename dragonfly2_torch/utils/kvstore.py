"""Embedded KV store + RESP client — the role Redis plays (counterpart of
the reference's ``utils/kvstore.py``).

Upstream Dragonfly2 keeps the probe graph, probed-count counters and the job
queue in Redis (upstream scheduler/networktopology/network_topology.go:52-436,
internal/job). Two backends share one redis-py-shaped interface here:

- ``KVStore`` — in-process store for single-process deployments and tests.
- ``RemoteKVStore`` — RESP2 client for multi-scheduler deployments: point
  it at the manager's embedded RESP server (``utils/kvserver.KVServer``)
  or at an actual Redis — the wire protocol is the real one, so both work.

The scheduler server picks the backend from ``kv_address``: empty → an
in-process store of its own; ``host:port`` → RESP. Like Redis, the remote backend stores
STRINGS — callers serialize structure (the topology's probe entries are
JSON strings, matching what the reference marshals into Redis lists,
probes.go) and parse numbers on read. The in-process store accepts rich
values but the shared consumers stick to strings so both backends behave
identically.
"""

from __future__ import annotations

import fnmatch
import socket
import threading
import time
from typing import Any

from dragonfly2_torch.utils import faults

# fault point: one shared-KV round trip (RemoteKVStore only — the
# in-process store has no wire to fail); kill_conn drills the
# reconnect-on-restart path deterministically
FP_KV_ROUNDTRIP = faults.point("kv.roundtrip")


class KVStore:
    def __init__(self) -> None:
        self._data: dict[str, Any] = {}
        self._expires: dict[str, float] = {}
        self._lock = threading.RLock()

    # -- key management -------------------------------------------------
    def _alive(self, key: str) -> bool:
        exp = self._expires.get(key)
        if exp is not None and time.monotonic() > exp:
            self._data.pop(key, None)
            self._expires.pop(key, None)
            return False
        return key in self._data

    def exists(self, key: str) -> bool:
        with self._lock:
            return self._alive(key)

    def delete(self, *keys: str) -> int:
        with self._lock:
            n = 0
            for key in keys:
                if self._data.pop(key, None) is not None:
                    n += 1
                self._expires.pop(key, None)
            return n

    def expire(self, key: str, ttl_seconds: float) -> bool:
        with self._lock:
            if not self._alive(key):
                return False
            self._expires[key] = time.monotonic() + ttl_seconds
            return True

    def scan_iter(self, pattern: str = "*") -> list[str]:
        with self._lock:
            return [k for k in list(self._data) if self._alive(k) and fnmatch.fnmatchcase(k, pattern)]

    def flushall(self) -> None:
        with self._lock:
            self._data.clear()
            self._expires.clear()

    def close(self) -> None:
        """No-op: interface parity with RemoteKVStore so owners can close
        their backend unconditionally."""

    def _prepare_write(self, key: str) -> None:
        """Drop expired state before writing (redis semantics: a write to an
        expired key starts fresh, never merges into stale data)."""
        exp = self._expires.get(key)
        if exp is not None and time.monotonic() > exp:
            self._data.pop(key, None)
            self._expires.pop(key, None)

    # -- strings / counters ---------------------------------------------
    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value
            self._expires.pop(key, None)  # redis SET clears TTL

    def set_with_ttl(self, key: str, value: Any, ttl_seconds: float) -> None:
        """Atomic SET + expiry (redis ``SET key value PX ms``) — the
        lease-write primitive: a heartbeat that crashed between SET and
        EXPIRE would leave an immortal lease that no failure detector
        ever clears, so the two must be one operation."""
        with self._lock:
            self._data[key] = value
            self._expires[key] = time.monotonic() + ttl_seconds

    def get(self, key: str) -> Any:
        with self._lock:
            return self._data.get(key) if self._alive(key) else None

    def incr(self, key: str, amount: int = 1) -> int:
        with self._lock:
            self._prepare_write(key)
            cur = int(self._data.get(key, 0))
            cur += amount
            self._data[key] = cur
            return cur

    # -- hashes ----------------------------------------------------------
    def hset(self, key: str, mapping: dict[str, Any]) -> int:
        with self._lock:
            self._prepare_write(key)
            h = self._data.setdefault(key, {})
            if not isinstance(h, dict):
                raise TypeError(f"{key} is not a hash")
            h.update(mapping)
            return len(mapping)

    def hget(self, key: str, field: str) -> Any:
        with self._lock:
            h = self._data.get(key) if self._alive(key) else None
            return None if h is None else h.get(field)

    def hdel(self, key: str, *fields: str) -> int:
        with self._lock:
            h = self._data.get(key) if self._alive(key) else None
            if not isinstance(h, dict):
                return 0
            n = 0
            for f in fields:
                if h.pop(f, None) is not None:
                    n += 1
            return n

    def hgetall(self, key: str) -> dict[str, Any]:
        with self._lock:
            h = self._data.get(key) if self._alive(key) else None
            return dict(h) if isinstance(h, dict) else {}

    def hmget(self, key: str, fields: list[str]) -> list[Any]:
        """Batched HGET over one hash (redis HMGET): results align with
        ``fields``, missing fields (or a missing/expired hash) → None."""
        with self._lock:
            h = self._data.get(key) if self._alive(key) else None
            if not isinstance(h, dict):
                return [None] * len(fields)
            return [h.get(f) for f in fields]

    # -- lists (bounded probe queues) ------------------------------------
    # A list is held as a tuple, replaced on every write: a tuple of
    # strings is untracked by the cyclic collector, so a probe graph's
    # queues add nothing to a full collection's walk. A drained list
    # stays an existing, empty key, as the reference's in-process store
    # keeps it.
    def rpush(self, key: str, *values: Any) -> int:
        with self._lock:
            self._prepare_write(key)
            lst = self._data.get(key, ())
            if not isinstance(lst, tuple):
                raise TypeError(f"{key} is not a list")
            lst = self._data[key] = lst + values
            return len(lst)

    def lpop(self, key: str) -> Any:
        with self._lock:
            lst = self._data.get(key) if self._alive(key) else None
            if not lst:
                return None
            if not isinstance(lst, tuple):
                raise TypeError(f"{key} is not a list")
            self._data[key] = lst[1:]
            return lst[0]

    def llen(self, key: str) -> int:
        with self._lock:
            lst = self._data.get(key) if self._alive(key) else None
            return len(lst) if isinstance(lst, tuple) else 0

    def lrange(self, key: str, start: int, stop: int) -> list[Any]:
        """Redis-style inclusive range; stop=-1 means end of list."""
        with self._lock:
            lst = self._data.get(key) if self._alive(key) else None
            if not isinstance(lst, tuple):
                return []
            if stop == -1:
                return list(lst[start:])
            return list(lst[start : stop + 1])


_CRLF = b"\r\n"


class RemoteKVStore:
    """RESP2 client with the same method surface as ``KVStore``.

    One socket, one in-flight command (guarded by a lock) — the callers
    are a scheduler's SyncProbes handlers and periodic snapshots, not a
    throughput path. Reconnects once per call on a dropped connection so
    a restarted server (or Redis failover) doesn't wedge the scheduler.
    All returned values are ``str`` (or ``None``) exactly like redis-py
    with ``decode_responses=True``.
    """

    def __init__(self, address: str, timeout: float = 5.0, secret: str = ""):
        host, _, port = address.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._timeout = timeout
        self._secret = secret
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._buf = b""

    # -- wire ------------------------------------------------------------
    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(self._addr, timeout=self._timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
            self._buf = b""
            if self._secret:
                # AUTH inline on the fresh connection (requirepass
                # semantics, matching KVServer and real Redis) — every
                # reconnect re-authenticates before any queued command
                try:
                    data = self._secret.encode()
                    s.sendall(
                        b"*2" + _CRLF + b"$4" + _CRLF + b"AUTH" + _CRLF
                        + b"$" + str(len(data)).encode() + _CRLF + data + _CRLF
                    )
                    reply = self._read_reply()  # raises ValueError on -ERR
                    if reply != "OK":
                        raise ValueError(f"kv AUTH rejected: {reply!r}")
                except BaseException:
                    # never cache a connection that failed to
                    # authenticate — the next call reconnects cleanly
                    self._drop_connection()
                    raise
        return self._sock

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def _send(self, *parts) -> None:
        out = b"*" + str(len(parts)).encode() + _CRLF
        for p in parts:
            data = p if isinstance(p, bytes) else str(p).encode()
            out += b"$" + str(len(data)).encode() + _CRLF + data + _CRLF
        self._connect().sendall(out)

    def _read_line(self) -> bytes:
        while True:
            nl = self._buf.find(_CRLF)
            if nl >= 0:
                line, self._buf = self._buf[:nl], self._buf[nl + 2 :]
                return line
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("kv server closed connection")
            self._buf += chunk

    def _read_exactly(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise ConnectionError("kv server closed connection")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2 :]
        return data

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise ValueError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            return None if n < 0 else self._read_exactly(n).decode()
        if kind == b"*":
            n = int(rest)
            return None if n < 0 else [self._read_reply() for _ in range(n)]
        raise ValueError(f"bad RESP reply: {line!r}")

    def _drop_connection(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call(self, *parts):
        with self._lock:
            try:
                FP_KV_ROUNDTRIP()
            except Exception as e:
                # kill_conn drills the reconnect path exactly like a
                # server restart: drop the socket, surface the error
                self._drop_connection()
                raise ConnectionError(f"kv fault injected: {e}") from e
            try:
                self._send(*parts)
            except (ConnectionError, OSError):
                # SEND-phase failure: a stale cached connection (server
                # restarted while we were idle). Safe to retry — a
                # partially-written RESP frame is never executed (the
                # server discards incomplete commands when the
                # connection dies), so the command cannot run twice.
                self._drop_connection()
                self._send(*parts)
            try:
                return self._read_reply()
            except (ConnectionError, OSError) as e:
                # READ-phase failure (including socket.timeout): the
                # request WAS delivered and may have executed — a resend
                # would double-apply non-idempotent commands (INCRBY,
                # RPUSH), so propagate instead. redis-py draws the same
                # line (retry_on_timeout is opt-in for this reason). The
                # dropped connection makes the NEXT call reconnect.
                self._drop_connection()
                raise ConnectionError(f"kv reply lost ({e}); not retried") from e

    # -- KVStore surface -------------------------------------------------
    def exists(self, key: str) -> bool:
        return bool(self._call("EXISTS", key))

    def delete(self, *keys: str) -> int:
        return int(self._call("DEL", *keys)) if keys else 0

    def expire(self, key: str, ttl_seconds: float) -> bool:
        # PEXPIRE with integer milliseconds: real Redis rejects a float
        # EXPIRE argument, and sub-second TTLs must not round to zero
        return bool(self._call("PEXPIRE", key, max(1, int(ttl_seconds * 1000))))

    def scan_iter(self, pattern: str = "*") -> list[str]:
        return list(self._call("KEYS", pattern) or [])

    def flushall(self) -> None:
        self._call("FLUSHALL")

    def set(self, key: str, value: Any) -> None:
        self._call("SET", key, value)

    def set_with_ttl(self, key: str, value: Any, ttl_seconds: float) -> None:
        # one atomic round-trip (SET ... PX) — see KVStore.set_with_ttl
        # for why the lease write must never be SET-then-PEXPIRE
        self._call("SET", key, value, "PX", max(1, int(ttl_seconds * 1000)))

    def get(self, key: str):
        return self._call("GET", key)

    def mget(self, keys: list[str]) -> list:
        """Batched GET — one round-trip for N keys (nil → None). The
        in-process KVStore deliberately has no ``mget``: callers detect
        the method and only batch when each key would otherwise cost a
        network round-trip."""
        if not keys:
            return []
        return list(self._call("MGET", *keys) or [])

    def incr(self, key: str, amount: int = 1) -> int:
        return int(self._call("INCRBY", key, amount))

    def hset(self, key: str, mapping: dict[str, Any]) -> int:
        flat: list = []
        for k, v in mapping.items():
            flat.append(k)
            flat.append(v)
        return int(self._call("HSET", key, *flat))

    def hget(self, key: str, field: str):
        return self._call("HGET", key, field)

    def hdel(self, key: str, *fields: str) -> int:
        return int(self._call("HDEL", key, *fields)) if fields else 0

    def hget_batch(self, keys: list[str], field: str) -> list:
        """Pipelined HGET: one write, N replies, one round-trip worth of
        latency — the topology snapshot's updatedAt sweep would
        otherwise pay a round-trip per edge. Replies arrive in command
        order, so results align with ``keys``."""
        if not keys:
            return []
        with self._lock:
            out = b""
            for k in keys:
                frame = b"*3" + _CRLF
                for p in ("HGET", k, field):
                    data = p.encode()
                    frame += b"$" + str(len(data)).encode() + _CRLF + data + _CRLF
                out += frame
            try:
                self._connect().sendall(out)
            except (ConnectionError, OSError):
                # send-phase failure: safe to retry once on a fresh
                # connection (partial frames are never executed)
                self._drop_connection()
                self._connect().sendall(out)
            try:
                return [self._read_reply() for _ in keys]
            except (ConnectionError, OSError) as e:
                # read-phase failure: replies lost; same no-resend rule
                # as _call (HGET is read-only, but a blind resend could
                # interleave with another caller's state)
                self._drop_connection()
                raise ConnectionError(f"kv pipeline reply lost ({e})") from e

    def hmget(self, key: str, fields: list[str]) -> list:
        """Batched HGET over one hash — one HMGET round-trip; results
        align with ``fields`` (nil → None)."""
        if not fields:
            return []
        return list(self._call("HMGET", key, *fields) or [])

    def hset_batch(
        self, writes: list[tuple[str, dict[str, Any]]], ttl_ms: "int | None" = None
    ) -> None:
        """Pipelined HSET: one write burst, N replies — the replication
        flush would otherwise pay a round-trip per dirty task. With
        ``ttl_ms`` a PEXPIRE frame rides per key in the same burst
        (replica hygiene without extra round-trips). Same wire
        discipline as ``hget_batch``: send-phase retry-once on a fresh
        connection (partial frames never execute), read-phase no-resend
        (HSET is not idempotent against concurrent HDEL)."""
        if not writes:
            return
        replies = 0
        with self._lock:
            out = b""
            for key, mapping in writes:
                cmds = [["HSET", key]]
                for f, v in mapping.items():
                    cmds[0].append(f)
                    cmds[0].append(v)
                if ttl_ms is not None:
                    cmds.append(["PEXPIRE", key, max(1, int(ttl_ms))])
                for parts in cmds:
                    frame = b"*" + str(len(parts)).encode() + _CRLF
                    for p in parts:
                        data = p if isinstance(p, bytes) else str(p).encode()
                        frame += b"$" + str(len(data)).encode() + _CRLF + data + _CRLF
                    out += frame
                    replies += 1
            try:
                self._connect().sendall(out)
            except (ConnectionError, OSError):
                self._drop_connection()
                self._connect().sendall(out)
            try:
                for _ in range(replies):
                    self._read_reply()
            except (ConnectionError, OSError) as e:
                self._drop_connection()
                raise ConnectionError(f"kv pipeline reply lost ({e})") from e

    def hgetall(self, key: str) -> dict[str, str]:
        flat = self._call("HGETALL", key) or []
        return dict(zip(flat[::2], flat[1::2]))

    def rpush(self, key: str, *values: Any) -> int:
        return int(self._call("RPUSH", key, *values))

    def lpop(self, key: str):
        return self._call("LPOP", key)

    def llen(self, key: str) -> int:
        return int(self._call("LLEN", key))

    def lrange(self, key: str, start: int, stop: int) -> list[str]:
        return list(self._call("LRANGE", key, start, stop) or [])


# -- key schema (upstream pkg/redis/redis.go) ----------------------------

def make_namespace(*parts: str) -> str:
    return ":".join(parts)


def make_network_topology_key(src_host_id: str, dest_host_id: str) -> str:
    return make_namespace("networktopology", src_host_id, dest_host_id)


def make_probes_key(src_host_id: str, dest_host_id: str) -> str:
    return make_namespace("probes", src_host_id, dest_host_id)


def make_probed_count_key(host_id: str) -> str:
    return make_namespace("probedcount", host_id)


def make_fleet_member_key(address: str) -> str:
    """Scheduler-fleet lease key (scheduler/fleet.py): one leased key per
    live scheduler, expiring when its heartbeat stops."""
    return make_namespace("fleet", "member", address)


# swarm replication plane (scheduler/swarm_replication.py): one hash per
# replicated task, one index hash so sweeps never KEYS-scan, one receipt
# per adoption preserving the victim's last export
SWARM_REPLICA_INDEX_KEY = make_namespace("swarm", "replica", "index")


def make_swarm_replica_key(task_id: str) -> str:
    return make_namespace("swarm", "replica", task_id)


def make_swarm_adopt_key(task_id: str) -> str:
    return make_namespace("swarm", "adopt", task_id)
