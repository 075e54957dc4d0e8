"""RESP (Redis wire protocol) server over the embedded KVStore
(counterpart of the reference's ``utils/kvserver.py``).

Upstream Dragonfly2 keeps the probe graph, the probed-count counters and
the probe queues in Redis so N schedulers share them (upstream
scheduler/networktopology/network_topology.go:88-89 takes a
``redis.UniversalClient``; key schema pkg/redis/redis.go). This module
gives the same key schema a cross-process backend without a Redis
dependency: a threaded TCP server speaking RESP2 over ``utils.kvstore``.
The manager embeds it (``kv_port >= 0``), and the scheduler fleet keeps
its leases and swarm replicas there.

Speaking the real protocol (not an ad-hoc RPC) means three things:
- N scheduler processes share one topology store and one fleet plane;
- any Redis client — redis-py, redis-cli — can inspect the store;
- a production deployment can point ``kv_address`` at an actual Redis
  and nothing else changes (``kvstore.RemoteKVStore`` is the client).

Values are strings on the wire, exactly like Redis: callers serialize
structure (the topology's probe entries are JSON strings, which is also
what upstream stores — probes.go marshals JSON into Redis lists).

Commands implemented (the subset the system uses, plus introspection):
AUTH PING ECHO SET (PX/EX) GET MGET DEL EXISTS EXPIRE PEXPIRE INCR
INCRBY HSET HGET HMGET HDEL HGETALL RPUSH LPOP LLEN LRANGE KEYS SCAN
FLUSHALL. Unknown commands get -ERR, never a dropped connection.

Hardening: the server binds loopback by default (network exposure is an
explicit config decision), and a configured ``secret`` gates every data
command behind RESP ``AUTH`` exactly like Redis's ``requirepass`` —
unauthenticated commands get ``-NOAUTH``, wrong secrets get ``-ERR
invalid password`` (redis-py and redis-cli both speak this natively).
"""

from __future__ import annotations

import socket
import socketserver
import threading

from dragonfly2_torch.utils import dflog
from dragonfly2_torch.utils.kvstore import KVStore

logger = dflog.get("kvserver")

CRLF = b"\r\n"


def _bulk(value) -> bytes:
    if value is None:
        return b"$-1" + CRLF
    data = value if isinstance(value, bytes) else str(value).encode()
    return b"$" + str(len(data)).encode() + CRLF + data + CRLF


def _array(items) -> bytes:
    out = b"*" + str(len(items)).encode() + CRLF
    for it in items:
        out += _bulk(it)
    return out


def _int(n: int) -> bytes:
    return b":" + str(int(n)).encode() + CRLF


def _err(msg: str) -> bytes:
    return b"-ERR " + msg.encode() + CRLF


_OK = b"+OK" + CRLF
_PONG = b"+PONG" + CRLF
_NOAUTH = b"-NOAUTH Authentication required." + CRLF


def _compare(given: str, secret: str) -> bool:
    import hmac

    return hmac.compare_digest(given.encode(), secret.encode())


class _Reader:
    """Buffered RESP request reader over a socket."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = b""

    def _fill(self) -> bool:
        chunk = self._sock.recv(65536)
        if not chunk:
            return False
        self._buf += chunk
        return True

    def _line(self) -> bytes | None:
        while True:
            nl = self._buf.find(CRLF)
            if nl >= 0:
                line, self._buf = self._buf[:nl], self._buf[nl + 2 :]
                return line
            if not self._fill():
                return None

    def _exactly(self, n: int) -> bytes | None:
        while len(self._buf) < n + 2:  # payload + CRLF
            if not self._fill():
                return None
        data, self._buf = self._buf[:n], self._buf[n + 2 :]
        return data

    def command(self) -> list[str] | None:
        """One client command as a list of strings; None on EOF. Also
        accepts the inline form ("PING\\r\\n") redis-cli may send."""
        line = self._line()
        if line is None:
            return None
        if not line:
            return []
        if line[:1] != b"*":
            return line.decode(errors="replace").split()  # inline command
        try:
            n = int(line[1:])
        except ValueError:
            return []
        args: list[str] = []
        for _ in range(max(n, 0)):
            hdr = self._line()
            if hdr is None or hdr[:1] != b"$":
                return None
            try:
                ln = int(hdr[1:])
            except ValueError:
                return None
            if ln < 0:
                args.append("")
                continue
            data = self._exactly(ln)
            if data is None:
                return None
            args.append(data.decode(errors="replace"))
        return args


class KVRequestHandler(socketserver.BaseRequestHandler):
    def handle(self) -> None:  # one thread per connection
        store: KVStore = self.server.store  # type: ignore[attr-defined]
        secret: str = getattr(self.server, "secret", "")
        authed = not secret  # no secret configured = open (dev mode)
        reader = _Reader(self.request)
        try:
            while True:
                cmd = reader.command()
                if cmd is None:
                    return
                if not cmd:
                    continue
                op = cmd[0].upper()
                if op == "AUTH":
                    # 1-arg (requirepass) and 2-arg (ACL: user password)
                    # forms, like Redis 6; only the default user exists
                    if not secret:
                        resp = _err("Client sent AUTH, but no password is set")
                    elif len(cmd) not in (2, 3) or (
                        len(cmd) == 3 and cmd[1] != "default"
                    ):
                        resp = _err("invalid username-password pair")
                    elif _compare(cmd[-1], secret):
                        authed = True
                        resp = _OK
                    else:
                        resp = _err("invalid password")
                    self.request.sendall(resp)
                    continue
                if not authed:
                    self.request.sendall(_NOAUTH)
                    continue
                try:
                    resp = self._dispatch(store, cmd)
                except (TypeError, ValueError) as e:
                    resp = _err(str(e))
                self.request.sendall(resp)
        except (ConnectionError, OSError):
            return  # client hung up mid-command — normal teardown

    def _dispatch(self, kv: KVStore, cmd: list[str]) -> bytes:
        op = cmd[0].upper()
        args = cmd[1:]
        if op == "PING":
            return _PONG if not args else _bulk(args[0])
        if op == "ECHO" and len(args) == 1:
            return _bulk(args[0])
        if op == "SET" and len(args) >= 2:
            # PX/EX options (the lease-write form RemoteKVStore.set_with_ttl
            # sends): SET + expiry as one atomic command, like real Redis.
            # A trailing option with no operand must be a -ERR, never an
            # IndexError that kills the connection.
            opts = [a.upper() for a in args[2:]]
            for opt, scale in (("PX", 1000.0), ("EX", 1.0)):
                if opt in opts:
                    at = 2 + opts.index(opt) + 1
                    if at >= len(args):
                        raise ValueError(f"syntax error: {opt} needs a value")
                    kv.set_with_ttl(args[0], args[1], float(args[at]) / scale)
                    break
            else:
                kv.set(args[0], args[1])
            return _OK
        if op == "GET" and len(args) == 1:
            v = kv.get(args[0])
            return _bulk(None if v is None else v)
        if op == "MGET" and args:
            # batched read: one round-trip for N keys (the topology's
            # probed-count fetch is the motivating caller); missing keys
            # are nil entries, like real Redis
            return _array([kv.get(k) for k in args])
        if op == "DEL" and args:
            return _int(kv.delete(*args))
        if op == "EXISTS" and args:
            return _int(sum(1 for k in args if kv.exists(k)))
        if op == "EXPIRE" and len(args) == 2:
            return _int(1 if kv.expire(args[0], float(args[1])) else 0)
        if op == "PEXPIRE" and len(args) == 2:
            return _int(1 if kv.expire(args[0], float(args[1]) / 1000.0) else 0)
        if op == "INCR" and len(args) == 1:
            return _int(kv.incr(args[0]))
        if op == "INCRBY" and len(args) == 2:
            return _int(kv.incr(args[0], int(args[1])))
        if op == "HSET" and len(args) >= 3 and len(args) % 2 == 1:
            mapping = dict(zip(args[1::2], args[2::2]))
            return _int(kv.hset(args[0], mapping))
        if op == "HGET" and len(args) == 2:
            v = kv.hget(args[0], args[1])
            return _bulk(None if v is None else v)
        if op == "HMGET" and len(args) >= 2:
            # batched hash read (the swarm-replication adoption fetch):
            # results align with the requested fields, missing → nil
            return _array(kv.hmget(args[0], list(args[1:])))
        if op == "HDEL" and len(args) >= 2:
            return _int(kv.hdel(args[0], *args[1:]))
        if op == "HGETALL" and len(args) == 1:
            h = kv.hgetall(args[0])
            flat: list = []
            for k, v in h.items():
                flat.append(k)
                flat.append(v)
            return _array(flat)
        if op == "RPUSH" and len(args) >= 2:
            return _int(kv.rpush(args[0], *args[1:]))
        if op == "LPOP" and len(args) == 1:
            v = kv.lpop(args[0])
            return _bulk(None if v is None else v)
        if op == "LLEN" and len(args) == 1:
            return _int(kv.llen(args[0]))
        if op == "LRANGE" and len(args) == 3:
            return _array(kv.lrange(args[0], int(args[1]), int(args[2])))
        if op == "KEYS" and len(args) == 1:
            return _array(kv.scan_iter(args[0]))
        if op == "SCAN" and args:
            # single-batch cursor: everything in one page, cursor 0 ends
            # the iteration (valid RESP — redis-py's scan_iter accepts it)
            pattern = "*"
            if "MATCH" in [a.upper() for a in args[1:]]:
                idx = [a.upper() for a in args[1:]].index("MATCH") + 1
                if idx + 1 <= len(args) - 1:
                    pattern = args[idx + 1]
            keys = kv.scan_iter(pattern)
            return b"*2" + CRLF + _bulk("0") + _array(keys)
        if op == "FLUSHALL":
            kv.flushall()
            return _OK
        return _err(f"unknown command '{op}'")


class KVServer:
    """Threaded RESP server; ``serve()`` binds and returns the port.

    Binds loopback by default — exposing the store on the network is an
    explicit opt-in (pass ``host="0.0.0.0"``), and should come with a
    ``secret`` so every connection must AUTH first."""

    def __init__(
        self,
        store: KVStore | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        secret: str = "",
    ):
        self.store = store if store is not None else KVStore()
        self.secret = secret
        self._host = host
        self._port = port
        self._server: socketserver.ThreadingTCPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._port

    def serve(self) -> int:
        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = _Srv((self._host, self._port), KVRequestHandler)
        self._server.store = self.store  # type: ignore[attr-defined]
        self._server.secret = self.secret  # type: ignore[attr-defined]
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="kv-server", daemon=True
        )
        self._thread.start()
        logger.info("kv server listening on %s:%d", self._host, self._port)
        return self._port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
