"""Readiness-based transfer plane: the shared event loop and the bounded
keep-alive connection pool the daemon's piece paths ride
(docs/data-plane.md; counterpart of the reference's ``client/transfer.py``).

Two consumers:

- :class:`TransferPool` — the CHILD side. ``downloader.download_piece``
  submits piece fetches here; the pool multiplexes them over a bounded
  set of persistent HTTP/1.1 connections (one keep-alive socket per
  parent, reused across pieces) driven by one selector thread, instead
  of urllib opening and tearing down a TCP connection per piece. Callers
  stay synchronous (they block on a per-job event), so the conductor's
  piece/retry/back-to-source semantics are untouched — only the I/O
  under them is multiplexed.
- ``uploader.UploadServer`` — the PARENT side builds its sendfile serve
  loop on the same :class:`EventLoop` primitive.

``DF_TRANSFER_LOOP=0`` disables the pool; the downloader then falls back
to per-request urllib exactly as before.
"""

# dfanalyze: hot — every piece transfer crosses this loop

from __future__ import annotations

import heapq
import os
import selectors
import socket
import threading
import time
from collections import deque

from dragonfly2_torch.utils import dflog

logger = dflog.get("client.transfer")

_RECV_CHUNK = 256 * 1024
_MAX_HEADER = 64 * 1024


class TransferError(Exception):
    """Transport-level fetch failure (connect/timeout/protocol)."""


class EventLoop:
    """Minimal selectors-based reactor: register(fileobj, mask, cb),
    timers, and thread-safe ``call_soon``. Handlers run on the single
    loop thread; they must never block."""

    def __init__(self, name: str):
        self.name = name
        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, self._drain_wake)
        self._pending: deque = deque()
        self._timers: list = []  # heap of (when, seq, callback)
        self._seq = 0
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None

    # -- control ------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"daemon.{self.name}", daemon=True
        )
        self._thread.start()

    def stop(self, on_stop=None) -> None:
        """Idempotent; ``on_stop`` (loop thread) runs before exit so
        owners can close their sockets on the thread that owns them."""
        if self._stopped.is_set():
            return
        if on_stop is not None:
            self.call_soon(on_stop)
        self._stopped.set()
        self.wake()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except (BlockingIOError, OSError):
            pass  # already pending / closing — either way the loop runs

    def _drain_wake(self, mask) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def call_soon(self, fn) -> None:
        with self._lock:
            self._pending.append(fn)
        self.wake()

    def call_at(self, when: float, fn) -> None:
        """Loop-thread only (timers are serviced between select rounds)."""
        self._seq += 1
        heapq.heappush(self._timers, (when, self._seq, fn))

    # -- selector facade (loop thread only) ---------------------------
    def register(self, fileobj, mask, cb) -> None:
        self._sel.register(fileobj, mask, cb)

    def modify(self, fileobj, mask, cb) -> None:
        self._sel.modify(fileobj, mask, cb)

    def unregister(self, fileobj) -> None:
        try:
            self._sel.unregister(fileobj)
        except (KeyError, ValueError):
            pass

    # -- core ---------------------------------------------------------
    def _run(self) -> None:
        while not self._stopped.is_set():
            now = time.monotonic()
            timeout = None
            while self._timers and self._timers[0][0] <= now:
                _, _, fn = heapq.heappop(self._timers)
                self._safe(fn)
            if self._timers:
                timeout = max(0.0, self._timers[0][0] - time.monotonic())
            while True:
                with self._lock:
                    if not self._pending:
                        break
                    fn = self._pending.popleft()
                self._safe(fn)
                timeout = 0.0  # a callback may have armed timers/events
            try:
                events = self._sel.select(timeout)
            except OSError:
                continue  # fd closed under us during stop
            for key, mask in events:
                self._safe(key.data, mask)
        # drain callbacks queued by stop() (owner teardown closes its
        # sockets HERE, on the thread that owns them) before the
        # selector goes away
        while True:
            with self._lock:
                if not self._pending:
                    break
                fn = self._pending.popleft()
            self._safe(fn)
        try:
            self._sel.close()
        except OSError:
            pass
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass

    def _safe(self, fn, *args) -> None:
        try:
            fn(*args)
        except Exception:
            logger.exception("transfer loop %s: handler failed", self.name)


# ---------------------------------------------------------------------------
# child-side fetch pool
# ---------------------------------------------------------------------------


class _Job:
    __slots__ = (
        "addr", "target", "deadline", "event", "status", "headers", "body",
        "error", "retried",
    )

    def __init__(self, addr: str, target: str, deadline: float):
        self.addr = addr
        self.target = target
        self.deadline = deadline
        self.event = threading.Event()
        self.status = 0
        self.headers: dict[str, str] = {}
        self.body = b""
        self.error: str | None = None
        self.retried = False

    def finish(self) -> None:
        self.event.set()

    def fail(self, msg: str) -> None:
        self.error = msg
        self.event.set()


class _PoolConn:
    """One pooled HTTP/1.1 connection to a parent's upload server."""

    __slots__ = ("sock", "addr", "job", "out", "buf", "body", "body_len",
                 "body_got", "connected", "fresh")

    def __init__(self, sock: socket.socket, addr: str):
        self.sock = sock
        self.addr = addr
        self.job: _Job | None = None
        self.out = b""
        self.buf = b""  # response header accumulation
        self.body: bytearray | None = None
        self.body_len = 0
        self.body_got = 0
        self.connected = False
        self.fresh = True  # first request on this socket

    def reset_for(self, job: _Job) -> None:
        self.job = job
        req = (
            f"GET {job.target} HTTP/1.1\r\n"
            f"Host: {self.addr}\r\n"
            "\r\n"
        )
        self.out = req.encode("ascii")
        self.buf = b""
        self.body = None
        self.body_len = 0
        self.body_got = 0


class TransferPool:
    """Bounded keep-alive connection pool for piece fetches. Thread-safe
    ``fetch`` from any thread; all socket work happens on the loop."""

    def __init__(
        self,
        loop: EventLoop | None = None,
        max_connections: int = 0,
        connect_timeout: float = 5.0,
    ):
        self.loop = loop or EventLoop("transfer")
        self._own_loop = loop is None
        self.max_connections = max_connections or int(
            os.environ.get("DF_TRANSFER_POOL", "64")
        )
        self.connect_timeout = connect_timeout
        # loop-thread state
        self._idle: dict[str, list[_PoolConn]] = {}
        self._active: set[_PoolConn] = set()
        self._queue: deque[_Job] = deque()
        self._watchdog_armed = False
        self._started = False
        self._start_lock = threading.Lock()

    # -- public -------------------------------------------------------
    def fetch(
        self, addr: str, target: str, timeout: float = 30.0
    ) -> tuple[int, dict[str, str], bytes]:
        """Blocking GET ``http://addr``+``target`` → (status, lowercase
        headers, body). Raises :class:`TransferError` on wire failure."""
        self._ensure_started()
        job = _Job(addr, target, time.monotonic() + timeout)
        self.loop.call_soon(lambda: self._admit(job))
        if not job.event.wait(timeout + 5.0):
            job.error = job.error or f"fetch {addr}{target}: pool watchdog timeout"
        if job.error is not None:
            raise TransferError(job.error)
        return job.status, job.headers, job.body

    def release_idle(self, addrs) -> None:
        """Drop idle keep-alive connections to ``addrs`` — called when a
        task finishes so a 10k-parent swarm doesn't pin fds forever."""
        if not self._started:
            return
        addrs = set(addrs)

        def _drop():
            for addr in addrs:
                for conn in self._idle.pop(addr, []):
                    self._close_conn(conn)

        self.loop.call_soon(_drop)

    def stop(self) -> None:
        if self._own_loop:
            self.loop.stop(on_stop=self._close_all)

    def _close_all(self) -> None:
        for conns in self._idle.values():
            for conn in conns:
                self._close_conn(conn)
        self._idle.clear()
        for conn in list(self._active):
            if conn.job is not None:
                conn.job.fail("transfer pool stopped")
            self._close_conn(conn)

    # -- loop-thread internals ---------------------------------------
    def _ensure_started(self) -> None:
        if self._started:
            return
        with self._start_lock:
            if not self._started:
                self.loop.start()
                self._started = True

    def _admit(self, job: _Job) -> None:
        self._queue.append(job)
        if not self._watchdog_armed:
            self._watchdog_armed = True
            self.loop.call_at(time.monotonic() + 0.5, self._watchdog)
        self._dispatch()

    def _watchdog(self) -> None:
        """Expire jobs (queued or in flight) past their deadline."""
        now = time.monotonic()
        for job in [j for j in self._queue if j.deadline <= now]:
            self._queue.remove(job)
            job.fail(f"fetch {job.addr}{job.target}: timed out in queue")
        for conn in [c for c in self._active if c.job and c.job.deadline <= now]:
            job = conn.job
            self._abort_conn(conn, f"fetch {job.addr}{job.target}: timed out")
        if self._queue or self._active:
            self.loop.call_at(now + 0.5, self._watchdog)
        else:
            self._watchdog_armed = False

    def _dispatch(self) -> None:
        while self._queue:
            job = self._queue[0]
            idle = self._idle.get(job.addr)
            if idle:
                conn = idle.pop()
                if not idle:
                    del self._idle[job.addr]
                self._queue.popleft()
                self._attach(conn, job)
                continue
            if len(self._active) + sum(len(v) for v in self._idle.values()) \
                    >= self.max_connections:
                # at the bound: evict an idle conn to any OTHER addr
                victim_addr = next(iter(self._idle), None)
                if victim_addr is None:
                    return  # every socket busy — wait for a completion
                conn = self._idle[victim_addr].pop()
                if not self._idle[victim_addr]:
                    del self._idle[victim_addr]
                self._close_conn(conn)
                continue
            self._queue.popleft()
            self._connect(job)

    def _connect(self, job: _Job) -> None:
        try:
            host, port = job.addr.rsplit(":", 1)
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                sock.connect((host, int(port)))
            except BlockingIOError:
                pass
        except OSError as e:
            job.fail(f"connect {job.addr}: {e}")
            return
        conn = _PoolConn(sock, job.addr)
        conn.reset_for(job)
        self._active.add(conn)
        self.loop.register(
            sock, selectors.EVENT_WRITE, lambda mask, c=conn: self._on_event(c, mask)
        )
        self.loop.call_at(
            time.monotonic() + self.connect_timeout,
            lambda c=conn: self._connect_deadline(c),
        )

    def _connect_deadline(self, conn: _PoolConn) -> None:
        if conn in self._active and not conn.connected:
            self._abort_conn(conn, f"connect {conn.addr}: timed out")

    def _attach(self, conn: _PoolConn, job: _Job) -> None:
        conn.fresh = False
        conn.connected = True
        conn.reset_for(job)
        self._active.add(conn)
        self.loop.register(
            conn.sock, selectors.EVENT_WRITE,
            lambda mask, c=conn: self._on_event(c, mask),
        )

    def _close_conn(self, conn: _PoolConn) -> None:
        self.loop.unregister(conn.sock)
        self._active.discard(conn)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _abort_conn(self, conn: _PoolConn, msg: str) -> None:
        job = conn.job
        conn.job = None
        self._close_conn(conn)
        if job is not None:
            job.fail(msg)
        self._dispatch()

    def _on_event(self, conn: _PoolConn, mask: int) -> None:
        if conn not in self._active:
            return
        job = conn.job
        try:
            if conn.out:
                if not conn.connected:
                    err = conn.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
                    if err:
                        raise OSError(err, os.strerror(err))
                    conn.connected = True
                sent = conn.sock.send(conn.out)
                conn.out = conn.out[sent:]
                if not conn.out:
                    self.loop.modify(
                        conn.sock, selectors.EVENT_READ,
                        lambda m, c=conn: self._on_event(c, m),
                    )
                return
            self._on_readable(conn)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as e:
            self._wire_failure(conn, f"{job.addr if job else conn.addr}: {e}")

    def _on_readable(self, conn: _PoolConn) -> None:
        job = conn.job
        if conn.body is not None:
            view = memoryview(conn.body)[conn.body_got:]
            n = conn.sock.recv_into(view, len(view))
            if n == 0:
                self._wire_failure(conn, f"{conn.addr}: connection closed mid-body")
                return
            conn.body_got += n
            if conn.body_got >= conn.body_len:
                self._complete(conn)
            return
        data = conn.sock.recv(_RECV_CHUNK)
        if not data:
            self._wire_failure(conn, f"{conn.addr}: connection closed")
            return
        conn.buf += data
        head_end = conn.buf.find(b"\r\n\r\n")
        if head_end < 0:
            # one recv can deliver headers AND a body chunk — only an
            # actually-unterminated header block is oversized
            if len(conn.buf) > _MAX_HEADER:
                self._abort_conn(conn, f"{conn.addr}: response headers too large")
            return
        head, rest = conn.buf[:head_end], conn.buf[head_end + 4:]
        lines = head.split(b"\r\n")
        try:
            parts = lines[0].split(None, 2)
            status = int(parts[1])
        except (IndexError, ValueError):
            self._abort_conn(conn, f"{conn.addr}: malformed status line")
            return
        headers: dict[str, str] = {}
        for line in lines[1:]:
            k, _, v = line.partition(b":")
            headers[k.strip().decode("latin1").lower()] = v.strip().decode("latin1")
        if job is None:
            self._close_conn(conn)
            return
        job.status = status
        job.headers = headers
        try:
            body_len = int(headers.get("content-length", "0") or "0")
        except ValueError:
            self._abort_conn(conn, f"{conn.addr}: bad content-length")
            return
        conn.body = bytearray(body_len)
        conn.body_len = body_len
        if rest:
            take = min(len(rest), body_len)
            conn.body[:take] = rest[:take]
            conn.body_got = take
        if conn.body_got >= conn.body_len:
            self._complete(conn)

    def _complete(self, conn: _PoolConn) -> None:
        job = conn.job
        keep = job.headers.get("connection", "").lower() != "close"
        conn.job = None
        job.body = bytes(conn.body)
        conn.body = None
        self.loop.unregister(conn.sock)
        self._active.discard(conn)
        if keep:
            self._idle.setdefault(conn.addr, []).append(conn)
        else:
            try:
                conn.sock.close()
            except OSError:
                pass
        job.finish()
        self._dispatch()

    def _wire_failure(self, conn: _PoolConn, msg: str) -> None:
        """A reused keep-alive socket can die between requests (the
        parent closed it while idle — the classic stale-connection
        race). If nothing of the response arrived yet, retry ONCE on a
        fresh connection before surfacing the error."""
        job = conn.job
        stale = (
            job is not None
            and not conn.fresh
            and not job.retried
            and conn.buf == b""
            and conn.body is None
        )
        conn.job = None
        self._close_conn(conn)
        if job is None:
            return
        if stale:
            job.retried = True
            self._queue.appendleft(job)
            self._dispatch()
            return
        job.fail(msg)
        self._dispatch()


# ---------------------------------------------------------------------------
# process-wide default pool
# ---------------------------------------------------------------------------

_default_pool: TransferPool | None = None
_default_lock = threading.Lock()


def enabled() -> bool:
    return os.environ.get("DF_TRANSFER_LOOP", "1") != "0"


def default_pool() -> TransferPool | None:
    """The process-wide pool (None when DF_TRANSFER_LOOP=0)."""
    if not enabled():
        return None
    global _default_pool
    if _default_pool is None:
        with _default_lock:
            if _default_pool is None:
                _default_pool = TransferPool()
    return _default_pool
