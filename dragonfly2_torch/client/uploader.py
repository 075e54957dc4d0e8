"""HTTP upload server — the parent side of piece transfer.

Counterpart of the reference's ``client/uploader.py``.

Role parity: upstream client/daemon/upload/upload_manager.go:59-196 —
``GET /download/<task_id>?peerId=&number=`` serves piece bytes out of the
local piece store, with Range support for arbitrary byte windows. Piece
bytes ride HTTP between daemons (the gRPC plane carries only piece
*metadata*), exactly like the upstream (upload_manager.go:149-196).

Zero-copy data plane (docs/data-plane.md): one readiness-based selector
loop holds every child connection — no thread per transfer — and piece
bodies go ``os.sendfile`` straight from the task's sparse data file at
the piece's span, never materializing through Python ``bytes``. The
upload rate limiter still applies: the body is windowed through the
shared token bucket in ``WINDOW``-sized sendfile calls, so concurrent
children split the budget exactly as before. The synthetic ``delay_s``/
``cold_piece_delay_s`` knobs become loop timers (a delayed response
parks its connection; nothing sleeps). ``use_sendfile=False`` (or
``DF_UPLOAD_SENDFILE=0``) selects the buffered fallback — same loop,
bodies copied through userspace — which bench races against the
zero-copy path.
"""

# dfanalyze: hot — the serve loop runs per child request at swarm scale

from __future__ import annotations

import os
import re
import selectors
import socket
import time
from urllib.parse import parse_qs, urlparse

from dragonfly2_torch.client import metrics as M
from dragonfly2_torch.client.piece_manager import RateLimiter
from dragonfly2_torch.client.storage import StorageError, StorageManager
from dragonfly2_torch.client.transfer import EventLoop
from dragonfly2_torch.utils import dflog, flight, flows, profiling

logger = dflog.get("client.upload")

_RANGE_RE = re.compile(r"bytes=(\d+)-(\d*)")

# dfprof phases: wall per served piece response (parse → last body byte)
# and the slice of it spent inside the kernel send path
PH_PIECE_SERVE = profiling.phase_type("daemon.piece_serve")
PH_PIECE_SENDFILE = profiling.phase_type("daemon.piece_sendfile")

# flight event: a child dropping mid-body — normal churn at swarm scale,
# but the postmortem ring should know who vanished and when
EV_CHILD_DISCONNECT = flight.event_type("daemon.child_disconnect")

WINDOW = 256 * 1024  # body bytes per sendfile window (unlimited path)
RATE_WINDOW = 64 * 1024  # window under a rate cap (token granularity)
_MAX_REQUEST = 32 * 1024


class _Conn:
    """One child connection's state machine: parse request → (optional
    deferred start) → stream response spans → next request (keep-alive)."""

    __slots__ = (
        "sock", "peer", "buf", "head", "spans", "span_file", "span_off",
        "span_left", "body_done", "close_after", "serving_piece",
        "serve_t0", "flow_plane", "writing", "zero_left", "pending",
    )

    def __init__(self, sock: socket.socket, peer):
        self.sock = sock
        self.peer = peer
        self.buf = b""
        self.head = b""  # pending response header bytes
        # body plan: list of (path|None, offset, length) spans, consumed
        # front to back; path None = synthesized zeros (sparse hole)
        self.spans: list = []
        self.span_file = None  # open fd for the span being sent
        self.span_off = 0
        self.span_left = 0
        self.zero_left = 0
        self.body_done = True
        self.close_after = False
        self.serving_piece = False  # counts toward piece metrics/phases
        self.serve_t0 = 0.0
        self.flow_plane = "file"  # demanded plane of the piece's task
        self.writing = False
        # a response parked on a delay timer: requests pipelined behind
        # it must wait (HTTP/1.1 ordering), and the timer must find the
        # connection in the state it left it
        self.pending = False

    def close_file(self) -> None:
        if self.span_file is not None:
            try:
                os.close(self.span_file)
            except OSError:
                pass
            self.span_file = None


class UploadServer:
    """Serves pieces to child peers from one readiness-based loop."""

    def __init__(
        self,
        storage: StorageManager,
        host: str = "127.0.0.1",
        port: int = 0,
        delay_s: float = 0.0,
        cold_piece_delay_s: float = 0.0,
        rate_limit_bps: float = 0.0,
        use_sendfile: bool | None = None,
    ):
        self.storage = storage
        # synthetic per-piece serving latency — benchmarking/AB-harness
        # knob to model slow hosts; 0 in production
        self.delay_s = delay_s
        # extra latency on piece 0 only — models the benign cold-piece
        # effect (TCP slow start / cold cache on a task's first chunk)
        # the GRU bad-node A/B scenario relies on; 0 in production
        self.cold_piece_delay_s = cold_piece_delay_s
        # global upload bandwidth budget shared by all child peers
        # (upstream upload_manager totalRateLimit); 0 = unlimited
        self.limiter = RateLimiter(rate_limit_bps)
        # DF_UPLOAD_SENDFILE=0 is a kill switch (it can only disable),
        # and platform availability always gates — an explicit
        # config True must not force sendfile onto an os without it
        self.use_sendfile = (
            (True if use_sendfile is None else bool(use_sendfile))
            and hasattr(os, "sendfile")
            and os.environ.get("DF_UPLOAD_SENDFILE", "1") != "0"
        )
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(1024)
        self._lsock.setblocking(False)
        self.host = self._lsock.getsockname()[0]
        self.port = self._lsock.getsockname()[1]
        self.loop = EventLoop(f"upload-{self.port}")
        self._conns: set[_Conn] = set()
        self._started = False
        self._stopped = False

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self.loop.call_soon(
            lambda: self.loop.register(
                self._lsock, selectors.EVENT_READ, self._accept
            )
        )
        self.loop.start()

    def stop(self) -> None:
        if self._stopped or not self._started:
            # never started: still close the listener so the port frees
            if not self._started and not self._stopped:
                self._stopped = True
                try:
                    self._lsock.close()
                except OSError:
                    pass
            return
        self._stopped = True
        self.loop.stop(on_stop=self._teardown)

    def _teardown(self) -> None:
        self.loop.unregister(self._lsock)
        try:
            self._lsock.close()
        except OSError:
            pass
        for conn in list(self._conns):
            self._drop(conn)

    # ------------------------------------------------------------------
    # loop handlers
    # ------------------------------------------------------------------
    def _accept(self, mask) -> None:
        while True:
            try:
                sock, peer = self._lsock.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock, peer)
            self._conns.add(conn)
            M.UPLOAD_CONNECTIONS.inc()
            self.loop.register(
                sock, selectors.EVENT_READ, lambda m, c=conn: self._on_event(c, m)
            )

    def _drop(self, conn: _Conn, mid_body: bool = False) -> None:
        if conn not in self._conns:
            return
        self._conns.discard(conn)
        M.UPLOAD_CONNECTIONS.dec()
        if mid_body:
            M.CHILD_DISCONNECT_TOTAL.inc()
            EV_CHILD_DISCONNECT(
                peer=f"{conn.peer[0]}:{conn.peer[1]}" if conn.peer else "?",
                bytes_left=conn.span_left + conn.zero_left
                + sum(s[2] for s in conn.spans),
            )
            logger.debug("child %s disconnected mid-body", conn.peer)
        conn.close_file()
        self.loop.unregister(conn.sock)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _on_event(self, conn: _Conn, mask) -> None:
        try:
            if mask & selectors.EVENT_WRITE:
                self._send_some(conn)
            if mask & selectors.EVENT_READ:
                self._read_request(conn)
        except (BrokenPipeError, ConnectionResetError):
            # a child dropping mid-transfer is swarm churn, not an error:
            # count it, log at debug, never traceback
            self._drop(conn, mid_body=not conn.body_done)
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as e:
            self._drop(conn, mid_body=not conn.body_done)
            logger.debug("child %s connection error: %s", conn.peer, e)

    def _read_request(self, conn: _Conn) -> None:
        data = conn.sock.recv(_MAX_REQUEST)
        if not data:
            self._drop(conn, mid_body=not conn.body_done)
            return
        conn.buf += data
        if len(conn.buf) > _MAX_REQUEST:
            self._drop(conn)
            return
        if not conn.body_done or conn.head or conn.pending:
            return  # request pipelined ahead of our response; parse later
        self._maybe_parse(conn)

    def _maybe_parse(self, conn: _Conn) -> None:
        end = conn.buf.find(b"\r\n\r\n")
        if end < 0:
            return
        head, conn.buf = conn.buf[:end], conn.buf[end + 4:]
        lines = head.split(b"\r\n")
        try:
            method, target, _ = lines[0].decode("latin1").split(" ", 2)
        except ValueError:
            self._drop(conn)
            return
        headers = {}
        for line in lines[1:]:
            k, _, v = line.partition(b":")
            headers[k.strip().decode("latin1").lower()] = v.strip().decode("latin1")
        conn.close_after = headers.get("connection", "").lower() == "close"
        if method != "GET":
            self._error(conn, 405, "method not allowed", close=True)
            return
        delay = self.delay_s
        piece_q = None
        parsed = urlparse(target)
        parts = parsed.path.strip("/").split("/")
        if len(parts) == 2 and parts[0] == "download":
            piece_q = parse_qs(parsed.query).get("number", [None])[0]
            if self.cold_piece_delay_s > 0 and piece_q == "0":
                delay += self.cold_piece_delay_s
        if delay > 0:
            # the synthetic-latency knobs park the connection on a loop
            # timer — no thread sleeps, so 1000 delayed children cost
            # 1000 timer entries, not 1000 blocked threads
            conn.pending = True
            self.loop.call_at(
                time.monotonic() + delay,
                lambda: self._respond_safe(conn, parsed, headers),
            )
            return
        self._respond(conn, parsed, headers)

    def _respond_safe(self, conn: _Conn, parsed, headers) -> None:
        if conn not in self._conns:
            return  # child gave up during the synthetic delay
        conn.pending = False
        try:
            self._respond(conn, parsed, headers)
        except (BlockingIOError, InterruptedError):
            pass  # EVENT_WRITE is armed; the loop resumes the send
        except (BrokenPipeError, ConnectionResetError, OSError):
            self._drop(conn, mid_body=not conn.body_done)

    # ------------------------------------------------------------------
    # request → response plan
    # ------------------------------------------------------------------
    def _respond(self, conn: _Conn, parsed, req_headers: dict) -> None:
        parts = parsed.path.strip("/").split("/")
        if len(parts) != 2 or parts[0] != "download":
            self._error(conn, 404, "unknown path")
            return
        task_id = parts[1]
        qs = parse_qs(parsed.query)
        ts = self.storage.load(task_id)
        if ts is None:
            self._error(conn, 404, f"task {task_id} not found")
            return

        number = qs.get("number", [None])[0]
        if number is not None:
            # piece fetch by number — parsed ONCE, with the malformed
            # case answered 404 like every other bad-request path
            try:
                piece_number = int(number)
            except ValueError:
                self._error(conn, 404, f"bad piece number {number!r}")
                return
            try:
                path, off, length, digest = ts.piece_span(piece_number)
            except StorageError as e:
                self._error(conn, 404, str(e))
                return
            extra = [("X-Dragonfly-Piece-Digest", digest)]
            # origin response metadata travels with the pieces so every
            # peer in the swarm can replay it (transport Content-Type)
            ct = ts.meta.headers.get("Content-Type", "")
            if ct:
                extra.append(("X-Dragonfly-Origin-Content-Type", ct))
            conn.serving_piece = True
            conn.serve_t0 = time.perf_counter()
            conn.flow_plane = flows.task_plane(task_id)
            self._start_response(
                conn, 200, [(path, off, length)], length, extra
            )
            return

        rng = req_headers.get("range")
        if rng:
            m = _RANGE_RE.match(rng)
            if not m:
                self._error(conn, 416, "bad range")
                return
            start = int(m.group(1))
            total = ts.meta.content_length
            if m.group(2):
                end = int(m.group(2))
            elif total >= 0:
                end = total - 1
            else:
                # open-ended range on a task whose length is still
                # unknown: serve to the current end-of-data instead of
                # refusing a valid request
                end = ts.current_end() - 1
            if end < start:
                self._error(conn, 416, "bad range")
                return
            try:
                spans = ts.range_spans(start, end - start + 1)
            except StorageError as e:
                # a dedup ref whose physical holder vanished mid-plan:
                # an answered 404 beats a silently hung child
                self._error(conn, 404, str(e))
                return
            n = sum(s[2] for s in spans)
            self._start_response(
                conn, 206, spans, n,
                [("Content-Range", f"bytes {start}-{start + n - 1}/{total}")],
            )
            return

        # whole object (requires completion) — streamed span by span in
        # WINDOW chunks, never materialized via read_all()
        with ts.lock:
            done = ts.meta.done
            size = ts.meta.content_length
        if not done:
            self._error(conn, 409, f"task {ts.meta.task_id} is not complete")
            return
        if size < 0:
            size = ts.current_end()
        try:
            spans = ts.range_spans(0, size)
        except StorageError as e:
            self._error(conn, 404, str(e))
            return
        got = sum(s[2] for s in spans)
        if got < size:
            spans.append((None, 0, size - got))  # trailing sparse hole
        self._start_response(conn, 200, spans, size, [])

    def _error(self, conn: _Conn, code: int, msg: str, close: bool = False) -> None:
        # bad-request answers stay keep-alive (a child probing for a
        # piece its in-progress parent hasn't written yet 404s MANY
        # times — reconnect churn per probe would swamp the swarm);
        # protocol-level errors still close
        body = f"{code}: {msg}\n".encode()
        reason = {404: "Not Found", 405: "Method Not Allowed",
                  409: "Conflict", 416: "Range Not Satisfiable"}.get(code, "Error")
        conn.close_after = conn.close_after or close
        conn.head = (
            f"HTTP/1.1 {code} {reason}\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Content-Type: text/plain\r\n"
            + ("Connection: close\r\n" if conn.close_after else "")
            + "\r\n"
        ).encode() + body
        conn.body_done = True
        conn.spans = []
        self._arm_write(conn)

    def _start_response(
        self, conn: _Conn, code: int, spans: list, content_length: int, extra
    ) -> None:
        reason = {200: "OK", 206: "Partial Content"}[code]
        lines = [f"HTTP/1.1 {code} {reason}", f"Content-Length: {content_length}"]
        for k, v in extra:
            lines.append(f"{k}: {v}")
        if conn.close_after:
            lines.append("Connection: close")
        conn.head = ("\r\n".join(lines) + "\r\n\r\n").encode()
        conn.spans = [s for s in spans if s[2] > 0]
        conn.body_done = not conn.spans
        self._arm_write(conn)

    # ------------------------------------------------------------------
    # response pump
    # ------------------------------------------------------------------
    def _arm_write(self, conn: _Conn) -> None:
        if not conn.writing:
            conn.writing = True
            self.loop.modify(
                conn.sock,
                selectors.EVENT_READ | selectors.EVENT_WRITE,
                lambda m, c=conn: self._on_event(c, m),
            )
        self._send_some(conn)

    def _disarm_write(self, conn: _Conn) -> None:
        if conn.writing:
            conn.writing = False
            self.loop.modify(
                conn.sock, selectors.EVENT_READ,
                lambda m, c=conn: self._on_event(c, m),
            )

    def _park(self, conn: _Conn, wait_s: float) -> None:
        """Rate-limit stall: stop watching EVENT_WRITE and resume on a
        timer — the loop stays free for every other child."""
        self._disarm_write(conn)
        self.loop.call_at(
            time.monotonic() + wait_s, lambda: self._resume(conn)
        )

    def _resume(self, conn: _Conn) -> None:
        if conn in self._conns and not conn.body_done:
            try:
                self._arm_write(conn)
            except (BrokenPipeError, ConnectionResetError, OSError):
                self._drop(conn, mid_body=True)

    def _send_some(self, conn: _Conn) -> None:
        # 1) response headers
        while conn.head:
            sent = conn.sock.send(conn.head)
            conn.head = conn.head[sent:]
            if conn.head:
                return  # socket full — EVENT_WRITE re-fires
        # 2) body spans
        while not conn.body_done:
            if conn.span_left == 0 and conn.zero_left == 0:
                conn.close_file()
                if not conn.spans:
                    self._finish_response(conn)
                    return
                path, off, length = conn.spans.pop(0)
                if path is None:
                    conn.zero_left = length
                else:
                    try:
                        conn.span_file = os.open(path, os.O_RDONLY)
                    except OSError as e:
                        # span vanished mid-plan (task GC'd): the header
                        # promised Content-Length, so the only honest
                        # move is to cut the connection
                        logger.warning("serve span %s failed: %s", path, e)
                        self._drop(conn, mid_body=True)
                        return
                    conn.span_off = off
                    conn.span_left = length
            window = min(
                WINDOW, conn.span_left if conn.span_left else conn.zero_left
            )
            if self.limiter.rate > 0:
                # finer windows under a rate cap: the debt-based bucket
                # admits one oversized window whole, which would let a
                # single child burst far past its share
                window = min(window, RATE_WINDOW)
                wait = self.limiter.acquire_nowait(window)
                if wait > 0:
                    self._park(conn, wait)
                    return
            try:
                sent = self._send_window(conn, window)
            except BlockingIOError:
                if self.limiter.rate > 0:
                    # socket full after tokens were debited: refund what
                    # we couldn't send so the budget stays honest
                    self.limiter.refund(window)
                return
            if self.limiter.rate > 0 and sent < window:
                self.limiter.refund(window - sent)
            if sent == 0:
                return
        self._finish_response(conn)

    def _send_window(self, conn: _Conn, window: int) -> int:
        """Send up to ``window`` body bytes; returns bytes sent. Raises
        BlockingIOError when the socket can't take any."""
        if conn.zero_left:
            n = conn.sock.send(b"\0" * min(window, conn.zero_left))
            conn.zero_left -= n
            if conn.zero_left == 0 and not conn.spans and conn.span_left == 0:
                conn.body_done = True
            return n
        t0 = time.perf_counter()
        if self.use_sendfile:
            n = os.sendfile(
                conn.sock.fileno(), conn.span_file, conn.span_off, window
            )
        else:
            # buffered fallback: same loop, bytes copied through
            # userspace — what the bench races the zero-copy path against
            data = os.pread(conn.span_file, window, conn.span_off)
            n = conn.sock.send(data)
        if conn.serving_piece:
            PH_PIECE_SENDFILE.observe(time.perf_counter() - t0)
        if n == 0 and window > 0:
            raise BrokenPipeError("sendfile returned 0")
        conn.span_off += n
        conn.span_left -= n
        if conn.serving_piece:
            M.PIECE_UPLOAD_BYTES.inc(n)
            flows.upload(conn.flow_plane, n)
        if conn.span_left == 0 and not conn.spans and conn.zero_left == 0:
            conn.body_done = True
        return n

    def _finish_response(self, conn: _Conn) -> None:
        conn.body_done = True
        conn.close_file()
        if conn.serving_piece:
            M.PIECE_UPLOADED_TOTAL.inc()
            PH_PIECE_SERVE.observe(time.perf_counter() - conn.serve_t0)
            conn.serving_piece = False
        if conn.close_after:
            self._drop(conn)
            return
        self._disarm_write(conn)
        # keep-alive: a pipelined next request may already be buffered —
        # scheduled, not recursed, so a deep pipeline can't stack-dive
        if conn.buf:
            self.loop.call_soon(lambda: self._pipeline_next(conn))

    def _pipeline_next(self, conn: _Conn) -> None:
        if (
            conn in self._conns
            and conn.body_done
            and not conn.head
            and not conn.pending
        ):
            try:
                self._maybe_parse(conn)
            except (BlockingIOError, InterruptedError):
                pass
            except (BrokenPipeError, ConnectionResetError, OSError):
                self._drop(conn, mid_body=not conn.body_done)
