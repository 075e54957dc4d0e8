"""HTTP proxy with P2P redirection — registry/artifact acceleration
(counterpart of the reference's ``client/proxy.py``).

Role parity: reference client/daemon/proxy/proxy.go:268-766 — an HTTP
proxy in front of container registries / artifact stores: plain-HTTP
requests matching the configured rules are converted into peer tasks
(P2P swarm with back-to-source), everything else passes through;
``CONNECT`` is either tunneled raw or — with an issuer configured —
TLS-intercepted with per-host spoofed certificates signed by the local
CA (reference proxy.go cert spoofing), so HTTPS registry traffic rides
P2P too. A registry mirror rewrites
request URLs onto the mirror remote before routing, which is how blob
and layer GETs become shared P2P downloads.
"""

from __future__ import annotations

import dataclasses
import re
import select
import socket
import ssl
import tempfile
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlsplit, urlunsplit

from dragonfly2_torch.client.transport import P2PTransport, ProxyRule
from dragonfly2_torch.client import metrics as M
from dragonfly2_torch.utils import dflog, faults, flight, flows, profiling, tracing

logger = dflog.get("client.proxy")

# registry layer fetch observed through the proxy — the preheat demand
# window consumes these as per-layer-digest demand signal
EV_LAYER_DEMAND = flight.event_type("daemon.layer_demand")

# provenance anomaly: a P2P-capable pull that skipped the swarm — the
# event carries the swallowed cause so dfdoctor incidents can name WHY
# a layer went to the origin (satellite: no more silent fallbacks)
EV_PROXY_FALLBACK = flight.event_type("daemon.proxy_fallback")

# dfprof phase: one registry-proxy pull end to end (route + transfer)
PH_PROXY_PULL = profiling.phase_type("daemon.proxy_pull")

# fault point: the proxy pull path — chaos schedules model a wedged
# proxy front here (deterministic 502, never a hang)
FP_PROXY_PULL = faults.point("daemon.proxy_pull")

# `/v2/<name>/blobs/<digest>` — the layer-blob GET shape every OCI
# registry dialect shares
_BLOB_PATH_RX = re.compile(r"/v2/[^?#]+/blobs/([a-z0-9]+:[a-f0-9]+)")

_HOP_HEADERS = {
    # accept-encoding is stripped so origins reply identity-encoded — the
    # proxy streams bodies as-is and must not re-label compressed bytes
    "accept-encoding",
    "connection",
    "proxy-connection",
    "keep-alive",
    "te",
    "trailers",
    "transfer-encoding",
    "upgrade",
    "host",
}


def _read_chunked_body(rfile, max_bytes: int = 1 << 30) -> bytes:
    """Decode an RFC 7230 chunked request body from ``rfile``; consuming
    it fully also keeps the keep-alive connection in sync."""
    out = []
    total = 0
    while True:
        size_line = rfile.readline(1024).strip()
        size = int(size_line.split(b";", 1)[0], 16)  # chunk-ext ignored
        if size == 0:
            # trailer section (if any) ends at the blank line
            while rfile.readline(1024).strip():
                pass
            break
        total += size
        if total > max_bytes:
            raise ValueError("chunked body exceeds the forwarding cap")
        chunk = rfile.read(size)
        if len(chunk) != size:
            raise ValueError("truncated chunk in request body")
        rfile.read(2)  # trailing CRLF
        out.append(chunk)
    return b"".join(out)


@dataclass
class RegistryMirror:
    """Resolves mirror-relative request paths onto a mirror remote
    (reference proxy config registryMirror.url). Scope matches the
    reference (client/daemon/proxy/proxy.go): the mirror serves requests
    addressed *to the proxy as a host* (non-absolute URIs, the container
    engine's registry-mirror mode); absolute-URI proxy requests are routed
    by rules, never silently redirected onto the mirror."""

    remote: str = ""  # e.g. "https://mirror.example.com"

    def resolve(self, path: str) -> str:
        remote = urlsplit(self.remote)
        parts = urlsplit(path)
        # keep the mirror remote's own path prefix (e.g. /registry)
        full = remote.path.rstrip("/") + parts.path
        return urlunsplit(
            (remote.scheme, remote.netloc, full, parts.query, parts.fragment)
        )


class ProxyServer:
    """Threaded HTTP proxy; GETs matching the transport's rules ride P2P."""

    def __init__(
        self,
        transport: P2PTransport,
        mirror: RegistryMirror | None = None,
        address: str = "127.0.0.1",
        port: int = 0,
        issuer=None,  # utils.issuer.SpoofingIssuer → enables HTTPS MITM
        intercept: list[str] | None = None,  # host regexes; None = all hosts
        plane: str = "image",
    ):
        self.transport = transport
        # the proxy IS the registry plane front: stamp its transport so
        # piece-level flow attribution and the proxy's own request-level
        # accounting agree on the plane
        self.plane = plane
        transport.plane = plane
        self.mirror = mirror or RegistryMirror()
        self.issuer = issuer
        self.intercept = [re.compile(rx) for rx in intercept] if intercept else None
        # optional callable(digest, url, task_id="", meta=None) fired per
        # layer-blob GET served WITHOUT riding P2P — the scheduler's
        # preheat demand window subscribes here so direct-served layer
        # pulls still count as demand (P2P-served pulls fold through the
        # scheduler's own DownloadRecord sink; emitting here too would
        # double-count them)
        self.on_layer_demand = None
        self._ssl_ctx_cache: dict[str, ssl.SSLContext] = {}
        self._ssl_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route into our logger
                logger.debug("proxy: " + fmt, *args)

            def do_GET(self):
                outer._handle_get(self)

            def do_HEAD(self):
                outer._handle_get(self, head=True)

            def do_CONNECT(self):
                outer._handle_connect(self)

        self._server = ThreadingHTTPServer((address, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="proxy", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # ------------------------------------------------------------------
    def _handle_get(self, handler: BaseHTTPRequestHandler, head: bool = False) -> None:
        url = handler.path
        if not url.startswith(("http://", "https://")):
            # non-absolute URI: treat as mirror-relative (registry mirror
            # mode fronting one remote)
            if not self.mirror.remote:
                handler.send_error(400, "absolute URI required")
                return
            url = self.mirror.resolve(url)

        headers = {
            k: v for k, v in handler.headers.items() if k.lower() not in _HOP_HEADERS
        }
        try:
            FP_PROXY_PULL()
        except faults.InjectedFault as e:
            handler.send_error(502, f"proxy pull fault: {e}")
            return
        # continue the caller's trace through the proxy hop; the span's
        # own context rides the outbound headers, so a direct origin
        # fetch carries it upstream (trace-context propagation)
        parent_ctx = tracing.parse_traceparent(
            handler.headers.get(tracing.TRACEPARENT_HEADER)
        )
        t0 = time.monotonic()
        with tracing.get("daemon").span(
            "daemon.proxy_pull", parent=parent_ctx, url=url, head=head
        ) as sp, PH_PROXY_PULL:
            headers[tracing.TRACEPARENT_HEADER] = tracing.format_traceparent(sp)
            try:
                result = self.transport.round_trip(url, headers, head=head)
            except Exception as e:
                handler.send_error(502, f"upstream fetch failed: {e}")
                return
            if result.fallback_cause:
                # the P2P leg failed and the transport degraded to a
                # direct fetch — name the cause instead of swallowing it
                ctx = self.transport.p2p_task_context(url)
                logger.warning(
                    "proxy pull %s skipped the swarm: %s", url, result.fallback_cause
                )
                EV_PROXY_FALLBACK(
                    url=url,
                    cause=result.fallback_cause,
                    task_id=ctx[0] if ctx is not None else "",
                )
            handler.send_response(result.status)
            # forward upstream headers (Content-Type matters to registry
            # clients); hop-by-hop and length/encoding are re-derived here
            for k, v in result.headers.items():
                if k.lower() not in _HOP_HEADERS and k.lower() != "content-length":
                    handler.send_header(k, v)
            if result.content_length >= 0:
                handler.send_header("Content-Length", str(result.content_length))
            else:
                # unknown length: fall back to buffering this response
                body = result.read_all()
                result = dataclasses.replace(
                    result, body=iter([body]), content_length=len(body)
                )
                handler.send_header("Content-Length", str(len(body)))
            M.PROXY_REQUEST_TOTAL.labels("p2p" if result.via_p2p else "direct").inc()
            self._note_layer_demand(url, result, head=head)
            handler.send_header("X-Dragonfly-Via-P2P", "1" if result.via_p2p else "0")
            if result.task_id:
                handler.send_header("X-Dragonfly-Task-Id", result.task_id)
            handler.end_headers()
            served = 0
            if not head:
                # stream chunk-by-chunk — a multi-GB layer must not be
                # buffered whole per request
                for chunk in result.body:
                    handler.wfile.write(chunk)
                    served += len(chunk)
            # flow ledger: a P2P ride's bytes were already attributed at
            # the piece write (origin/parent/dedup); the request-level
            # cases — completed-task local reuse and direct origin
            # responses — are acquired here, where the bytes move
            if result.via_p2p and not result.local_cache:
                provenance = "parent"
            elif result.local_cache:
                provenance = "local_cache"
            else:
                provenance = "origin"
            if served:
                flows.serve(self.plane, served)
                if provenance != "parent":
                    flows.account(self.plane, provenance, served)
            if 200 <= result.status < 400:
                flows.request(
                    self.plane, provenance, latency_s=time.monotonic() - t0
                )

    def _note_layer_demand(self, url: str, result, head: bool = False) -> None:
        """Emit the per-layer-digest demand signal for a served blob GET
        (HEADs are existence probes, not demand). Only successful (2xx)
        pulls count — repeated 404/401 probes of a missing layer must not
        rank it forecast-hot — and only pulls that did NOT ride P2P emit:
        a P2P ride lands a DownloadRecord at the scheduler, which folds
        the same pull there (emitting both would double-count it). When
        the transport can resolve the swarm identity the pull WOULD ride
        (task id + tag), it rides along so the preheat loop seeds the
        exact task demanded clients join. Advisory: a raising subscriber
        must never fail the response path."""
        if head or self.on_layer_demand is None:
            return
        if not 200 <= result.status < 300 or result.via_p2p:
            return
        m = _BLOB_PATH_RX.search(urlsplit(url).path)
        if m is None:
            return
        digest = m.group(1)
        task_id, target, meta = "", url, None
        ctx = self.transport.p2p_task_context(url)
        if ctx is not None:
            task_id, target, tag = ctx
            meta = {"tag": tag} if tag else {}
        EV_LAYER_DEMAND(digest=digest, task_id=task_id)
        try:
            self.on_layer_demand(digest, target, task_id=task_id, meta=meta)
        except Exception:
            logger.exception("layer-demand subscriber failed")

    # ------------------------------------------------------------------
    def _should_intercept(self, host: str) -> bool:
        if self.issuer is None:
            return False
        if self.intercept is None:
            return True
        return any(rx.search(host) for rx in self.intercept)

    def _server_ctx(self, host: str) -> ssl.SSLContext:
        """TLS server context presenting a spoofed cert for ``host``
        (cached; load_cert_chain needs files, so the pair lands in a
        private tmpdir once per host)."""
        with self._ssl_lock:
            ctx = self._ssl_ctx_cache.get(host)
            if ctx is not None:
                return ctx
        pair = self.issuer.for_host(host)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        with tempfile.TemporaryDirectory(prefix="df-mitm-") as d:
            cert_f, key_f = f"{d}/c.pem", f"{d}/k.pem"
            with open(cert_f, "wb") as f:
                f.write(pair.cert_pem)
            with open(key_f, "wb") as f:
                f.write(pair.key_pem)
            ctx.load_cert_chain(cert_f, key_f)
        with self._ssl_lock:
            self._ssl_ctx_cache[host] = ctx
        return ctx

    def _handle_connect(self, handler: BaseHTTPRequestHandler) -> None:
        """CONNECT: TLS-intercept (issuer configured and host matches)
        or relay the bytes opaquely."""
        host, _, port_s = handler.path.partition(":")
        if self._should_intercept(host):
            self._mitm(handler, host, port_s or "443")
            return
        try:
            upstream = socket.create_connection((host, int(port_s or 443)), timeout=10)
        except OSError as e:
            handler.send_error(502, f"CONNECT failed: {e}")
            return
        handler.send_response(200, "Connection Established")
        handler.end_headers()
        client = handler.connection
        try:
            self._relay(client, upstream)
        finally:
            upstream.close()
            # the socket carried opaque TLS bytes — never loop back into
            # HTTP parsing on it (a cleartext 400 mid-TLS breaks clients)
            handler.close_connection = True

    def _mitm(self, handler: BaseHTTPRequestHandler, host: str, port: str) -> None:
        """Terminate the client's TLS with a spoofed cert and serve the
        decrypted requests through the normal P2P routing (reference
        proxy.go:268-766 interceptor)."""
        handler.send_response(200, "Connection Established")
        handler.end_headers()
        handler.wfile.flush()
        outer = self
        origin = host if port == "443" else f"{host}:{port}"
        try:
            tls = self._server_ctx(host).wrap_socket(
                handler.connection, server_side=True
            )
        except (ssl.SSLError, OSError) as e:
            logger.debug("mitm handshake with %s failed: %s", origin, e)
            handler.close_connection = True
            return

        class MitmHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("mitm: " + fmt, *args)

            def do_GET(self):
                self.path = f"https://{origin}{self.path}"
                outer._handle_get(self)

            def do_HEAD(self):
                self.path = f"https://{origin}{self.path}"
                outer._handle_get(self, head=True)

            # write/auth traffic (docker push POSTs, token exchanges)
            # forwards to the origin untouched — only GETs ride P2P
            def do_POST(self):
                outer._forward_upstream(self, origin)

            def do_PUT(self):
                outer._forward_upstream(self, origin)

            def do_PATCH(self):
                outer._forward_upstream(self, origin)

            def do_DELETE(self):
                outer._forward_upstream(self, origin)

        try:
            MitmHandler(tls, handler.client_address, handler.server)
        except (ssl.SSLError, OSError, ConnectionError) as e:
            logger.debug("mitm session with %s ended: %s", origin, e)
        finally:
            try:
                tls.close()
            except OSError:
                pass
            handler.close_connection = True

    def _forward_upstream(self, handler: BaseHTTPRequestHandler, origin: str) -> None:
        """Non-GET MITM traffic: forward verbatim to the real origin and
        stream the response back (the opaque-tunnel behavior, minus the
        tunnel)."""
        import urllib.error
        import urllib.request

        from dragonfly2_torch.client.source import open_url

        te = (handler.headers.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            # registry pushes (docker PATCH/POST blob uploads) send
            # chunked bodies: decode them here — forwarding body=None
            # would corrupt the upload AND leave the unread chunks in
            # rfile to desync the next keep-alive request
            body = _read_chunked_body(handler.rfile)
        else:
            length = int(handler.headers.get("Content-Length") or 0)
            body = handler.rfile.read(length) if length else None
        headers = {
            k: v
            for k, v in handler.headers.items()
            if k.lower() not in _HOP_HEADERS and k.lower() != "transfer-encoding"
        }
        req = urllib.request.Request(
            f"https://{origin}{handler.path}",
            data=body,
            headers=headers,
            method=handler.command,
        )
        try:
            resp = open_url(req, 60.0)
        except urllib.error.HTTPError as e:
            resp = e  # upstream status passes through
        except OSError as e:
            handler.send_error(502, f"upstream {handler.command} failed: {e}")
            return
        with resp:
            data = resp.read()
            handler.send_response(resp.status if hasattr(resp, "status") else resp.code)
            for k, v in resp.headers.items():
                if k.lower() not in _HOP_HEADERS and k.lower() != "content-length":
                    handler.send_header(k, v)
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data)

    @staticmethod
    def _relay(a: socket.socket, b: socket.socket) -> None:
        sockets = [a, b]
        while True:
            readable, _, _ = select.select(sockets, [], [], 60)
            if not readable:
                return  # idle timeout
            for s in readable:
                try:
                    data = s.recv(65536)
                except OSError:
                    return
                if not data:
                    return
                (b if s is a else a).sendall(data)
