"""Object-storage gateway: the daemon's HTTP front for bucket/object ops
(counterpart of the reference's ``client/objectstorage.py``).

Role parity: upstream client/daemon/objectstorage/objectstorage.go:138-724
— a gin HTTP server on the daemon: GET/HEAD/PUT/DELETE object + create
bucket; GETs ride the P2P pipeline (shared swarm across daemons that
front the same backend), PUTs fan out by replication mode. The backend is
any pkg-style ObjectStorage backend (manager.objectstorage — filesystem in
this environment, S3-shaped interface).

API (dfstore speaks this):
  PUT    /buckets/<bucket>                       create bucket
  GET    /buckets/<bucket>/objects/<key>         fetch (via P2P)
  HEAD   /buckets/<bucket>/objects/<key>         existence/length
  PUT    /buckets/<bucket>/objects/<key>?mode=N  store (0=backend only,
                                                 1=also import locally as
                                                 a completed task: the
                                                 writing daemon becomes
                                                 the object's first seed)
  DELETE /buckets/<bucket>/objects/<key>         delete from backend
  GET    /buckets/<bucket>/objects?prefix=       list keys (JSON)
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from dragonfly2_torch.manager.objectstorage import ObjectStorage
from dragonfly2_torch.utils import dflog, flight, flows, profiling

logger = dflog.get("client.objectstorage")

# dfprof phase: one gateway op (route + backend/transport leg)
PH_OBJECT_OP = profiling.phase_type("daemon.object_op")

# provenance anomaly: an object GET that should have ridden P2P but
# fell back to a direct fetch — carries the swallowed cause
EV_OBJECT_FALLBACK = flight.event_type("daemon.object_fallback")

# replication modes (upstream objectstorage.go WriteBack / AsyncWriteBack)
MODE_BACKEND_ONLY = 0
MODE_IMPORT_LOCAL = 1

# content-digest sidecar suffix: the digest participates in the P2P task
# id, so an overwritten object gets a fresh task identity instead of the
# swarm serving stale cached bytes forever
DIGEST_SUFFIX = ".df-digest"


def _slice_stream(chunks, offset: int, length: int):
    """Skip ``offset`` bytes of a chunk iterator, then yield exactly
    ``length`` — range semantics over a whole-object stream without
    buffering it."""
    remaining_skip, remaining = offset, length
    for chunk in chunks:
        if remaining_skip:
            if len(chunk) <= remaining_skip:
                remaining_skip -= len(chunk)
                continue
            chunk = chunk[remaining_skip:]
            remaining_skip = 0
        if remaining <= 0:
            break
        if len(chunk) > remaining:
            chunk = chunk[:remaining]
        remaining -= len(chunk)
        yield chunk


def _sha256(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


class ObjectStorageGateway:
    """HTTP gateway bound to a daemon: backend + P2P transport."""

    def __init__(
        self,
        backend: ObjectStorage,
        transport=None,  # client.transport.P2PTransport; None = direct reads
        importer=None,  # callable(url, data) registering a local seed copy
        url_for=None,  # callable(bucket, key) -> origin URL for P2P fetch
        address: str = "127.0.0.1",
        port: int = 0,
    ):
        self.backend = backend
        self.transport = transport
        self.plane = "object"
        if transport is not None:
            # the gateway IS the object plane front: stamp its transport
            # so piece-level flow attribution agrees with the gateway's
            # own request-level accounting
            transport.plane = self.plane
        self.importer = importer
        self.url_for = url_for
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("gateway: " + fmt, *args)

            def do_PUT(self):
                outer._route(self, "PUT")

            def do_GET(self):
                outer._route(self, "GET")

            def do_HEAD(self):
                outer._route(self, "HEAD")

            def do_DELETE(self):
                outer._route(self, "DELETE")

        self._server = ThreadingHTTPServer((address, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="os-gateway", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    # ------------------------------------------------------------------
    def _route(self, h: BaseHTTPRequestHandler, method: str) -> None:
        try:
            with PH_OBJECT_OP:
                return self._route_inner(h, method)
        except FileNotFoundError:
            h.send_error(404, "object not found")
        except Exception as e:
            logger.exception("gateway %s %s failed", method, h.path)
            try:
                h.send_error(500, str(e))
            except Exception:
                pass

    def _route_inner(self, h: BaseHTTPRequestHandler, method: str) -> None:
        parts = urllib.parse.urlsplit(h.path)
        segs = [s for s in parts.path.split("/") if s]
        query = dict(urllib.parse.parse_qsl(parts.query))
        if len(segs) >= 1 and segs[0] == "buckets":
            if len(segs) == 2 and method == "PUT":
                return self._create_bucket(h, segs[1])
            if len(segs) == 3 and segs[2] == "objects" and method == "GET":
                return self._list_objects(h, segs[1], query.get("prefix", ""))
            if len(segs) >= 4 and segs[2] == "objects":
                key = "/".join(segs[3:])
                if method == "PUT":
                    return self._put_object(h, segs[1], key, query)
                if method == "GET":
                    return self._get_object(h, segs[1], key)
                if method == "HEAD":
                    return self._head_object(h, segs[1], key)
                if method == "DELETE":
                    return self._delete_object(h, segs[1], key)
        h.send_error(404, "no such route")

    # ------------------------------------------------------------------
    def _create_bucket(self, h, bucket: str) -> None:
        self.backend.create_bucket(bucket)
        h.send_response(201)
        h.send_header("Content-Length", "0")
        h.end_headers()

    def _put_object(self, h, bucket: str, key: str, query: dict) -> None:
        if "chunked" in h.headers.get("Transfer-Encoding", "").lower():
            # reading a chunked body as length-0 would silently store an
            # empty object with a 201
            h.send_error(411, "Content-Length required (chunked not supported)")
            return
        length = int(h.headers.get("Content-Length", 0))
        data = h.rfile.read(length)
        digest = _sha256(data)
        self.backend.put_object(bucket, key, data)
        self.backend.put_object(bucket, key + DIGEST_SUFFIX, digest.encode())
        mode = int(query.get("mode", MODE_BACKEND_ONLY))
        if mode == MODE_IMPORT_LOCAL and self.importer is not None and self.url_for:
            # writing daemon becomes the first P2P seed of the object
            try:
                self.importer(self.url_for(bucket, key), data, digest)
            except Exception:
                logger.exception("local import of %s/%s failed", bucket, key)
        h.send_response(201)
        h.send_header("Content-Length", "0")
        h.end_headers()

    def _digest_of(self, bucket: str, key: str) -> str:
        try:
            return self.backend.get_object(bucket, key + DIGEST_SUFFIX).decode()
        except FileNotFoundError:
            return ""

    def _get_object(self, h, bucket: str, key: str) -> None:
        from dragonfly2_torch.client.pieces import resolve_byte_range

        if not self.backend.head_object(bucket, key):
            raise FileNotFoundError(key)
        # resolve the client Range ONCE against the known total (shared
        # by every route below); RFC 7233: an unparsable Range header is
        # IGNORED (whole object, 200), an unsatisfiable one is 416
        rng = h.headers.get("Range", "")
        total = self.backend.stat_object(bucket, key)
        rr = None
        if rng:
            try:
                rr = resolve_byte_range(rng, total)
            except ValueError:
                rng = ""
            else:
                if rr is None:
                    # RFC 7233: the 416 carries the total so resume
                    # logic can recover the object size
                    h.send_response(416)
                    h.send_header("Content-Range", f"bytes */{total}")
                    h.send_header("Content-Length", "0")
                    h.end_headers()
                    return
        t0 = time.monotonic()
        if self.transport is not None and self.url_for is not None:
            # client Range rides through the transport, which serves it
            # as a P2P ranged task or goes direct. A whole-object digest
            # pin can't gate a slice, so ranged GETs drop it (the
            # transport would refuse the combination).
            # the digest ALWAYS rides along: for unranged GETs it pins
            # content; for ranged ones the transport converts it into
            # task-identity salt so overwrites never serve stale slices
            result = self.transport.round_trip(
                self.url_for(bucket, key),
                headers={"Range": rng} if rng else None,
                digest=self._digest_of(bucket, key),
            )
            if result.fallback_cause:
                # the P2P leg failed and the transport went direct —
                # name the cause instead of swallowing it
                logger.warning(
                    "object get %s/%s skipped the swarm: %s",
                    bucket, key, result.fallback_cause,
                )
                EV_OBJECT_FALLBACK(
                    bucket=bucket, key=key, cause=result.fallback_cause
                )
            if result.status == 404:
                raise FileNotFoundError(key)
            if result.status not in (200, 206):
                # upstream error stays an error — never relabeled 200,
                # never sliced into a fake successful partial read
                h.send_error(502, f"upstream returned {result.status}")
                return
            length = result.content_length
            body = result.body
            status = result.status
            content_range = result.headers.get("Content-Range", "")
            if rr and status == 200:
                # the transport couldn't serve the range itself (suffix
                # form, direct file fetch) and returned the whole object
                # — slice it HERE so S3 semantics hold on every route
                off, end = rr
                body = _slice_stream(result.body, off, end - off + 1)
                length = end - off + 1
                status = 206
                content_range = f"bytes {off}-{end}/{total}"
            elif status == 206 and content_range.endswith("/*"):
                # the transport doesn't know the total; the gateway does
                # (size probes like 'bytes=0-0' read it from here)
                content_range = content_range[:-1] + str(total)
            if length < 0:
                # unknown-length stream on keep-alive HTTP/1.1 would
                # hang the client waiting for EOF
                length = (rr[1] - rr[0] + 1) if rr else total
            h.send_response(status)
            h.send_header("Content-Length", str(length))
            if content_range:
                h.send_header("Content-Range", content_range)
            if result.headers.get("Content-Type"):
                h.send_header("Content-Type", result.headers["Content-Type"])
            h.send_header("Accept-Ranges", "bytes")
            h.send_header("X-Dragonfly-Via-P2P", "1" if result.via_p2p else "0")
            if result.task_id:
                h.send_header("X-Dragonfly-Task-Id", result.task_id)
            h.end_headers()
            # stream — multi-GB objects must not be buffered per request
            served = 0
            for chunk in body:
                h.wfile.write(chunk)
                served += len(chunk)
            # flow ledger: P2P rides were attributed at the piece write;
            # local reuse and direct responses are acquired here
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
            flows.request(self.plane, provenance, latency_s=time.monotonic() - t0)
            return
        body = self.backend.get_object(bucket, key)
        if rr:
            off, end = rr
            h.send_response(206)
            h.send_header("Content-Range", f"bytes {off}-{end}/{total}")
            body = body[off : end + 1]
        else:
            h.send_response(200)
        h.send_header("Content-Length", str(len(body)))
        h.send_header("Accept-Ranges", "bytes")
        h.send_header("X-Dragonfly-Via-P2P", "0")
        h.end_headers()
        h.wfile.write(body)
        if body:
            # no transport: bytes come straight off the backend (origin)
            flows.serve(self.plane, len(body))
            flows.account(self.plane, "origin", len(body))
        flows.request(self.plane, "origin", latency_s=time.monotonic() - t0)

    def _head_object(self, h, bucket: str, key: str) -> None:
        if not self.backend.head_object(bucket, key):
            h.send_error(404, "object not found")
            return
        h.send_response(200)
        h.send_header("Content-Length", str(self.backend.stat_object(bucket, key)))
        h.send_header("Accept-Ranges", "bytes")  # SDK transfer managers probe this
        h.end_headers()

    def _delete_object(self, h, bucket: str, key: str) -> None:
        self.backend.delete_object(bucket, key)
        self.backend.delete_object(bucket, key + DIGEST_SUFFIX)
        h.send_response(204)
        h.send_header("Content-Length", "0")
        h.end_headers()

    def _list_objects(self, h, bucket: str, prefix: str) -> None:
        keys = [
            k
            for k in self.backend.list_objects(bucket, prefix)
            if not k.endswith(DIGEST_SUFFIX)
        ]
        body = json.dumps({"keys": keys}).encode()
        h.send_response(200)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)
