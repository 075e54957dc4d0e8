"""P2P transport: route eligible HTTP requests through the peer-task
pipeline with back-source fallback; client Range requests become ranged
tasks (206 + Content-Range) when their absolute start is known
(counterpart of the reference's ``client/transport.py``).

Role parity: reference client/daemon/transport/transport.go — an
http.RoundTripper that sends matching GET requests through P2P (stream
peer task) and everything else (or any P2P failure) straight to the
origin. The proxy (client/proxy.py) rides this layer, and the
object-storage gateway will when it is ported (ROADMAP queue A item
A-D2 (b)). Responses are streamed — bodies are chunk iterators,
never whole-blob buffers — and upstream status/headers are preserved so
206/404/Content-Type survive the proxy hop.
"""

from __future__ import annotations

import os
import re
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Iterator

from dragonfly2_torch.client import metrics as M
from dragonfly2_torch.client import source
from dragonfly2_torch.client.peertask import FileTaskRequest, TaskManager
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.utils import dflog, flows

common_pb2 = protos.load("common_pb2")

logger = dflog.get("client.transport")

_CHUNK = 256 * 1024


@dataclass
class ProxyRule:
    """One routing rule (reference proxy config Rules): requests whose URL
    matches ``regex`` are served via P2P unless ``direct``; ``use_https``
    upgrades the scheme before fetching."""

    regex: str
    direct: bool = False
    use_https: bool = False
    redirect: str = ""  # replacement host, e.g. a registry mirror

    def __post_init__(self):
        self._re = re.compile(self.regex)

    def matches(self, url: str) -> bool:
        return bool(self._re.search(url))

    def rewrite(self, url: str) -> str:
        if self.use_https:
            url = url.replace("http://", "https://", 1)
        if self.redirect:
            url = self._re.sub(self.redirect, url, count=1)
        return url


@dataclass
class TransportResult:
    status: int
    headers: dict  # upstream response headers (Content-Type etc.)
    body: Iterator[bytes]  # streamed chunks; empty iterator for HEAD
    content_length: int = -1
    via_p2p: bool = False
    task_id: str = ""
    # the task was already complete in local storage — bytes stream from
    # disk with no new acquisition (flow provenance "local_cache")
    local_cache: bool = False
    # non-empty when this is a direct response produced by a P2P
    # failure: the swallowed cause, surfaced for logs + flight events
    fallback_cause: str = ""

    def read_all(self) -> bytes:
        return b"".join(self.body)


class _Permit:
    """One in-flight P2P slot. Released explicitly when the response
    body is exhausted; the finalizer is the backstop for a caller that
    abandons the TransportResult without ever touching the body."""

    __slots__ = ("_sem", "_done")

    def __init__(self, sem: threading.BoundedSemaphore):
        self._sem = sem
        self._done = False

    def release(self) -> None:
        if not self._done:
            self._done = True
            self._sem.release()

    def __del__(self):  # pragma: no cover - GC backstop
        self.release()


def _releasing_iter(body: Iterator[bytes], permit: _Permit) -> Iterator[bytes]:
    try:
        yield from body
    finally:
        permit.release()


class P2PTransport:
    """Route a request: matching rule → peer task (P2P swarm + scheduler
    + back-to-source); no match or failure → direct origin fetch."""

    NO_RANGE_TTL = 60.0  # negative cache for range-refusing origins

    def __init__(
        self,
        task_manager: TaskManager,
        rules: list[ProxyRule] | None = None,
        default_tag: str = "",
        timeout: float = 300.0,
        max_inflight: int | None = None,
        plane: str = "file",
    ):
        self.tasks = task_manager
        self.rules = rules or []
        self.default_tag = default_tag
        self.timeout = timeout
        # flow-ledger traffic plane every task started through this
        # transport belongs to ("image" for the registry proxy,
        # "object" for the dfstore gateway)
        self.plane = plane
        self._no_range: dict[str, float] = {}
        self._no_range_lock = threading.Lock()
        # bound on concurrent P2P stream tasks: each one costs piece
        # workers + an announce stream, so an unbounded proxy fan-in
        # would amplify 10k client requests into 40k threads. At the
        # bound, new requests shed to a DIRECT fetch (graceful
        # degradation, counted) instead of queueing behind the swarm.
        if max_inflight is None:
            max_inflight = int(os.environ.get("DF_P2P_MAX_INFLIGHT", "512"))
        self._inflight = (
            threading.BoundedSemaphore(max_inflight) if max_inflight > 0 else None
        )

    def match_rule(self, url: str) -> ProxyRule | None:
        for rule in self.rules:
            if rule.matches(url):
                return rule
        return None

    def p2p_task_context(self, url: str) -> "tuple[str, str, str] | None":
        """(task_id, target_url, tag) of the swarm an unranged GET of
        ``url`` joins under this transport's routing — the identity a
        preheat must reproduce for its seeded content to be findable —
        or None when the request would go direct (no rule / direct
        rule), where no swarm exists to preheat into."""
        rule = self.match_rule(url)
        if rule is None or rule.direct or self.tasks is None:
            return None
        target = rule.rewrite(url)
        task_id = self.tasks.task_id_for(
            target, common_pb2.UrlMeta(tag=self.default_tag)
        )
        return task_id, target, self.default_tag

    def round_trip(
        self,
        url: str,
        headers: dict | None = None,
        head: bool = False,
        digest: str = "",
    ) -> TransportResult:
        rule = self.match_rule(url)
        if rule is None or rule.direct:
            target = url if rule is None else rule.rewrite(url)
            return self._direct(target, headers, head)
        target = rule.rewrite(url)
        if head:
            return self._direct(target, headers, head)
        # a client Range request rides P2P as a RANGED task (the slice
        # IS the task — client/pieces.py semantics), so resumed pulls
        # and ranged layer fetches still hit the swarm. Suffix ('-n')
        # and multi-range forms fall back to a direct fetch: their
        # absolute start is unknown without the total, which
        # Content-Range needs.
        range_spec = next(
            (v for k, v in (headers or {}).items() if k.lower() == "range"), ""
        )
        byte_range = ""
        tag_salt = ""
        if range_spec:
            from dragonfly2_torch.client.pieces import normalize_byte_range

            # If-Range is a VALIDATOR the swarm cache cannot honor (task
            # identity is url+range, not etag) — serving a stale slice
            # would splice old bytes onto a newer partial file: direct,
            # as are suffix forms (absolute start unknown) and recently
            # range-refusing origins.
            if any(k.lower() == "if-range" for k in (headers or {})):
                return self._direct(target, headers, head)
            try:
                byte_range = normalize_byte_range(range_spec)
            except ValueError:
                return self._direct(target, headers, head)
            if byte_range.startswith("-"):
                return self._direct(target, headers, head)
            if byte_range == "":
                # 'bytes=0-' IS the whole object — plain unranged
                # semantics (incl. the digest pin); anything else would
                # mint a duplicate full-object cache entry
                range_spec = ""
            else:
                # a whole-object digest can't VERIFY a slice, but it must
                # still VERSION the cache — as task-identity salt — or an
                # object overwrite would serve stale slice bytes forever
                tag_salt, digest = digest, ""
                # read the verdict under the lock, fetch OUTSIDE it — a
                # direct origin fetch under _no_range_lock would serialize
                # every range-fallback request behind one slow origin
                with self._no_range_lock:
                    range_refused = (
                        self._no_range.get(target, 0.0) > time.monotonic()
                    )
                if range_refused:
                    return self._direct(target, headers, head)
        permit = None
        if self._inflight is not None:
            if not self._inflight.acquire(blocking=False):
                # at the in-flight bound: shed to a direct fetch —
                # bounded degradation beats queueing behind the swarm
                M.P2P_INFLIGHT_SHED_TOTAL.inc()
                logger.warning("p2p in-flight bound hit for %s; going direct", url)
                return self._direct(target, headers, head)
            permit = _Permit(self._inflight)
        try:
            return self._via_p2p(
                target, headers, digest, byte_range=byte_range,
                tag_salt=tag_salt, permit=permit,
            )
        except Exception as e:
            if permit is not None:
                permit.release()
            # P2P failure degrades to a direct fetch, never a user error
            # (reference transport.go back-source fallback)
            logger.warning("p2p round-trip for %s failed (%s); going direct", url, e)
            if byte_range and "support" in str(e) and "range" in str(e).lower():
                # negative-cache RANGE-REFUSING origins only (a transient
                # scheduler hiccup must not unroute a capable origin):
                # they'd pay register→schedule→fail on every request
                with self._no_range_lock:
                    now = time.monotonic()
                    if len(self._no_range) > 256:  # drop expired entries
                        self._no_range = {
                            u: t for u, t in self._no_range.items() if t > now
                        }
                    self._no_range[target] = now + self.NO_RANGE_TTL
            res = self._direct(target, headers, head)
            res.fallback_cause = f"{type(e).__name__}: {e}"
            return res

    # ------------------------------------------------------------------
    def _via_p2p(
        self,
        url: str,
        headers: dict | None,
        digest: str = "",
        byte_range: str = "",
        tag_salt: str = "",
        permit: "_Permit | None" = None,
    ) -> TransportResult:
        # the digest participates in the task id: rewritten content gets a
        # fresh task identity instead of serving stale cached bytes. For
        # ranged tasks the whole-object digest rides the TAG instead —
        # identity versioning without slice-verification semantics.
        fwd = {k: v for k, v in (headers or {}).items() if k.lower() != "range"}
        tag = f"{self.default_tag}|{tag_salt}" if tag_salt else self.default_tag
        url_meta = common_pb2.UrlMeta(tag=tag, digest=digest, range=byte_range)
        req = FileTaskRequest(url=url, url_meta=url_meta, headers=fwd)
        # stamp the task's traffic plane BEFORE the task starts so the
        # first pieces never race to the implicit "file" plane; the
        # completed-task check tells the caller the bytes come from
        # local storage with no new acquisition
        task_id = self.tasks.task_id_for(url, url_meta)
        flows.set_task_plane(task_id, self.plane)
        local_reuse = self.tasks.storage.find_completed_task(task_id) is not None
        # stream frontend: the response starts at first byte, not last —
        # a multi-GB layer pull begins flowing while later pieces are
        # still in flight (reference peertask_stream.go)
        task_id, _, content_length, origin_headers, body = self.tasks.start_stream_task(
            req, timeout=self.timeout
        )
        status = 200
        if byte_range:
            # the task's content IS the slice; HTTP semantics for the
            # ranged client are 206 + Content-Range (total unknown: '*')
            status = 206
            lo = int(byte_range.split("-", 1)[0])
            origin_headers = dict(origin_headers)
            origin_headers["Content-Range"] = (
                f"bytes {lo}-{lo + content_length - 1}/*"
                if content_length >= 0
                else f"bytes {lo}-/*"
            )
        return TransportResult(
            status=status,
            # replay persisted origin headers (Content-Type) so registry
            # clients get proper metadata on P2P-served responses
            headers=origin_headers,
            body=body if permit is None else _releasing_iter(body, permit),
            content_length=content_length,
            via_p2p=True,
            task_id=task_id,
            local_cache=local_reuse,
        )

    def _direct(self, url: str, headers: dict | None, head: bool) -> TransportResult:
        if url.startswith(("http://", "https://")):
            req = urllib.request.Request(
                url, headers=dict(headers or {}), method="HEAD" if head else "GET"
            )
            try:
                # honors DF_ORIGIN_CA for origins behind a private CA
                resp = source.open_url(req, self.timeout)
            except urllib.error.HTTPError as e:
                # 404 from a blob-existence probe is an answer, not a
                # proxy failure — pass the upstream status through
                body = e.read()
                return TransportResult(
                    status=e.code,
                    headers=dict(e.headers),
                    body=iter([body] if body else []),
                    content_length=len(body),
                )
            length = int(resp.headers.get("Content-Length", -1) or -1)

            def chunks() -> Iterator[bytes]:
                with resp:
                    while True:
                        chunk = resp.read(_CHUNK)
                        if not chunk:
                            return
                        yield chunk

            if head:
                resp.close()
            return TransportResult(
                status=resp.status,
                headers=dict(resp.headers),
                body=iter(()) if head else chunks(),
                content_length=length,
            )
        # non-HTTP schemes (file:// in tests, s3:// etc.) via source clients
        client = source.client_for(url)
        if head:
            meta = client.metadata(url, headers)
            return TransportResult(
                status=200, headers={}, body=iter(()), content_length=meta.content_length
            )
        return TransportResult(
            status=200, headers={}, body=iter(client.download(url, headers))
        )
