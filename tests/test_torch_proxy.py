"""The reference's ``tests/test_proxy.py``, case for case, on the port's
registry proxy and P2P transport (``dragonfly2_torch.client.proxy`` and
``.transport``), with the two HTTPS MITM cases of ``tests/test_security.py``
and the transport's in-flight bound of ``tests/test_data_plane.py``.

Requests matching proxy rules must ride peer tasks (and be shared across
daemons); non-matching requests pass through directly; the registry
mirror rewrites mirror-relative paths onto the remote.

Where both sides can be observed, the reference's proxy cluster and the
port's serve the same requests from one seeded origin, and the answers
are held equal: status, the headers the proxy sets, body bytes, the task
ids of ``p2p_task_context`` and the proxy's request counts by route. Each
cluster is a scheduler of its own package and two daemons of it, every
server on port 0 and stopped in a fixture or ``finally``."""

from __future__ import annotations

import dataclasses
import http.client
import http.server
import io
import os
import random
import ssl
import stat
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from dragonfly2_torch.client import daemon as t_daemon
from dragonfly2_torch.client import metrics as t_metrics
from dragonfly2_torch.client import proxy as t_proxy
from dragonfly2_torch.client import transport as t_transport
from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_torch.client.piece_manager import TRAFFIC_REMOTE_PEER
from dragonfly2_torch.client.transport import P2PTransport, ProxyRule, TransportResult
from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.scheduler import evaluator as t_evaluator
from dragonfly2_torch.scheduler import resource as t_res
from dragonfly2_torch.scheduler import scheduling as t_scheduling
from dragonfly2_torch.scheduler import service as t_service
from dragonfly2_torch.scheduler import storage as t_storage
from dragonfly2_torch.utils import faults as t_faults
from dragonfly2_torch.utils import flight as t_flight
from dragonfly2_torch.utils import tracing as t_tracing
from dragonfly2_torch.utils.idgen import URLMeta, task_id_v1
from dragonfly2_torch.utils.issuer import CertificateAuthority, SpoofingIssuer

from dragonfly2_tpu.client import daemon as j_daemon
from dragonfly2_tpu.client import metrics as j_metrics
from dragonfly2_tpu.client import proxy as j_proxy
from dragonfly2_tpu.client import transport as j_transport
from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.scheduler import evaluator as j_evaluator
from dragonfly2_tpu.scheduler import resource as j_res
from dragonfly2_tpu.scheduler import scheduling as j_scheduling
from dragonfly2_tpu.scheduler import service as j_service
from dragonfly2_tpu.scheduler import storage as j_storage

torch.set_num_threads(1)

PIECE = 32 * 1024
BLOB = random.Random(17).randbytes(2 * PIECE + 100)

# (daemon, metrics, proxy, transport, glue, resource, evaluator, scheduling,
# service, storage) of each package
_PKGS = {
    "torch": (t_daemon, t_metrics, t_proxy, t_transport, t_glue, t_res, t_evaluator,
              t_scheduling, t_service, t_storage),
    "jax": (j_daemon, j_metrics, j_proxy, j_transport, j_glue, j_res, j_evaluator,
            j_scheduling, j_service, j_storage),
}


@pytest.fixture
def origin_server(tmp_path):
    """Tiny HTTP origin standing in for a registry blob store."""
    root = tmp_path / "www"
    root.mkdir()
    (root / "blob.bin").write_bytes(BLOB)
    (root / "manifest.json").write_bytes(b'{"layers": []}')

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(root), **kw)

        def log_message(self, *a):
            pass

        def do_HEAD(self):
            # advertise range support (the ranged-task back-source gate
            # requires it); SimpleHTTPRequestHandler never sends it
            path = root / self.path.lstrip("/")
            if path.is_file():
                self.send_response(200)
                self.send_header("Content-Length", str(path.stat().st_size))
                self.send_header("Accept-Ranges", "bytes")
                self.send_header("Content-Type", self.guess_type(str(path)))
                self.end_headers()
                return
            super().do_HEAD()

        def do_GET(self):
            # minimal Range support (SimpleHTTPRequestHandler ignores it)
            rng = self.headers.get("Range", "")
            path = root / self.path.lstrip("/")
            if rng.startswith("bytes=") and path.is_file():
                start_s, _, end_s = rng[6:].partition("-")
                data = path.read_bytes()
                if not start_s:  # suffix form: last N bytes
                    start = max(0, len(data) - int(end_s))
                    end = len(data) - 1
                else:
                    start = int(start_s)
                    end = int(end_s) if end_s else len(data) - 1
                chunk = data[start : end + 1]
                self.send_response(206)
                self.send_header("Content-Length", str(len(chunk)))
                self.send_header(
                    "Content-Range", f"bytes {start}-{end}/{len(data)}"
                )
                self.end_headers()
                self.wfile.write(chunk)
                return
            super().do_GET()

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


class _Cluster:
    """A scheduler of one package and two daemons of it, each with its
    proxy on port 0 and one rule sending ``blob.bin`` through P2P."""

    def __init__(self, pkg: str, tmp_path, origin: str):
        (daemon, _, _, _, glue, res, evaluator, scheduling, service, storage) = _PKGS[pkg]
        self.pkg, self.origin, self.daemons = pkg, origin, []
        self.storage = storage.Storage(tmp_path / "sched", buffer_size=1)
        svc = service.SchedulerService(
            res.Resource(),
            scheduling.Scheduling(
                evaluator.BaseEvaluator(),
                # a few retries with a real interval: under the suite's load
                # a daemon can register before the scheduler has taken its
                # parent's finish, and one empty search sends it to the origin
                scheduling.SchedulingConfig(retry_interval=0.05, retry_back_to_source_limit=3),
            ),
            storage=self.storage,
        )
        self.server, port = glue.serve({glue.SCHEDULER_SERVICE: svc})
        try:
            for name in ("a", "b"):
                d = daemon.Daemon(daemon.DaemonConfig(
                    data_dir=str(tmp_path / f"daemon-{name}"),
                    scheduler_address=f"127.0.0.1:{port}",
                    hostname=f"host-{name}",
                    ip="127.0.0.1",
                    piece_length=PIECE,
                    schedule_timeout=5.0,
                    announce_interval=60.0,
                    collect_host_stats=False,
                    proxy_port=0,
                    proxy_rules=[{"regex": r"blob\.bin"}],
                ))
                self.daemons.append(d)
                d.start()
        except BaseException:
            self.stop()
            raise

    def wait_records(self, n: int, timeout: float = 10.0) -> None:
        """Until the scheduler holds ``n`` download records: a daemon's
        finish has reached it, so the next daemon finds it as a parent."""
        deadline = time.time() + timeout
        while time.time() < deadline and len(list(self.storage.list_download())) < n:
            time.sleep(0.02)

    def stop(self) -> None:
        for d in self.daemons:
            d.stop()
        self.server.stop(0)


@pytest.fixture
def proxy_cluster(tmp_path, origin_server):
    cluster = _Cluster("torch", tmp_path, origin_server)
    yield {"daemons": cluster.daemons, "origin": origin_server, "cluster": cluster}
    cluster.stop()


def _proxy_get(proxy_port: int, url: str):
    req = urllib.request.Request(url)
    req.set_proxy(f"127.0.0.1:{proxy_port}", "http")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read(), dict(resp.headers)


def _wait_completed(storage, task_id, timeout=5.0):
    """Streaming responses end at the last byte; the conductor's finish
    handshake (scheduler DownloadPeerFinished) completes moments later —
    poll for the locally-completed task instead of assuming it."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        ts = storage.find_completed_task(task_id)
        if ts is not None:
            return ts
        time.sleep(0.02)
    raise AssertionError(f"task {task_id[:16]} never completed locally")


# ---------------------------------------------------------------------------
# the reference's tests/test_proxy.py, case for case
# ---------------------------------------------------------------------------


def test_matching_request_rides_p2p(proxy_cluster):
    da, db = proxy_cluster["daemons"]
    url = proxy_cluster["origin"] + "/blob.bin"

    body, headers = _proxy_get(da.proxy.port, url)
    assert body == BLOB
    assert headers["X-Dragonfly-Via-P2P"] == "1"
    _wait_completed(da.storage, headers["X-Dragonfly-Task-Id"])
    proxy_cluster["cluster"].wait_records(1)

    # second daemon's proxy shares the swarm: its pieces come from A
    body_b, headers_b = _proxy_get(db.proxy.port, url)
    assert body_b == BLOB
    assert headers_b["X-Dragonfly-Via-P2P"] == "1"
    task_id = headers_b["X-Dragonfly-Task-Id"]
    ts = _wait_completed(db.storage, task_id)
    assert {p.traffic_type for p in ts.meta.pieces.values()} == {TRAFFIC_REMOTE_PEER}


def test_non_matching_request_passes_through(proxy_cluster):
    da = proxy_cluster["daemons"][0]
    url = proxy_cluster["origin"] + "/manifest.json"
    body, headers = _proxy_get(da.proxy.port, url)
    assert body == b'{"layers": []}'
    assert headers["X-Dragonfly-Via-P2P"] == "0"


def test_transport_rule_matching():
    for transport in (t_transport, j_transport):
        rules = [
            transport.ProxyRule(regex=r"/v2/.*/blobs/", direct=False),
            transport.ProxyRule(regex=r"\.json$", direct=True),
        ]
        t = transport.P2PTransport(task_manager=None, rules=rules)
        assert t.match_rule("http://r/v2/lib/nginx/blobs/sha256:x") is rules[0]
        assert t.match_rule("http://r/manifest.json") is rules[1]
        assert t.match_rule("http://r/other") is None


def test_transport_p2p_failure_falls_back_direct(origin_server, monkeypatch):
    rule = ProxyRule(regex=r"blob\.bin")
    t = P2PTransport(task_manager=None, rules=[rule])

    def boom(*args, **kwargs):
        # accept the full real signature — a TypeError from a stale
        # signature would ALSO be swallowed by the fallback and pass
        # this test for the wrong reason
        raise RuntimeError("swarm unavailable")

    monkeypatch.setattr(t, "_via_p2p", boom)
    result = t.round_trip(origin_server + "/blob.bin")
    assert isinstance(result, TransportResult)
    assert result.read_all() == BLOB
    assert result.status == 200
    assert not result.via_p2p
    assert result.fallback_cause == "RuntimeError: swarm unavailable"


def test_registry_mirror_relative_paths(tmp_path, origin_server):
    """Mirror mode: a non-absolute request path is resolved against the
    mirror remote (container engines speak to the proxy like a host)."""
    transport = P2PTransport(task_manager=None, rules=[])  # all direct
    proxy = t_proxy.ProxyServer(
        transport, mirror=t_proxy.RegistryMirror(remote=origin_server), port=0
    )
    proxy.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", proxy.port, timeout=10)
        conn.request("GET", "/manifest.json")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.read() == b'{"layers": []}'
        conn.close()
    finally:
        proxy.stop()


def test_upstream_404_passes_through(proxy_cluster):
    """A registry blob-existence probe's 404 is an answer, not a 502."""
    da = proxy_cluster["daemons"][0]
    url = proxy_cluster["origin"] + "/missing.json"
    req = urllib.request.Request(url)
    req.set_proxy(f"127.0.0.1:{da.proxy.port}", "http")
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(req, timeout=10)
    assert exc_info.value.code == 404


def test_ranged_request_rides_p2p_as_a_ranged_task(proxy_cluster):
    """A client Range request becomes a RANGED task (the slice is the
    task): 206 + Content-Range, served via P2P, and a second daemon
    requesting the same slice pulls it from the first."""
    da, db = proxy_cluster["daemons"]
    url = proxy_cluster["origin"] + "/blob.bin"
    for k, d in enumerate((da, db), 1):
        req = urllib.request.Request(url, headers={"Range": "bytes=100-4095"})
        req.set_proxy(f"127.0.0.1:{d.proxy.port}", "http")
        with urllib.request.urlopen(req, timeout=20) as resp:
            body = resp.read()
            assert resp.status == 206
            assert resp.headers["X-Dragonfly-Via-P2P"] == "1"
            assert resp.headers["Content-Range"].startswith("bytes 100-4095/")
        assert body == BLOB[100:4096]
        proxy_cluster["cluster"].wait_records(k)

    # suffix form has no absolute start without the total → direct, 206
    req = urllib.request.Request(url, headers={"Range": "bytes=-100"})
    req.set_proxy(f"127.0.0.1:{da.proxy.port}", "http")
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.status == 206
        assert resp.headers["X-Dragonfly-Via-P2P"] == "0"
        assert resp.read() == BLOB[-100:]


def test_head_reports_length_without_body(proxy_cluster):
    da = proxy_cluster["daemons"][0]
    url = proxy_cluster["origin"] + "/blob.bin"
    req = urllib.request.Request(url, method="HEAD")
    req.set_proxy(f"127.0.0.1:{da.proxy.port}", "http")
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert int(resp.headers["Content-Length"]) == len(BLOB)
        assert resp.read() == b""


def test_p2p_response_preserves_content_type(proxy_cluster):
    """P2P-served responses replay the origin's Content-Type persisted
    with the task metadata (registry clients need it on blobs) — both on
    the daemon that back-sourced and on one that downloaded pure-P2P
    (the header rides the piece transfer between daemons)."""
    da, db = proxy_cluster["daemons"]
    url = proxy_cluster["origin"] + "/blob.bin"
    _, headers = _proxy_get(da.proxy.port, url)
    assert headers["X-Dragonfly-Via-P2P"] == "1"
    assert headers.get("Content-Type") == "application/octet-stream"
    _wait_completed(da.storage, headers["X-Dragonfly-Task-Id"])
    proxy_cluster["cluster"].wait_records(1)

    _, headers_b = _proxy_get(db.proxy.port, url)
    assert headers_b["X-Dragonfly-Via-P2P"] == "1"
    assert headers_b.get("Content-Type") == "application/octet-stream"
    task_id = headers_b["X-Dragonfly-Task-Id"]
    ts = _wait_completed(db.storage, task_id)
    assert {p.traffic_type for p in ts.meta.pieces.values()} == {TRAFFIC_REMOTE_PEER}


def test_mirror_does_not_capture_absolute_uris(origin_server):
    """A configured registry mirror must NOT swallow absolute-URI proxied
    requests for arbitrary hosts — those route by rules/direct; only
    mirror-relative paths resolve against the mirror remote."""
    transport = P2PTransport(task_manager=None, rules=[])  # all direct
    # a dead mirror: if absolute URIs were rewritten onto it, this GET
    # would 502 instead of reaching the real origin
    proxy = t_proxy.ProxyServer(
        transport, mirror=t_proxy.RegistryMirror(remote="http://127.0.0.1:9"), port=0
    )
    proxy.start()
    try:
        body, headers = _proxy_get(proxy.port, origin_server + "/manifest.json")
        assert body == b'{"layers": []}'
    finally:
        proxy.stop()


_CHUNKED = (
    b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n",
    b"5;ext=1\r\nhello\r\n0\r\nTrailer: x\r\n\r\n",
    b"5\r\nhel",
    b"a\r\n0123456789\r\n1\r\n!\r\n0\r\n\r\n",
    b"zz\r\n",
)


def test_mitm_forwards_chunked_request_bodies():
    """docker-push-style chunked uploads through the MITM proxy must be
    decoded and forwarded whole, and must not desync keep-alive."""
    body = b"5\r\nhello\r\n6\r\n world\r\n0\r\n\r\n"
    assert t_proxy._read_chunked_body(io.BytesIO(body)) == b"hello world"
    # chunk extensions and trailers tolerated
    ext = b"5;ext=1\r\nhello\r\n0\r\nTrailer: x\r\n\r\n"
    assert t_proxy._read_chunked_body(io.BytesIO(ext)) == b"hello"
    with pytest.raises(ValueError):
        t_proxy._read_chunked_body(io.BytesIO(b"5\r\nhel"))  # truncated

    # the reference's decoder gives the same bytes or raises alike
    def outcome(read, raw):
        try:
            return ("ok", read(io.BytesIO(raw)))
        except ValueError as e:
            return ("raise", str(e))

    for raw in _CHUNKED:
        assert outcome(t_proxy._read_chunked_body, raw) == outcome(j_proxy._read_chunked_body, raw)
    with pytest.raises(ValueError, match="forwarding cap"):
        t_proxy._read_chunked_body(io.BytesIO(_CHUNKED[3]), max_bytes=8)


def test_if_range_and_digest_pins_go_direct(proxy_cluster):
    """If-Range validators and whole-object digest pins cannot be
    honored by the swarm cache — both must bypass P2P."""
    da = proxy_cluster["daemons"][0]
    url = proxy_cluster["origin"] + "/blob.bin"
    req = urllib.request.Request(
        url, headers={"Range": "bytes=0-99", "If-Range": '"some-etag"'}
    )
    req.set_proxy(f"127.0.0.1:{da.proxy.port}", "http")
    with urllib.request.urlopen(req, timeout=10) as resp:
        assert resp.status == 206
        assert resp.headers["X-Dragonfly-Via-P2P"] == "0"
        assert resp.read() == BLOB[:100]


def _negative_cache_calls(transport) -> int:
    calls = {"p2p": 0}

    class _Storage:
        @staticmethod
        def find_completed_task(task_id):
            return None

    class TM:
        storage = _Storage()

        def task_id_for(self, url, url_meta):
            return "t-ranged"

        def start_stream_task(self, req, timeout=None):
            calls["p2p"] += 1
            raise RuntimeError("origin does not support ranges: x")

    t = transport.P2PTransport(TM(), rules=[transport.ProxyRule(regex=".*")])

    class _Direct:
        status = 206
        headers = {}
        body = iter(())
        content_length = 0
        via_p2p = False
        task_id = ""

    t._direct = lambda *a, **k: _Direct()
    t.round_trip("http://o/x.bin", headers={"Range": "bytes=0-9"})
    t.round_trip("http://o/x.bin", headers={"Range": "bytes=0-9"})
    t.round_trip("http://o/x.bin", headers={"Range": "bytes=10-19"})
    return calls["p2p"]


def test_range_refusing_origin_is_negatively_cached(tmp_path):
    """An origin without Accept-Ranges pays the P2P register→fail cycle
    ONCE; subsequent ranged requests go direct off the negative cache."""
    assert _negative_cache_calls(t_transport) == 1  # one failure, then the negative cache
    assert _negative_cache_calls(j_transport) == 1


def _layer_demand(proxy_mod, transport_mod, task_id_for):
    class _TM:
        def task_id_for(self, url, url_meta):
            return task_id_for(url, url_meta.tag)

    t = transport_mod.P2PTransport(
        _TM(), rules=[transport_mod.ProxyRule(regex=r"/v2/")], default_tag="reg"
    )
    proxy = proxy_mod.ProxyServer(t, port=0)
    seen = []
    proxy.on_layer_demand = (
        lambda digest, url, task_id="", meta=None: seen.append(
            (digest, url, task_id, meta)
        )
    )
    url = "http://r/v2/lib/img/blobs/sha256:00ff"
    ok = transport_mod.TransportResult(status=200, headers={}, body=iter(()))
    try:
        proxy._note_layer_demand(url, dataclasses.replace(ok, via_p2p=True))
        proxy._note_layer_demand(url, dataclasses.replace(ok, status=404))
        proxy._note_layer_demand(url, dataclasses.replace(ok, status=502))
        proxy._note_layer_demand(url, ok, head=True)  # HEAD is a probe
        proxy._note_layer_demand("http://r/v2/lib/img/manifests/latest", ok)
        proxy._note_layer_demand(url, ok)  # the one real demand signal
    finally:
        proxy._server.server_close()
    return url, seen


def test_layer_demand_signal_gates_and_carries_swarm_identity():
    """The preheat demand signal fires only for successful (2xx) blob
    GETs that did NOT ride P2P — a P2P ride lands a DownloadRecord at
    the scheduler and folds there; emitting both would double-count one
    pull — and it carries the swarm identity (task id + tag) a demanding
    client computes, so preheat seeds the task clients actually join."""
    from dragonfly2_tpu.utils import idgen as j_idgen

    url, seen = _layer_demand(t_proxy, t_transport,
                              lambda u, tag: task_id_v1(u, URLMeta(tag=tag)))
    assert seen == [
        ("sha256:00ff", url, task_id_v1(url, URLMeta(tag="reg")), {"tag": "reg"})
    ]
    _, seen_ref = _layer_demand(j_proxy, j_transport,
                                lambda u, tag: j_idgen.task_id_v1(u, j_idgen.URLMeta(tag=tag)))
    assert seen == seen_ref


def test_p2p_refusal_names_its_cause(proxy_cluster, monkeypatch):
    """A swarm failure behind the proxy must not be swallowed silently:
    the pull degrades to a direct origin fetch (correct bytes, 200) AND
    the cause lands in a daemon.proxy_fallback flight event an operator
    can read off /debug/ring."""
    da = proxy_cluster["daemons"][0]
    url = proxy_cluster["origin"] + "/blob.bin"

    def boom(*a, **kw):
        raise RuntimeError("swarm refused by test")

    monkeypatch.setattr(da.proxy.transport, "_via_p2p", boom)
    body, headers = _proxy_get(da.proxy.port, url)
    assert body == BLOB
    assert headers["X-Dragonfly-Via-P2P"] == "0"

    events = [
        e
        for e in t_flight.snapshot(["daemon"]).get("daemon", [])
        if e["type"] == "daemon.proxy_fallback"
        and "swarm refused by test" in e.get("cause", "")
    ]
    assert events, "fallback left no daemon.proxy_fallback flight event"
    assert events[-1]["url"].endswith("/blob.bin")
    assert events[-1]["task_id"] == task_id_v1(url)


def test_fallback_propagates_origin_4xx(proxy_cluster, monkeypatch):
    """When the swarm leg fails AND the origin says 404, the client must
    see the origin's answer — not a 502 masking it."""
    da = proxy_cluster["daemons"][0]
    # missing path that still matches the P2P rule, so the swarm is tried
    url = proxy_cluster["origin"] + "/nope/blob.bin"

    def boom(*a, **kw):
        raise RuntimeError("no peers")

    monkeypatch.setattr(da.proxy.transport, "_via_p2p", boom)
    req = urllib.request.Request(url)
    req.set_proxy(f"127.0.0.1:{da.proxy.port}", "http")
    with pytest.raises(urllib.error.HTTPError) as exc_info:
        urllib.request.urlopen(req, timeout=10)
    assert exc_info.value.code == 404


def test_proxy_pull_fault_injection_returns_502(proxy_cluster):
    """DF_FAULTS on daemon.proxy_pull turns every proxied GET into a
    deterministic 502 — the chaos hook for registry-path drills."""
    da = proxy_cluster["daemons"][0]
    url = proxy_cluster["origin"] + "/blob.bin"
    t_faults.configure("daemon.proxy_pull=error")
    try:
        req = urllib.request.Request(url)
        req.set_proxy(f"127.0.0.1:{da.proxy.port}", "http")
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(req, timeout=10)
        assert exc_info.value.code == 502
        assert b"proxy pull fault" in exc_info.value.read()
    finally:
        t_faults.clear()


def test_proxy_propagates_trace_context():
    """The proxy hop continues the caller's trace: the origin sees a
    traceparent with the SAME trace id but a fresh span id (the
    daemon.proxy_pull span's own context)."""
    seen = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen["traceparent"] = self.headers.get(t_tracing.TRACEPARENT_HEADER)
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    origin = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=origin.serve_forever, daemon=True).start()
    proxy = t_proxy.ProxyServer(P2PTransport(task_manager=None, rules=[]), port=0)
    proxy.start()
    incoming = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"
    try:
        url = f"http://127.0.0.1:{origin.server_address[1]}/x"
        req = urllib.request.Request(url, headers={"traceparent": incoming})
        req.set_proxy(f"127.0.0.1:{proxy.port}", "http")
        with urllib.request.urlopen(req, timeout=10) as resp:
            assert resp.read() == b"ok"
    finally:
        proxy.stop()
        origin.shutdown()
        origin.server_close()
    tp = seen["traceparent"]
    assert tp and tp != incoming
    assert tp.split("-")[1] == "ab" * 16  # trace id preserved
    assert tp.split("-")[2] != "cd" * 8  # new span for the proxy hop


# ---------------------------------------------------------------------------
# the two HTTPS MITM cases of the reference's tests/test_security.py
# ---------------------------------------------------------------------------


def _https_origin(tmp_path, handler, monkeypatch):
    """An HTTPS origin with a cert from its own CA, trusted by the
    proxy's upstream fetches through DF_ORIGIN_CA → (server, port)."""
    origin_ca = CertificateAuthority("origin CA")
    opair = origin_ca.issue("127.0.0.1", hosts=["127.0.0.1"])
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    httpd.daemon_threads = True
    octx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    (tmp_path / "o.crt").write_bytes(opair.cert_pem)
    (tmp_path / "o.key").write_bytes(opair.key_pem)
    octx.load_cert_chain(str(tmp_path / "o.crt"), str(tmp_path / "o.key"))
    httpd.socket = octx.wrap_socket(httpd.socket, server_side=True)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    (tmp_path / "oca.crt").write_bytes(origin_ca.cert_pem)
    monkeypatch.setenv("DF_ORIGIN_CA", str(tmp_path / "oca.crt"))
    return httpd, httpd.server_address[1]


def test_proxy_mitm_intercepts_https(tmp_path, monkeypatch):
    """An HTTPS origin behind the MITM proxy: the client CONNECTs, gets
    the spoofed cert (trusting the proxy CA), and the decrypted GET is
    served through the P2P transport (direct route here) with correct
    bytes."""
    payload = random.Random(3).randbytes(48 * 1024)

    class Origin(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            self.wfile.write(payload)

    httpd, origin_port = _https_origin(tmp_path, Origin, monkeypatch)
    # MITM proxy with its own spoofing CA
    proxy_ca = CertificateAuthority("proxy CA")
    proxy = t_proxy.ProxyServer(
        P2PTransport(None, rules=[]),  # no rules -> direct route
        issuer=SpoofingIssuer(proxy_ca),
    )
    proxy.start()
    try:
        # client trusts the PROXY CA (the spoofed leaf must verify)
        proxy_ca_file = tmp_path / "proxy-ca.crt"
        proxy_ca_file.write_bytes(proxy_ca.cert_pem)
        client_ctx = ssl.create_default_context(cafile=str(proxy_ca_file))
        opener = urllib.request.build_opener(
            urllib.request.ProxyHandler(
                {"https": f"http://127.0.0.1:{proxy.port}"}
            ),
            urllib.request.HTTPSHandler(context=client_ctx),
        )
        with opener.open(
            f"https://127.0.0.1:{origin_port}/blob/layer1", timeout=15
        ) as resp:
            body = resp.read()
            assert resp.headers.get("X-Dragonfly-Via-P2P") is not None
        assert body == payload
    finally:
        proxy.stop()
        httpd.shutdown()
        httpd.server_close()


def test_mitm_forwards_non_get_methods(tmp_path, monkeypatch):
    """docker-push-style POST through an intercepted host must reach the
    origin, not die with 501."""
    got = {}

    class Origin(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            got["body"] = self.rfile.read(n)
            got["path"] = self.path
            self.send_response(202)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

    httpd, origin_port = _https_origin(tmp_path, Origin, monkeypatch)
    proxy_ca = CertificateAuthority("proxy CA")
    proxy = t_proxy.ProxyServer(P2PTransport(None, rules=[]), issuer=SpoofingIssuer(proxy_ca))
    proxy.start()
    conn = None
    try:
        (tmp_path / "pca.crt").write_bytes(proxy_ca.cert_pem)
        ctx = ssl.create_default_context(cafile=str(tmp_path / "pca.crt"))
        opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({"https": f"http://127.0.0.1:{proxy.port}"}),
            urllib.request.HTTPSHandler(context=ctx),
        )
        req = urllib.request.Request(
            f"https://127.0.0.1:{origin_port}/v2/blobs/uploads/",
            data=b"layerdata",
            method="POST",
        )
        with opener.open(req, timeout=15) as resp:
            assert resp.status == 202
            assert resp.read() == b"ok"
        assert got["body"] == b"layerdata"
        assert got["path"] == "/v2/blobs/uploads/"

        # chunked upload (docker PATCH blob): decoded and forwarded
        # whole, keep-alive stays in sync for the follow-up request
        conn = http.client.HTTPSConnection(
            "127.0.0.1", origin_port, context=ctx, timeout=15
        )
        conn.host, conn.port = "127.0.0.1", proxy.port  # CONNECT via proxy
        conn.set_tunnel("127.0.0.1", origin_port)
        conn.request(
            "POST", "/v2/blobs/uploads/", body=iter([b"chun", b"ked-", b"body"])
        )  # http.client sends iterables chunked
        r = conn.getresponse()
        assert r.status == 202 and r.read() == b"ok"
        assert got["body"] == b"chunked-body"
        # same tunnel, next request — desync would garble this one
        conn.request("POST", "/v2/blobs/uploads/", body=b"second")
        r = conn.getresponse()
        assert r.status == 202 and r.read() == b"ok"
        assert got["body"] == b"second"
    finally:
        if conn is not None:
            conn.close()
        proxy.stop()
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# the transport's in-flight bound (the reference's tests/test_data_plane.py)
# ---------------------------------------------------------------------------


def test_transport_sheds_to_direct_at_inflight_bound(tmp_path):
    origin = tmp_path / "blob.bin"
    origin.write_bytes(b"direct-bytes")
    url = f"file://{origin}"
    started = threading.Event()
    release = threading.Event()

    class _NoStore:
        @staticmethod
        def find_completed_task(task_id):
            return None

    class SlowTM:
        storage = _NoStore()

        def task_id_for(self, url, url_meta):
            return "tid"

        def start_stream_task(self, req, timeout=None):
            started.set()

            def body():
                release.wait(10)
                yield b"p2p-bytes"

            return "tid", "pid", 9, {}, body()

    tr = P2PTransport(
        SlowTM(), rules=[ProxyRule(regex="file://")], max_inflight=1
    )
    first = tr.round_trip(url)
    assert first.via_p2p
    before = t_metrics.P2P_INFLIGHT_SHED_TOTAL.value
    # slot is held until FIRST's body is consumed → second sheds direct
    second = tr.round_trip(url)
    assert not second.via_p2p
    assert second.read_all() == b"direct-bytes"
    assert t_metrics.P2P_INFLIGHT_SHED_TOTAL.value == before + 1
    release.set()
    assert first.read_all() == b"p2p-bytes"
    # slot released on exhaustion: P2P again
    third = tr.round_trip(url)
    assert third.via_p2p


def test_inflight_bound_reads_its_environment_default(monkeypatch):
    """``DF_P2P_MAX_INFLIGHT`` sets the bound when none is given, 0 lifts
    it, and the daemon hands ``p2p_max_inflight`` to its transport — as
    the reference does."""
    for transport in (t_transport, j_transport):
        monkeypatch.setenv("DF_P2P_MAX_INFLIGHT", "3")
        sem = transport.P2PTransport(None)._inflight
        assert isinstance(sem, threading.BoundedSemaphore) and sem._value == 3
        monkeypatch.setenv("DF_P2P_MAX_INFLIGHT", "0")
        assert transport.P2PTransport(None)._inflight is None
        assert transport.P2PTransport(None, max_inflight=2)._inflight._value == 2


# ---------------------------------------------------------------------------
# the port's proxy against the reference's
# ---------------------------------------------------------------------------

# (daemon, method, path, request headers, the scheduler's download records
# once the request's task has finished): A back to source, B from A, a
# direct pass-through, a 404, a ranged task on each, the suffix and
# If-Range forms (direct), a HEAD (direct) and 'bytes=0-' (B's whole
# object, from its own store)
_SEQUENCE = (
    ("a", "GET", "/blob.bin", {}, 1),
    ("b", "GET", "/blob.bin", {}, 2),
    ("a", "GET", "/manifest.json", {}, 2),
    ("a", "GET", "/missing.json", {}, 2),
    ("a", "GET", "/blob.bin", {"Range": "bytes=100-4095"}, 3),
    ("b", "GET", "/blob.bin", {"Range": "bytes=100-4095"}, 4),
    ("a", "GET", "/blob.bin", {"Range": "bytes=-100"}, 4),
    ("a", "GET", "/blob.bin", {"Range": "bytes=0-99", "If-Range": '"etag"'}, 4),
    ("b", "HEAD", "/blob.bin", {}, 4),
    ("b", "GET", "/blob.bin", {"Range": "bytes=0-"}, 4),
)


def _drive(cluster: _Cluster) -> "tuple[list, dict]":
    """Send ``_SEQUENCE`` through the cluster's proxies → (answers, the
    proxy's request counts by route over the sequence). Every answer
    keeps its status, body and headers but Date (the clock's)."""
    metrics = _PKGS[cluster.pkg][1]
    before = {r: metrics.PROXY_REQUEST_TOTAL.labels(r).value for r in ("p2p", "direct")}
    answers = []
    for who, method, path, headers, records in _SEQUENCE:
        d = cluster.daemons[0 if who == "a" else 1]
        conn = http.client.HTTPConnection("127.0.0.1", d.proxy.port, timeout=30)
        try:
            conn.request(method, cluster.origin + path, headers=headers)
            resp = conn.getresponse()
            body = resp.read()
            seen = {k: v for k, v in resp.getheaders() if k != "Date"}
        finally:
            conn.close()
        answers.append((who, method, path, resp.status, seen, body))
        if seen.get("X-Dragonfly-Via-P2P") == "1":
            # the task's finish reaches the scheduler before the next
            # daemon asks for it, in both clusters alike
            _wait_completed(d.storage, seen["X-Dragonfly-Task-Id"])
            cluster.wait_records(records)
    after = {r: metrics.PROXY_REQUEST_TOTAL.labels(r).value for r in ("p2p", "direct")}
    return answers, {r: after[r] - before[r] for r in after}


def test_proxy_answers_match_the_reference(tmp_path, origin_server):
    """The same requests through the port's proxy cluster and through the
    reference's, on one seeded origin: every status, header the proxy
    sends (its own ``X-Dragonfly-*`` and those it forwards or derives),
    body and the request counts by route are equal."""
    results = {}
    for pkg in ("torch", "jax"):
        cluster = _Cluster(pkg, tmp_path / pkg, origin_server)
        try:
            results[pkg] = _drive(cluster)
        finally:
            cluster.stop()
    (t_answers, t_routes), (j_answers, j_routes) = results["torch"], results["jax"]
    assert t_answers == j_answers
    assert t_routes == j_routes == {"p2p": 5, "direct": 5}
    assert [a[3] for a in t_answers] == [200, 200, 200, 404, 206, 206, 206, 206, 200, 200]
    assert [a[4].get("X-Dragonfly-Via-P2P") for a in t_answers] == list("1100110001")
    blob = t_answers[1]
    assert blob[5] == BLOB and blob[4]["X-Dragonfly-Task-Id"] == task_id_v1(origin_server + "/blob.bin")
    assert t_answers[5][5] == BLOB[100:4096] and t_answers[9][5] == BLOB


@pytest.mark.parametrize("rule,default_tag", [
    ({"regex": r"/v2/.*/blobs/"}, ""),
    ({"regex": r"/v2/.*/blobs/"}, "registry"),
    ({"regex": r"/v2/", "use_https": True}, ""),
    ({"regex": r"http://r\.example", "redirect": "http://mirror.example"}, "m"),
    ({"regex": r"/v2/", "direct": True}, ""),
])
def test_p2p_task_context_matches_the_reference(tmp_path, rule, default_tag):
    """The swarm identity a preheat must reproduce — (task id, target,
    tag), or None where the request goes direct — is the reference's for
    every rule form, on real task managers of both packages."""
    from dragonfly2_tpu.client.peertask import TaskManager as JTaskManager
    from dragonfly2_torch.client.peertask import TaskManager as TTaskManager

    def manager(cls):
        return cls(host_id="h", storage=None, scheduler_client=None, piece_manager=object())

    urls = [
        "http://r.example/v2/lib/img/blobs/sha256:" + "0f" * 32,
        "http://r.example/v2/lib/img/manifests/v1",
        "http://other.example/file.bin?x=1",
    ]
    got = {}
    for pkg, transport, cls in (("torch", t_transport, TTaskManager), ("jax", j_transport, JTaskManager)):
        t = transport.P2PTransport(manager(cls), rules=[transport.ProxyRule(**rule)],
                                   default_tag=default_tag)
        got[pkg] = [t.p2p_task_context(u) for u in urls]
    assert got["torch"] == got["jax"]
    if rule.get("direct"):
        assert got["torch"] == [None, None, None]
    else:
        assert got["torch"][0] is not None and got["torch"][0][2] == default_tag
        assert got["torch"][2] is None  # no rule matches: no swarm


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_daemon_keeps_its_mitm_ca_under_data_dir(tmp_path, pkg):
    """``proxy_mitm`` keeps the CA at ``<data_dir>/ca/`` (the key created
    with mode 0600) and loads the same CA when the daemon starts again —
    the reference's layout, so either daemon reads the other's CA."""
    daemon = _PKGS[pkg][0]
    d = daemon.Daemon(daemon.DaemonConfig(
        data_dir=str(tmp_path / "d"), scheduler_address="127.0.0.1:1", hostname="mitm-host",
    ))
    try:
        issuer = d._load_spoofing_issuer()
        crt, key = tmp_path / "d" / "ca" / "ca.crt", tmp_path / "d" / "ca" / "ca.key"
        assert stat.S_IMODE(os.stat(key).st_mode) == 0o600
        first = crt.read_bytes()
        assert issuer.ca.cert_pem == first
        # the other package's daemon loads the same CA from the same dir
        other = _PKGS["jax" if pkg == "torch" else "torch"][0]
        again = other.Daemon(other.DaemonConfig(
            data_dir=str(tmp_path / "d"), scheduler_address="127.0.0.1:1", hostname="mitm-host",
        ))
        try:
            assert again._load_spoofing_issuer().ca.cert_pem == first == crt.read_bytes()
        finally:
            again.upload.stop()
    finally:
        d.upload.stop()


def test_daemon_serves_its_proxy_and_stops_it(tmp_path, origin_server):
    """``Daemon(DaemonConfig(..., proxy_port=0)).start()`` serves the proxy
    with the config's rules and in-flight bound; ``stop`` closes it."""
    cluster = _Cluster("torch", tmp_path, origin_server)
    try:
        da = cluster.daemons[0]
        assert da.proxy.port > 0 and da.proxy.transport.tasks is da.task_manager
        assert da.proxy.transport._inflight._value == DaemonConfig(data_dir="", scheduler_address="").p2p_max_inflight
        assert [r.regex for r in da.proxy.transport.rules] == [r"blob\.bin"]
        assert da.proxy.plane == da.proxy.transport.plane == "image"
        body, _ = _proxy_get(da.proxy.port, origin_server + "/manifest.json")
        assert body == b'{"layers": []}'
        port = da.proxy.port
    finally:
        cluster.stop()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
    try:
        with pytest.raises(OSError):
            conn.request("GET", origin_server + "/manifest.json")
            conn.getresponse()
    finally:
        conn.close()


def test_daemon_without_proxy_port_serves_none(tmp_path):
    d = Daemon(DaemonConfig(data_dir=str(tmp_path / "d"), scheduler_address="127.0.0.1:1"))
    try:
        assert d.proxy is None and d.cfg.proxy_port == -1
    finally:
        d.upload.stop()
