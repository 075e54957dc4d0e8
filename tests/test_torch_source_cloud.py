"""The reference's ``tests/test_source_cloud.py``, case for case, on the
port's cloud back-to-source clients (``dragonfly2_torch.client.source_cloud``
behind ``source.client_for``): s3 (SigV4), oss (header HMAC), WebHDFS and
oras against in-process fake services, and dfget back to source through
the fake S3 on a port scheduler and daemon.

Then parity: both packages' clients against one fake per scheme give the
same ``Metadata``, bytes, list entries and ``SourceError`` text, and with
one fixed clock patched into both packages' signers they send byte-equal
requests (every header, the SigV4 and OSS ``Authorization`` among them).
Every server listens on port 0 and is stopped in its fixture or a
``finally``."""

from __future__ import annotations

import base64
import dataclasses
import datetime
import hashlib
import hmac
import json
import os
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest
import torch

from dragonfly2_torch.client import source
from dragonfly2_torch.client import source_cloud as t_cloud
from dragonfly2_torch.client.source import SourceError
from dragonfly2_torch.utils import awssig as t_awssig
from dragonfly2_tpu.client import source as j_source
from dragonfly2_tpu.client import source_cloud as j_cloud
from dragonfly2_tpu.utils import awssig as j_awssig

torch.set_num_threads(1)

# each package's source module and its SourceError
_PKGS = {"torch": (source, SourceError), "jax": (j_source, j_source.SourceError)}


def _serve(handler) -> ThreadingHTTPServer:
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _stop(httpd: ThreadingHTTPServer) -> None:
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture
def fake_s3(monkeypatch):
    """Minimal S3 REST fake: path-style GET/HEAD with Range, ListObjectsV2,
    and SigV4 verification of the Authorization header shape. Every
    request's method, path and headers are kept in order."""
    objects = {
        ("bkt", "data/blob.bin"): os.urandom(96 * 1024),
        ("bkt", "data/a.txt"): b"alpha",
        ("bkt", "data/sub/b.txt"): b"beta",
    }
    seen = {"auth": None}
    requests = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _obj(self):
            requests.append((self.command, self.path, dict(self.headers.items())))
            parts = urllib.parse.urlsplit(self.path)
            segs = parts.path.lstrip("/").split("/", 1)
            bucket = segs[0]
            key = urllib.parse.unquote(segs[1]) if len(segs) > 1 else ""
            return bucket, key, urllib.parse.parse_qs(parts.query)

        def do_HEAD(self):
            bucket, key, _ = self._obj()
            body = objects.get((bucket, key))
            if body is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()

        def do_GET(self):
            seen["auth"] = self.headers.get("Authorization", "")
            bucket, key, q = self._obj()
            if "list-type" in q:
                prefix = q.get("prefix", [""])[0]
                keys = sorted(
                    k for (b, k) in objects if b == bucket and k.startswith(prefix)
                )
                contents = "".join(f"<Contents><Key>{k}</Key></Contents>" for k in keys)
                xml = f"<ListBucketResult>{contents}</ListBucketResult>".encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(xml)))
                self.end_headers()
                self.wfile.write(xml)
                return
            body = objects.get((bucket, key))
            if body is None:
                self.send_error(404)
                return
            rng = self.headers.get("Range")
            status = 200
            if rng:
                spec = rng.split("=", 1)[1]
                start_s, _, end_s = spec.partition("-")
                start = int(start_s)
                end = int(end_s) if end_s else len(body) - 1
                body = body[start : end + 1]
                status = 206
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = _serve(Handler)
    monkeypatch.setenv("DF_S3_ENDPOINT", f"http://127.0.0.1:{httpd.server_port}")
    monkeypatch.setenv("DF_S3_ACCESS_KEY", "AKIATEST")
    monkeypatch.setenv("DF_S3_SECRET_KEY", "secret")
    monkeypatch.setenv("DF_S3_REGION", "us-test-1")
    yield {"objects": objects, "seen": seen, "requests": requests}
    _stop(httpd)


def test_s3_metadata_download_and_range(fake_s3):
    client = source.client_for("s3://bkt/data/blob.bin")
    meta = client.metadata("s3://bkt/data/blob.bin")
    body = fake_s3["objects"][("bkt", "data/blob.bin")]
    assert meta.content_length == len(body)
    assert meta.support_range

    got = b"".join(client.download("s3://bkt/data/blob.bin"))
    assert got == body

    part = b"".join(client.download("s3://bkt/data/blob.bin", offset=1024, length=4096))
    assert part == body[1024 : 1024 + 4096]

    auth = fake_s3["seen"]["auth"]
    assert auth.startswith("AWS4-HMAC-SHA256 Credential=AKIATEST/")
    assert "us-test-1/s3/aws4_request" in auth
    assert "Signature=" in auth


def test_s3_list(fake_s3):
    client = source.client_for("s3://bkt/data")
    entries = client.list("s3://bkt/data")
    names = sorted(e.name for e in entries)
    assert "a.txt" in names and "blob.bin" in names


def test_s3_missing_credentials(monkeypatch):
    for var in ("DF_S3_ACCESS_KEY", "DF_S3_SECRET_KEY", "DF_S3_ENDPOINT"):
        monkeypatch.delenv(var, raising=False)
    client = source.client_for("s3://bkt/k")
    with pytest.raises(SourceError, match="credentials missing"):
        client.metadata("s3://bkt/k")


def _oss_handler(payload: bytes, seen: dict, requests: list):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_HEAD(self):
            requests.append((self.command, self.path, dict(self.headers.items())))
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()

        def do_GET(self):
            requests.append((self.command, self.path, dict(self.headers.items())))
            seen["auth"] = self.headers.get("Authorization", "")
            seen["date"] = self.headers.get("Date", "")
            if self.path.endswith("/missing.bin"):
                self.send_error(404)
                return
            body, status = payload, 200
            rng = self.headers.get("Range")
            if rng:
                lo, _, hi = rng.removeprefix("bytes=").partition("-")
                body, status = payload[int(lo) : (int(hi) + 1) if hi else len(payload)], 206
            self.send_response(status)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def test_oss_download_with_signature(monkeypatch):
    payload = os.urandom(8 * 1024)
    seen = {}

    httpd = _serve(_oss_handler(payload, seen, []))
    try:
        monkeypatch.setenv("DF_OSS_ENDPOINT", f"http://127.0.0.1:{httpd.server_port}")
        monkeypatch.setenv("DF_OSS_ACCESS_KEY", "osskey")
        monkeypatch.setenv("DF_OSS_SECRET_KEY", "osssecret")
        client = source.client_for("oss://bkt/obj.bin")
        got = b"".join(client.download("oss://bkt/obj.bin"))
        assert got == payload
        # verify the classic OSS signature against what we'd compute
        to_sign = f"GET\n\n\n{seen['date']}\n/bkt/obj.bin"
        want = base64.b64encode(
            hmac.new(b"osssecret", to_sign.encode(), hashlib.sha1).digest()
        ).decode()
        assert seen["auth"] == f"OSS osskey:{want}"
    finally:
        _stop(httpd)


def _hdfs_handler(payload: bytes):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            parts = urllib.parse.urlsplit(self.path)
            q = urllib.parse.parse_qs(parts.query)
            if "missing" in parts.path:
                self.send_error(404)
                return
            op = q["op"][0]
            if op == "GETFILESTATUS":
                body = json.dumps(
                    {"FileStatus": {"length": len(payload), "type": "FILE",
                                    "modificationTime": 1700000000000}}
                ).encode()
            elif op == "OPEN":
                off = int(q.get("offset", ["0"])[0])
                ln = int(q.get("length", [str(len(payload))])[0])
                body = payload[off : off + ln]
            elif op == "LISTSTATUS":
                body = json.dumps(
                    {"FileStatuses": {"FileStatus": [
                        {"pathSuffix": "x.bin", "type": "FILE", "length": 3},
                        {"pathSuffix": "sub", "type": "DIRECTORY", "length": 0},
                    ]}}
                ).encode()
            else:
                self.send_error(400)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def test_hdfs_webhdfs_roundtrip():
    payload = os.urandom(16 * 1024)

    httpd = _serve(_hdfs_handler(payload))
    try:
        base = f"hdfs://127.0.0.1:{httpd.server_port}/data/file.bin"
        client = source.client_for(base)
        meta = client.metadata(base)
        assert meta.content_length == len(payload)
        got = b"".join(client.download(base))
        assert got == payload
        part = b"".join(client.download(base, offset=100, length=200))
        assert part == payload[100:300]
        entries = client.list(f"hdfs://127.0.0.1:{httpd.server_port}/data")
        assert {e.name: e.is_dir for e in entries} == {"x.bin": False, "sub": True}
    finally:
        _stop(httpd)


@pytest.fixture
def fake_registry(monkeypatch):
    """OCI registry fake: bearer token service, manifest endpoint, blob
    endpoint with Range — the surface the oras client speaks
    (upstream pkg/source/clients/orasprotocol)."""
    blob = os.urandom(48 * 1024)
    digest = "sha256:" + hashlib.sha256(blob).hexdigest()
    manifest = json.dumps(
        {
            "schemaVersion": 2,
            "mediaType": "application/vnd.oci.image.manifest.v1+json",
            "layers": [
                {
                    "mediaType": "application/vnd.oci.image.layer.v1.tar",
                    "digest": digest,
                    "size": len(blob),
                }
            ],
        }
    ).encode()
    seen = {"token_auth": None, "blob_auth": None}
    requests = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_HEAD(self):
            requests.append((self.command, self.path, dict(self.headers.items())))
            parts = urllib.parse.urlsplit(self.path)
            if parts.path == f"/v2/org/artifact/blobs/{digest}":
                self.send_response(200)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
            else:
                self.send_error(404)

        def do_GET(self):
            requests.append((self.command, self.path, dict(self.headers.items())))
            parts = urllib.parse.urlsplit(self.path)
            if parts.path == "/service/token":
                seen["token_auth"] = self.headers.get("Authorization")
                body = json.dumps({"token": "tok-123"}).encode()
                self.send_response(200)
            elif parts.path == "/v2/org/artifact/manifests/v1":
                if self.headers.get("Authorization") != "Bearer tok-123":
                    self.send_error(401)
                    return
                body = manifest
                self.send_response(200)
            elif parts.path == "/v2/org/empty/manifests/v1":
                body = json.dumps({"schemaVersion": 2, "layers": []}).encode()
                self.send_response(200)
            elif parts.path == f"/v2/org/artifact/blobs/{digest}":
                seen["blob_auth"] = self.headers.get("Authorization")
                if self.headers.get("Authorization") != "Bearer tok-123":
                    self.send_error(401)
                    return
                rng = self.headers.get("Range")
                body = blob
                if rng:
                    lo, _, hi = rng.removeprefix("bytes=").partition("-")
                    body = blob[int(lo) : (int(hi) + 1) if hi else len(blob)]
                    self.send_response(206)
                else:
                    self.send_response(200)
            else:
                self.send_error(404)
                return
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = _serve(Handler)
    monkeypatch.setenv("DF_ORAS_ENDPOINT", f"http://127.0.0.1:{httpd.server_port}")
    yield {"blob": blob, "digest": digest, "seen": seen, "requests": requests}
    _stop(httpd)


def test_oras_metadata_and_download(fake_registry):
    url = "oras://registry.example/org/artifact:v1"
    client = source.client_for(url)
    meta = client.metadata(url)
    assert meta.content_length == len(fake_registry["blob"])
    assert meta.etag == fake_registry["digest"]
    got = b"".join(client.download(url))
    assert got == fake_registry["blob"]
    part = b"".join(client.download(url, offset=64, length=128))
    assert part == fake_registry["blob"][64:192]


def test_oras_metadata_digest_query_uses_head(fake_registry):
    """With the digest supplied, size discovery is a blob HEAD — no
    manifest fetch, no body transfer."""
    url = f"oras://registry.example/org/artifact:v1?digest={fake_registry['digest']}"
    meta = source.client_for(url).metadata(url)
    assert meta.content_length == len(fake_registry["blob"])


def test_oras_basic_auth_forwarded_to_token_service(fake_registry):
    url = "oras://registry.example/org/artifact:v1"
    creds = "Basic " + base64.b64encode(b"user:pass").decode()
    b"".join(source.client_for(url).download(url, headers={"Authorization": creds}))
    assert fake_registry["seen"]["token_auth"] == creds


def test_oras_digest_token_fast_path(fake_registry):
    """digest query + token header → no token-service or manifest hops
    (upstream's goto-fetch shortcut)."""
    url = f"oras://registry.example/org/artifact:v1?digest={fake_registry['digest']}"
    got = b"".join(
        source.client_for(url).download(
            url, headers={"X-Dragonfly-Oras-Token": "tok-123"}
        )
    )
    assert got == fake_registry["blob"]
    assert fake_registry["seen"]["token_auth"] is None  # token service never hit


def test_oras_malformed_urls():
    client = source.client_for("oras://h/r:t")
    with pytest.raises(SourceError, match="tag"):
        client.metadata("oras://host/repo-no-tag")


def test_dfget_back_to_source_via_fake_s3(fake_s3, tmp_path):
    """Full path: dfget → daemon → back-to-source s3 origin."""
    from dragonfly2_torch.client import dfget
    from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_torch.rpc.glue import serve
    from dragonfly2_torch.scheduler import resource as res
    from dragonfly2_torch.scheduler.evaluator import BaseEvaluator
    from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
    from dragonfly2_torch.scheduler.service import SERVICE_NAME, SchedulerService

    resource = res.Resource()
    service = SchedulerService(
        resource,
        Scheduling(
            BaseEvaluator(),
            SchedulingConfig(retry_interval=0.05, retry_back_to_source_limit=3),
        ),
    )
    server, port = serve({SERVICE_NAME: service})
    d = None
    try:
        d = Daemon(
            DaemonConfig(
                data_dir=str(tmp_path / "daemon"),
                scheduler_address=f"127.0.0.1:{port}",
                hostname="host-s3",
                piece_length=32 * 1024,
                announce_interval=60.0,
                collect_host_stats=False,
            )
        )
        d.start()
        out = tmp_path / "out.bin"
        dfget.download(f"127.0.0.1:{d.port}", "s3://bkt/data/blob.bin", str(out))
        assert out.read_bytes() == fake_s3["objects"][("bkt", "data/blob.bin")]
        # the back-to-source pieces are the origin's, fetched with SigV4
        assert any(m == "GET" and h.get("Authorization", "").startswith("AWS4-HMAC-SHA256 ")
                   for m, _, h in fake_s3["requests"])
    finally:
        if d is not None:
            d.stop()
        server.stop(0)


# ---------------------------------------------------------------------------
# parity with the reference's clients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme,cls", [
    ("s3", "S3SourceClient"), ("oss", "OSSSourceClient"),
    ("hdfs", "HDFSSourceClient"), ("oras", "ORASSourceClient"),
])
def test_client_for_returns_the_ports_own_clients(scheme, cls):
    """Each cloud scheme resolves to the port's client, registered once,
    never to the reference's."""
    client = source.client_for(f"{scheme}://bucket/key:tag")
    assert type(client) is getattr(t_cloud, cls)
    assert type(client).__module__ == "dragonfly2_torch.client.source_cloud"
    assert source.client_for(f"{scheme}://other/k:t") is client
    assert source._REGISTRY[scheme] is client


def _view(value):
    """A package-neutral view: dataclasses as dicts, lists elementwise."""
    if isinstance(value, list):
        return [_view(v) for v in value]
    if dataclasses.is_dataclass(value):
        return (type(value).__name__, dataclasses.asdict(value))
    return value


def _outcomes(pkg: str, calls) -> list:
    """Each call ``(url, method, kwargs)`` on the package's client for the
    url → its result (a view), or ``("SourceError", text)``."""
    src, error = _PKGS[pkg]
    out = []
    for url, method, kw in calls:
        client = src.client_for(url)
        try:
            res = getattr(client, method)(url, **kw)
            out.append(_view(b"".join(res) if method == "download" else res))
        except error as e:
            out.append(("SourceError", str(e)))
    return out


def _both(calls) -> list:
    got = {pkg: _outcomes(pkg, calls) for pkg in _PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_s3_client_matches_the_reference(fake_s3, monkeypatch):
    body = fake_s3["objects"][("bkt", "data/blob.bin")]
    got = _both([
        ("s3://bkt/data/blob.bin", "metadata", {}),
        ("s3://bkt/data/blob.bin", "download", {}),
        ("s3://bkt/data/blob.bin", "download", {"offset": 1024, "length": 4096}),
        ("s3://bkt/data/blob.bin", "download", {"offset": 90 * 1024}),
        ("s3://bkt/data", "list", {}),
        ("s3://bkt/data/sub/", "list", {}),
        ("s3://bkt/data/nope.bin", "metadata", {}),
        ("s3://bkt/data/nope.bin", "download", {}),
    ])
    assert got[0] == ("Metadata", {"content_length": len(body), "support_range": True,
                                   "last_modified": 0.0, "etag": "",
                                   "content_type": "application/octet-stream"})
    assert got[1] == body and got[2] == body[1024:5120] and got[3] == body[90 * 1024:]
    assert [e[1]["name"] for e in got[4]] == ["a.txt", "blob.bin", "sub/b.txt"]
    assert got[4][0][1]["url"] == "s3://bkt/data/a.txt"
    assert [e[1]["name"] for e in got[5]] == ["b.txt"]
    assert got[6] == ("SourceError", "s3 HEAD s3://bkt/data/nope.bin: HTTP 404 Not Found")
    assert got[7] == ("SourceError", "s3 GET s3://bkt/data/nope.bin: HTTP 404 Not Found")
    # the per-request header credentials win over the environment in both
    monkeypatch.delenv("DF_S3_ACCESS_KEY")
    hdrs = {"X-Dragonfly-S3-Access-Key": "AKIAHDR", "X-Dragonfly-S3-Secret-Key": "s"}
    got = _both([("s3://bkt/data/a.txt", "download", {"headers": hdrs}),
                 ("s3://bkt/data/a.txt", "download", {})])
    assert got[0] == b"alpha" and got[1][0] == "SourceError" and "credentials missing" in got[1][1]


def test_oss_client_matches_the_reference(monkeypatch):
    payload = os.urandom(8 * 1024)
    httpd = _serve(_oss_handler(payload, {}, []))
    try:
        monkeypatch.setenv("DF_OSS_ENDPOINT", f"http://127.0.0.1:{httpd.server_port}")
        monkeypatch.setenv("DF_OSS_ACCESS_KEY", "osskey")
        monkeypatch.setenv("DF_OSS_SECRET_KEY", "osssecret")
        got = _both([
            ("oss://bkt/obj.bin", "metadata", {}),
            ("oss://bkt/obj.bin", "download", {}),
            ("oss://bkt/obj.bin", "download", {"offset": 10, "length": 100}),
            ("oss://bkt/missing.bin", "download", {}),
            ("oss://bkt/", "list", {}),
        ])
        assert got[0][1]["content_length"] == len(payload) and got[0][1]["support_range"]
        assert got[1] == payload and got[2] == payload[10:110]
        assert got[3] == ("SourceError", "oss GET oss://bkt/missing.bin: HTTP 404 Not Found")
        assert got[4] == ("SourceError", "oss recursive listing is not implemented")
        monkeypatch.delenv("DF_OSS_ACCESS_KEY")
        got = _both([("oss://bkt/obj.bin", "metadata", {})])
        assert got[0][0] == "SourceError" and "oss credentials missing" in got[0][1]
    finally:
        _stop(httpd)


def test_hdfs_client_matches_the_reference(monkeypatch):
    payload = os.urandom(16 * 1024)
    httpd = _serve(_hdfs_handler(payload))
    try:
        base = f"hdfs://127.0.0.1:{httpd.server_port}"
        got = _both([
            (f"{base}/data/file.bin", "metadata", {}),
            (f"{base}/data/file.bin", "download", {}),
            (f"{base}/data/file.bin", "download", {"offset": 100, "length": 200}),
            (f"{base}/data", "list", {}),
            (f"{base}/data/missing.bin", "metadata", {}),
        ])
        assert got[0][1]["content_length"] == len(payload)
        assert got[0][1]["last_modified"] == 1700000000.0
        assert got[1] == payload and got[2] == payload[100:300]
        assert [(e[1]["name"], e[1]["is_dir"]) for e in got[3]] == [("x.bin", False), ("sub", True)]
        assert got[4] == ("SourceError", f"hdfs http://127.0.0.1:{httpd.server_port}"
                          "/webhdfs/v1/data/missing.bin?op=GETFILESTATUS: HTTP 404 Not Found")
        # the simple-auth user rides every WebHDFS call alike
        monkeypatch.setenv("DF_HDFS_USER", "df")
        assert _both([(f"{base}/data/file.bin", "download", {})]) == [payload]
    finally:
        _stop(httpd)


def test_oras_client_matches_the_reference(fake_registry):
    blob, digest = fake_registry["blob"], fake_registry["digest"]
    url = "oras://registry.example/org/artifact:v1"
    creds = "Basic " + base64.b64encode(b"user:pass").decode()
    requests = fake_registry["requests"]
    got = _both([
        (url, "metadata", {}),
        (f"{url}?digest={digest}", "metadata", {}),
        (url, "download", {}),
        (url, "download", {"offset": 64, "length": 128}),
        (url, "download", {"headers": {"Authorization": creds}}),
        (f"{url}?digest={digest}", "download", {"headers": {"X-Dragonfly-Oras-Token": "tok-123"}}),
        ("oras://registry.example/org/missing:v1", "metadata", {}),
        ("oras://registry.example/org/empty:v1", "metadata", {}),
        ("oras://host/repo-no-tag", "metadata", {}),
        ("oras://host/:v1", "metadata", {}),
        (url, "list", {}),
    ])
    assert got[0] == got[1] == ("Metadata", {"content_length": len(blob), "support_range": True,
                                             "last_modified": 0.0, "etag": digest,
                                             "content_type": "application/octet-stream"})
    assert got[2] == got[4] == got[5] == blob and got[3] == blob[64:192]
    assert got[6] == ("SourceError", f"GET {os.environ['DF_ORAS_ENDPOINT']}/v2/org/missing/manifests/v1: 404")
    assert got[7] == ("SourceError", "oras manifest for org/empty:v1 has no layer digest")
    assert got[8] == ("SourceError", "oras url needs a ':tag' suffix: oras://host/repo-no-tag")
    assert got[9] == ("SourceError", "malformed oras url: oras://host/:v1")
    assert got[10] == ("SourceError", "oras origin does not support recursive listing")
    # both packages walked the registry alike, request for request
    n = len(requests) // 2
    assert [(m, p, h) for m, p, h in requests[:n]] == [(m, p, h) for m, p, h in requests[n:]]


_FIXED = datetime.datetime(2026, 3, 4, 5, 6, 7, tzinfo=datetime.timezone.utc)


class _FixedClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return _FIXED


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both packages' signers (SigV4 in ``utils/awssig``, the OSS header in
    ``source_cloud``) read one fixed instant."""
    clock = SimpleNamespace(datetime=_FixedClock, timezone=datetime.timezone)
    for mod in (t_awssig, j_awssig, t_cloud, j_cloud):
        monkeypatch.setattr(mod, "datetime", clock)


@pytest.mark.parametrize("url,method,kw", [
    ("s3://bkt/data/blob.bin", "metadata", {}),
    ("s3://bkt/data/blob.bin", "download", {}),
    ("s3://bkt/data/blob.bin", "download", {"offset": 7, "length": 9}),
    ("s3://bkt/data/blob.bin", "download", {"offset": 4096}),
    ("s3://bkt/data", "list", {}),
    ("s3://bkt/data/a.txt", "download", {"headers": {"X-Dragonfly-S3-Region": "eu-x-2"}}),
])
def test_sigv4_requests_are_byte_equal_under_one_clock(fake_s3, fixed_clock, url, method, kw):
    requests = fake_s3["requests"]
    sent = {}
    for pkg in _PKGS:
        del requests[:]
        _outcomes(pkg, [(url, method, kw)])
        sent[pkg] = list(requests)
    assert sent["torch"] == sent["jax"] and len(sent["torch"]) == 1
    _, _, headers = sent["torch"][0]
    auth = headers["Authorization"]
    assert auth.startswith("AWS4-HMAC-SHA256 Credential=AKIATEST/20260304/")
    lower = {k.lower(): v for k, v in headers.items()}
    assert lower["x-amz-date"] == "20260304T050607Z"


@pytest.mark.parametrize("url,method,kw", [
    ("oss://bkt/obj.bin", "metadata", {}),
    ("oss://bkt/obj.bin", "download", {}),
    ("oss://bkt/dir/obj.bin", "download", {"offset": 5, "length": 50}),
])
def test_oss_requests_are_byte_equal_under_one_clock(monkeypatch, fixed_clock, url, method, kw):
    requests = []
    httpd = _serve(_oss_handler(os.urandom(1024), {}, requests))
    try:
        monkeypatch.setenv("DF_OSS_ENDPOINT", f"http://127.0.0.1:{httpd.server_port}")
        monkeypatch.setenv("DF_OSS_ACCESS_KEY", "osskey")
        monkeypatch.setenv("DF_OSS_SECRET_KEY", "osssecret")
        sent = {}
        for pkg in _PKGS:
            del requests[:]
            _outcomes(pkg, [(url, method, kw)])
            sent[pkg] = list(requests)
    finally:
        _stop(httpd)
    assert sent["torch"] == sent["jax"] and len(sent["torch"]) == 1
    m, path, headers = sent["torch"][0]
    assert headers["Date"] == "Wed, 04 Mar 2026 05:06:07 GMT"
    to_sign = f"{m}\n\n\n{headers['Date']}\n{urllib.parse.unquote(path)}"
    want = base64.b64encode(hmac.new(b"osssecret", to_sign.encode(), hashlib.sha1).digest()).decode()
    assert headers["Authorization"] == f"OSS osskey:{want}"
