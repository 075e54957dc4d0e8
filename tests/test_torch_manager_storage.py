"""The port's object storage, request signing and TTL cache against the
reference's on the same inputs.

- ``FSObjectStorage``: the same objects, listings, sizes and errors (a
  missing object, a key that escapes the root) on both sides.
- ``S3ObjectStorage`` against a fake S3 endpoint (the port's own copy of
  ``tests/test_s3_objectstorage.py``'s fixture) and ``OSSObjectStorage``
  against a fake OSS one: the same verbs give the same objects, listings
  and errors, and with the clock fixed every request carries the same
  headers, signature included, as the reference's.
- ``sigv4_headers`` and ``oss_sign_headers`` equal byte for byte for a
  fixed clock and fixed keys; ``sigv4_headers`` also against the AWS
  signing example's derived key.
- ``new_object_storage`` picks the same drivers; ``TTLCache`` expires,
  sweeps and lists alike."""

import datetime
import hashlib
import hmac
import http.server
import threading
import time
import urllib.error
import urllib.parse
from types import SimpleNamespace

import pytest
import torch

from dragonfly2_torch.manager import objectstorage as t_os
from dragonfly2_torch.utils import awssig as t_awssig
from dragonfly2_torch.utils import cache as t_cache
from dragonfly2_tpu.manager import objectstorage as j_os
from dragonfly2_tpu.utils import awssig as j_awssig
from dragonfly2_tpu.utils import cache as j_cache

torch.set_num_threads(1)

FIXED = datetime.datetime(2026, 3, 4, 5, 6, 7, tzinfo=datetime.timezone.utc)


class _FixedClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return FIXED


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both signers read one fixed instant."""
    clock = SimpleNamespace(datetime=_FixedClock, timezone=datetime.timezone)
    for mod in (t_awssig, j_awssig):
        monkeypatch.setattr(mod, "datetime", clock)
    monkeypatch.setattr("email.utils.formatdate", lambda *a, **k: "Wed, 04 Mar 2026 05:06:07 GMT")


def _fake_store(check_auth):
    """A minimal S3/OSS-style store: PUT/GET/HEAD/DELETE objects, PUT
    bucket (409 when it exists), a single-page listing with prefix
    (``list-type=2`` or plain). Every request's method, path and headers
    are kept in ``seen``; ``reset`` empties the store and ``seen``."""
    store: dict[tuple[str, str], bytes] = {}
    buckets: set[str] = set()
    seen: list = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _target(self):
            seen.append((self.command, self.path, sorted(
                (k.lower(), v) for k, v in self.headers.items() if k.lower() not in ("host", "connection"))))
            parts = urllib.parse.urlsplit(self.path)
            path = urllib.parse.unquote(parts.path).lstrip("/")
            bucket, _, key = path.partition("/")
            return bucket, key, dict(urllib.parse.parse_qsl(parts.query))

        def _reply(self, code, body=b"", length=True):
            self.send_response(code)
            if length:
                self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if body:
                self.wfile.write(body)

        def _authorized(self):
            if check_auth(self.headers.get("Authorization", "")):
                return True
            self._reply(403)
            return False

        def do_PUT(self):
            bucket, key, _ = self._target()
            if not self._authorized():
                return
            if not key:
                if bucket in buckets:
                    return self._reply(409)
                buckets.add(bucket)
            else:
                store[(bucket, key)] = self.rfile.read(int(self.headers.get("Content-Length") or 0))
            self._reply(200)

        def do_GET(self):
            bucket, key, q = self._target()
            if not self._authorized():
                return
            if not key:
                keys = sorted(k for (b, k) in store if b == bucket and k.startswith(q.get("prefix", "")))
                body = ("<ListBucketResult xmlns=\"http://s3.amazonaws.com/doc/2006-03-01/\">"
                        + "".join(f"<Contents><Key>{k}</Key></Contents>" for k in keys)
                        + "<IsTruncated>false</IsTruncated></ListBucketResult>").encode()
                return self._reply(200, body)
            data = store.get((bucket, key))
            if data is None:
                return self._reply(404)
            self._reply(200, data)

        def do_HEAD(self):
            bucket, key, _ = self._target()
            if not self._authorized():
                return
            data = store.get((bucket, key))
            self.send_response(404 if data is None else 200)
            if data is not None:
                self.send_header("Content-Length", str(len(data)))
            self.end_headers()

        def do_DELETE(self):
            bucket, key, _ = self._target()
            if not self._authorized():
                return
            if store.pop((bucket, key), None) is None:
                return self._reply(404)
            self._reply(204, length=False)

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    def reset():
        store.clear()
        buckets.clear()
        seen.clear()

    return httpd, {"endpoint": f"http://127.0.0.1:{httpd.server_port}", "store": store, "seen": seen,
                   "reset": reset}


@pytest.fixture
def fake_s3():
    """A fake S3 endpoint that accepts SigV4 requests from the key AKID."""
    httpd, info = _fake_store(lambda auth: auth.startswith("AWS4-HMAC-SHA256 Credential=AKID/"))
    yield info
    httpd.shutdown()


@pytest.fixture
def fake_oss():
    httpd, info = _fake_store(lambda auth: auth.startswith("OSS AKID:") or not auth)
    yield info
    httpd.shutdown()


def _on_one_endpoint(info, run):
    """``run(mod)`` for the port and then the reference against the same
    endpoint (a signature covers its host), emptied between them → each
    one's (result, requests seen)."""
    out = {}
    for name, mod in (("torch", t_os), ("jax", j_os)):
        info["reset"]()
        out[name] = (run(mod), list(info["seen"]))
    return out


def _outcome(fn):
    try:
        return ("ok", fn())
    except urllib.error.HTTPError as e:
        return ("http", e.code)
    except (FileNotFoundError, ValueError) as e:
        return (type(e).__name__, None)


def _script(st):
    """The same verbs on one storage → what each returned or raised."""
    out = []
    for step in (
        lambda: st.create_bucket("models"),
        lambda: st.create_bucket("models"),  # idempotent
        lambda: st.put_object("models", "mlp/1/model.npz", b"weights-bytes"),
        lambda: st.put_object("models", "mlp/2/model.npz", bytes(range(256)) * 9),
        lambda: st.put_object("models", "gnn/1/model npz+x", b"odd key"),
        lambda: st.put_object("models", "other/x", b""),
        lambda: st.head_object("models", "mlp/1/model.npz"),
        lambda: st.head_object("models", "missing"),
        lambda: st.stat_object("models", "mlp/2/model.npz"),
        lambda: st.stat_object("models", "missing"),
        lambda: st.get_object("models", "mlp/2/model.npz"),
        lambda: st.get_object("models", "gnn/1/model npz+x"),
        lambda: st.get_object("models", "missing"),
        lambda: st.list_objects("models"),
        lambda: st.list_objects("models", prefix="mlp/"),
        lambda: st.list_objects("models", prefix="nothing/"),
        lambda: st.delete_object("models", "mlp/1/model.npz"),
        lambda: st.delete_object("models", "mlp/1/model.npz"),  # idempotent
        lambda: st.list_objects("models"),
    ):
        out.append(_outcome(step))
    return out


def test_fs_storage_matches_the_reference(tmp_path):
    got = {name: mod.FSObjectStorage(tmp_path / name) for name, mod in (("torch", t_os), ("jax", j_os))}
    runs = {name: _script(st) for name, st in got.items()}
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][13][1] == ["gnn/1/model npz+x", "mlp/1/model.npz", "mlp/2/model.npz", "other/x"]
    for name, st in got.items():
        runs[name] = [_outcome(lambda: st.get_object("models", "../../escape")),
                      _outcome(lambda: st.put_object("x", "../../../escape", b"")),
                      st.list_buckets(), _outcome(lambda: st.delete_bucket("models")), st.list_buckets(),
                      st.list_objects("gone")]
    assert runs["torch"] == runs["jax"] == [("ValueError", None), ("ValueError", None), ["models"],
                                            ("ok", None), [], []]


def test_s3_storage_matches_the_reference(fake_s3, fixed_clock):
    def run(mod):
        st = mod.S3ObjectStorage(fake_s3["endpoint"], "AKID", "SECRET", region="eu-test-1")
        # the bucket of a non-default region carries its LocationConstraint
        return _script(st) + [st._create_bucket_body(), _outcome(
            lambda: mod.S3ObjectStorage(fake_s3["endpoint"], "NOPE", "S").get_object("models", "x"))]

    runs = _on_one_endpoint(fake_s3, run)
    (t_run, t_seen), (j_run, j_seen) = runs["torch"], runs["jax"]
    assert t_run == j_run
    assert t_run[14][1] == ["mlp/1/model.npz", "mlp/2/model.npz"] and t_run[-1] == ("http", 403)
    assert len(t_seen) == len(j_seen) == 20
    for a, b in zip(t_seen, j_seen):
        assert a == b  # method, path and every header, the signature included
    assert all(dict(h)["x-amz-date"] == "20260304T050607Z" for _, _, h in t_seen)


def test_oss_storage_matches_the_reference(fake_oss, fixed_clock):
    runs = _on_one_endpoint(fake_oss, lambda mod: _script(mod.OSSObjectStorage(fake_oss["endpoint"], "AKID", "SECRET")))
    (t_run, t_seen), (j_run, j_seen) = runs["torch"], runs["jax"]
    assert t_run == j_run and t_seen == j_seen
    assert all(dict(h)["authorization"].startswith("OSS AKID:") for _, _, h in t_seen)


def test_the_registry_runs_over_s3(fake_s3, tmp_path):
    from dragonfly2_torch.manager.database import Database
    from dragonfly2_torch.manager.models_registry import ModelRegistry

    db = Database(tmp_path / "m.db")
    reg = ModelRegistry(db, t_os.S3ObjectStorage(fake_s3["endpoint"], "AKID", "SECRET"))
    row = reg.create("mlp-model", "mlp", weights=b"\x01\x02\x03", evaluation={"mse": 0.5})
    assert (row.version, row.state) == (1, "inactive")
    assert reg.load_weights("mlp-model", 1) == b"\x01\x02\x03"
    assert fake_s3["store"][("models", "mlp-model/1/model.npz")] == b"\x01\x02\x03"
    db.close()


@pytest.mark.parametrize("case", [
    dict(method="GET", host="s3.amazonaws.com", path="/b/k", query="", region="us-east-1"),
    dict(method="PUT", host="127.0.0.1:9000", path="/models/mlp%2F1/model.npz", query="",
         region="eu-test-1", extra_headers={"Content-Type": "application/octet-stream", "X-Amz-Meta-A": "b"}),
    dict(method="GET", host="minio:9000", path="/b", query="list-type=2&prefix=m%2F", region="us-west-2",
         service="s3"),
    dict(method="POST", host="sts.example", path="/", query="Action=x", region="ap-south-1", service="sts"),
])
def test_sigv4_headers_are_the_references(fixed_clock, case):
    kw = dict(case, access_key="AKIDEXAMPLE", secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY")
    got = t_awssig.sigv4_headers(**kw)
    assert got == j_awssig.sigv4_headers(**kw)
    assert list(got) == list(j_awssig.sigv4_headers(**kw))  # same order, too
    assert "host" not in got and got["x-amz-date"] == "20260304T050607Z"
    # the signature is the one AWS's key derivation gives for this request
    signed = sorted({"host": case["host"], "x-amz-content-sha256": "UNSIGNED-PAYLOAD",
                     "x-amz-date": "20260304T050607Z",
                     **{k.lower(): v for k, v in (case.get("extra_headers") or {}).items()}}.items())
    canonical = "\n".join([case["method"], case["path"], case["query"],
                           "".join(f"{k}:{v}\n" for k, v in signed), ";".join(k for k, _ in signed),
                           "UNSIGNED-PAYLOAD"])
    scope = f"20260304/{case['region']}/{case.get('service', 's3')}/aws4_request"
    key = ("AWS4" + kw["secret_key"]).encode()
    for part in ("20260304", case["region"], case.get("service", "s3"), "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    to_sign = "\n".join(["AWS4-HMAC-SHA256", "20260304T050607Z", scope,
                         hashlib.sha256(canonical.encode()).hexdigest()])
    assert got["authorization"].endswith("Signature=" + hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest())


@pytest.mark.parametrize("content_type", ["", "application/octet-stream"])
@pytest.mark.parametrize("key", ["", "m/w.bin"])
def test_oss_signatures_are_the_references(fixed_clock, content_type, key):
    args = ("PUT", "bucket", key, "AKID", "SECRET")
    assert t_awssig.oss_sign_headers(*args, content_type=content_type) == j_awssig.oss_sign_headers(
        *args, content_type=content_type)


def test_the_factory_picks_the_same_drivers(tmp_path):
    for mod in (t_os, j_os):
        assert isinstance(mod.new_object_storage("fs", root=str(tmp_path / "fs")), mod.FSObjectStorage)
        assert isinstance(mod.new_object_storage("", root=str(tmp_path / "fs")), mod.FSObjectStorage)
        assert isinstance(mod.new_object_storage("s3", endpoint="http://127.0.0.1:1", access_key="a",
                                                 secret_key="s"), mod.S3ObjectStorage)
        assert isinstance(mod.new_object_storage("oss", endpoint="http://127.0.0.1:1"), mod.OSSObjectStorage)
        for bad in (lambda: mod.new_object_storage("nope"), lambda: mod.S3ObjectStorage("", "a", "s")):
            with pytest.raises(ValueError):
                bad()


def test_ttl_cache_matches_the_reference(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    runs = {}
    for name, mod in (("torch", t_cache), ("jax", j_cache)):
        clock[0] = 1000.0
        c = mod.TTLCache(default_ttl=10.0)
        trace = []
        c.set("a", 1)
        c.set("b", 2, ttl=30.0)
        c.set("c", 3, ttl=mod.NO_EXPIRATION)
        c.set("d", 4, ttl=0.0)
        trace += [c.get("a"), c.get("zz"), sorted(c.keys()), len(c)]
        clock[0] += 10.5
        trace += [c.get("a"), sorted(c.keys()), c.sweep(), len(c)]
        c.delete("b")
        c.delete("never")
        clock[0] += 1e6
        trace += [c.get("c"), c.get("b"), sorted(c.keys()), c.sweep(), len(c)]
        runs[name] = trace
    assert runs["torch"] == runs["jax"]
    assert runs["torch"][:3] == [(1, True), (None, False), ["a", "b", "c", "d"]]
    assert runs["torch"][-5:] == [(3, True), (None, False), ["c"], 0, 1]
