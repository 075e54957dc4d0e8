"""Cloud back-to-source clients (counterpart of the reference's
``client/source_cloud.py``): S3 (SigV4), Alibaba OSS (header HMAC),
WebHDFS and OCI-registry artifacts — stdlib HTTP against each service's
REST API, no SDKs (upstream
pkg/source/clients/{s3protocol,ossprotocol,hdfsprotocol,orasprotocol}).

URL forms (mirroring upstream's source URL conventions):
    s3://bucket/key            credentials via DF_S3_* env or per-request
                               headers (X-Dragonfly-S3-*)
    oss://bucket/key           DF_OSS_* / X-Dragonfly-OSS-*
    hdfs://namenode:port/path  WebHDFS REST (no auth / simple user)

Endpoint override (S3-compatible stores, MinIO, test fakes):
    DF_S3_ENDPOINT / DF_OSS_ENDPOINT — http(s)://host:port; when set,
    requests go to <endpoint>/<bucket>/<key> (path-style).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Iterator

from dragonfly2_torch.client.source import (
    CHUNK_SIZE,
    ListEntry,
    Metadata,
    SourceClient,
    SourceError,
    open_url,
)

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _env(headers: dict | None, name: str, env: str, default: str = "") -> str:
    if headers:
        v = headers.get(name)
        if v:
            return v
    return os.environ.get(env, default)


class S3SourceClient(SourceClient):
    """AWS S3 / S3-compatible origin over SigV4-signed REST
    (upstream pkg/source/clients/s3protocol)."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    # -- request construction -------------------------------------------
    def _conf(self, headers: dict | None):
        return {
            "access_key": _env(headers, "X-Dragonfly-S3-Access-Key", "DF_S3_ACCESS_KEY"),
            "secret_key": _env(headers, "X-Dragonfly-S3-Secret-Key", "DF_S3_SECRET_KEY"),
            "region": _env(headers, "X-Dragonfly-S3-Region", "DF_S3_REGION", "us-east-1"),
            "endpoint": _env(headers, "X-Dragonfly-S3-Endpoint", "DF_S3_ENDPOINT"),
        }

    def _target(self, url: str, conf) -> tuple[str, str, str]:
        """s3://bucket/key → (request_url, host, canonical_path)."""
        p = urllib.parse.urlsplit(url)
        bucket, key = p.netloc, p.path.lstrip("/")
        if conf["endpoint"]:
            e = urllib.parse.urlsplit(conf["endpoint"])
            path = f"/{bucket}/{urllib.parse.quote(key)}"
            return f"{e.scheme}://{e.netloc}{path}", e.netloc, path
        host = f"{bucket}.s3.{conf['region']}.amazonaws.com"
        path = "/" + urllib.parse.quote(key)
        return f"https://{host}{path}", host, path

    def _sign(self, method, host, path, query, conf, extra_headers):
        """SigV4 (AWS4-HMAC-SHA256), unsigned payload — shared with the
        s3 object-storage backend (utils/awssig.py)."""
        from dragonfly2_torch.utils.awssig import sigv4_headers

        return sigv4_headers(
            method,
            host,
            path,
            query,
            conf["region"],
            conf["access_key"],
            conf["secret_key"],
            extra_headers,
        )

    def _request(self, method, url, headers=None, range_header=None, query=""):
        conf = self._conf(headers)
        if not conf["access_key"]:
            raise SourceError(
                "s3 credentials missing: set DF_S3_ACCESS_KEY/DF_S3_SECRET_KEY"
                " or X-Dragonfly-S3-* request headers"
            )
        req_url, host, path = self._target(url, conf)
        if query:
            req_url = f"{req_url}?{query}"
        extra = {"range": range_header} if range_header else {}
        signed = self._sign(method, host, path, query, conf, extra)
        req = urllib.request.Request(req_url, method=method, headers=signed)
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            raise SourceError(f"s3 {method} {url}: HTTP {e.code} {e.reason}") from e
        except urllib.error.URLError as e:
            raise SourceError(f"s3 {method} {url}: {e.reason}") from e

    # -- SourceClient ----------------------------------------------------
    def metadata(self, url: str, headers: dict | None = None) -> Metadata:
        with self._request("HEAD", url, headers) as resp:
            return Metadata(
                content_length=int(resp.headers.get("Content-Length") or -1),
                content_type=resp.headers.get("Content-Type", ""),
                support_range=True,  # S3 always honors Range
            )

    def download(
        self, url: str, headers: dict | None = None, offset: int = 0, length: int = -1
    ) -> Iterator[bytes]:
        range_header = None
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            range_header = f"bytes={offset}-{end}"
        resp = self._request("GET", url, headers, range_header=range_header)
        with resp:
            while True:
                chunk = resp.read(CHUNK_SIZE)
                if not chunk:
                    return
                yield chunk

    def list(self, url: str, headers: dict | None = None) -> list[ListEntry]:
        """ListObjectsV2 under the key prefix (recursive dfget)."""
        import xml.etree.ElementTree as ET

        p = urllib.parse.urlsplit(url)
        prefix = p.path.lstrip("/")
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        query = "delimiter=%2F&list-type=2&prefix=" + urllib.parse.quote(prefix, safe="")
        bucket_url = f"s3://{p.netloc}/"
        with self._request("GET", bucket_url, headers, query=query) as resp:
            root = ET.fromstring(resp.read())
        ns = root.tag.partition("}")[0] + "}" if root.tag.startswith("{") else ""
        out: list[ListEntry] = []
        for cp in root.findall(f"{ns}CommonPrefixes"):
            sub = cp.findtext(f"{ns}Prefix") or ""
            name = sub[len(prefix) :].strip("/")
            if name:
                out.append(
                    ListEntry(name=name, url=f"s3://{p.netloc}/{sub}", is_dir=True)
                )
        for obj in root.findall(f"{ns}Contents"):
            key = obj.findtext(f"{ns}Key") or ""
            if key == prefix:
                continue
            name = key[len(prefix) :]
            out.append(ListEntry(name=name, url=f"s3://{p.netloc}/{key}", is_dir=False))
        return out


class OSSSourceClient(SourceClient):
    """Alibaba OSS origin: classic header signature
    (Authorization: OSS <key>:<base64(hmac-sha1(...))>), path-style when
    DF_OSS_ENDPOINT is set (upstream pkg/source/clients/ossprotocol)."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    def _conf(self, headers):
        return {
            "access_key": _env(headers, "X-Dragonfly-OSS-Access-Key", "DF_OSS_ACCESS_KEY"),
            "secret_key": _env(headers, "X-Dragonfly-OSS-Secret-Key", "DF_OSS_SECRET_KEY"),
            "endpoint": _env(
                headers, "X-Dragonfly-OSS-Endpoint", "DF_OSS_ENDPOINT",
                "https://oss-cn-hangzhou.aliyuncs.com",
            ),
        }

    def _request(self, method, url, headers=None, range_header=None):
        import base64

        conf = self._conf(headers)
        if not conf["access_key"]:
            raise SourceError(
                "oss credentials missing: set DF_OSS_ACCESS_KEY/DF_OSS_SECRET_KEY"
                " or X-Dragonfly-OSS-* request headers"
            )
        p = urllib.parse.urlsplit(url)
        bucket, key = p.netloc, p.path.lstrip("/")
        e = urllib.parse.urlsplit(conf["endpoint"])
        req_url = f"{e.scheme}://{e.netloc}/{bucket}/{urllib.parse.quote(key)}"
        date = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%a, %d %b %Y %H:%M:%S GMT"
        )
        to_sign = f"{method}\n\n\n{date}\n/{bucket}/{key}"
        sig = base64.b64encode(
            hmac.new(conf["secret_key"].encode(), to_sign.encode(), hashlib.sha1).digest()
        ).decode()
        hdrs = {"Date": date, "Authorization": f"OSS {conf['access_key']}:{sig}"}
        if range_header:
            hdrs["Range"] = range_header
        req = urllib.request.Request(req_url, method=method, headers=hdrs)
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as err:
            raise SourceError(f"oss {method} {url}: HTTP {err.code} {err.reason}") from err
        except urllib.error.URLError as err:
            raise SourceError(f"oss {method} {url}: {err.reason}") from err

    def metadata(self, url: str, headers: dict | None = None) -> Metadata:
        with self._request("HEAD", url, headers) as resp:
            return Metadata(
                content_length=int(resp.headers.get("Content-Length") or -1),
                content_type=resp.headers.get("Content-Type", ""),
                support_range=True,
            )

    def download(
        self, url: str, headers: dict | None = None, offset: int = 0, length: int = -1
    ) -> Iterator[bytes]:
        range_header = None
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            range_header = f"bytes={offset}-{end}"
        resp = self._request("GET", url, headers, range_header=range_header)
        with resp:
            while True:
                chunk = resp.read(CHUNK_SIZE)
                if not chunk:
                    return
                yield chunk

    def list(self, url: str, headers: dict | None = None) -> list[ListEntry]:
        raise SourceError("oss recursive listing is not implemented")


class HDFSSourceClient(SourceClient):
    """HDFS origin over the WebHDFS REST API
    (hdfs://namenode:port/path → http://namenode:port/webhdfs/v1/path,
    upstream pkg/source/clients/hdfsprotocol)."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    def _rest(self, url: str, op: str, extra: str = "") -> str:
        p = urllib.parse.urlsplit(url)
        user = _env(None, "", "DF_HDFS_USER")
        q = f"op={op}" + (f"&user.name={user}" if user else "") + extra
        return f"http://{p.netloc}/webhdfs/v1{urllib.parse.quote(p.path)}?{q}"

    def _open(self, rest_url: str):
        try:
            return urllib.request.urlopen(rest_url, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            raise SourceError(f"hdfs {rest_url}: HTTP {e.code} {e.reason}") from e
        except urllib.error.URLError as e:
            raise SourceError(f"hdfs {rest_url}: {e.reason}") from e

    def metadata(self, url: str, headers: dict | None = None) -> Metadata:
        with self._open(self._rest(url, "GETFILESTATUS")) as resp:
            st = json.loads(resp.read())["FileStatus"]
        return Metadata(
            content_length=int(st.get("length", -1)),
            content_type="application/octet-stream",
            support_range=True,  # OPEN supports offset/length
            last_modified=float(st.get("modificationTime", 0)) / 1000.0,
        )

    def download(
        self, url: str, headers: dict | None = None, offset: int = 0, length: int = -1
    ) -> Iterator[bytes]:
        extra = ""
        if offset:
            extra += f"&offset={offset}"
        if length >= 0:
            extra += f"&length={length}"
        with self._open(self._rest(url, "OPEN", extra)) as resp:
            while True:
                chunk = resp.read(CHUNK_SIZE)
                if not chunk:
                    return
                yield chunk

    def list(self, url: str, headers: dict | None = None) -> list[ListEntry]:
        with self._open(self._rest(url, "LISTSTATUS")) as resp:
            statuses = json.loads(resp.read())["FileStatuses"]["FileStatus"]
        base = url.rstrip("/")
        out = []
        for st in statuses:
            name = st["pathSuffix"]
            out.append(
                ListEntry(
                    name=name,
                    url=f"{base}/{name}",
                    is_dir=st.get("type") == "DIRECTORY",
                )
            )
        return out


from dragonfly2_torch.utils.oci import MANIFEST_ACCEPT as _OCI_MANIFEST_ACCEPT


class ORASSourceClient(SourceClient):
    """OCI-registry artifact origin (upstream
    pkg/source/clients/orasprotocol/oras_source_client.go).

    URL form: ``oras://registry.host/repo/name:tag`` — the artifact is
    the manifest's first layer blob. Flow: bearer-token handshake →
    manifest fetch (digest of layer 0) → blob download. Fast path
    matching upstream's digest/token shortcut: when the request
    carries ``?digest=sha256:…`` AND an ``X-Dragonfly-Oras-Token``
    header, the manifest round-trip is skipped entirely.

    Registry base defaults to ``https://host``; ``DF_ORAS_ENDPOINT``
    overrides it (test fakes, plain-HTTP internal registries), same
    convention as DF_S3_ENDPOINT.
    """

    TOKEN_HEADER = "X-Dragonfly-Oras-Token"

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    # -- URL handling ----------------------------------------------------
    @staticmethod
    def _parse(url: str) -> tuple[str, str, str, str]:
        """→ (base, repo, tag, digest_query). repo/tag from the path
        ``/repo/name:tag``; base honors DF_ORAS_ENDPOINT."""
        u = urllib.parse.urlparse(url)
        path = u.path.lstrip("/")
        if ":" not in path:
            raise SourceError(f"oras url needs a ':tag' suffix: {url}")
        repo, _, tag = path.rpartition(":")
        if not repo or not tag:
            raise SourceError(f"malformed oras url: {url}")
        base = os.environ.get("DF_ORAS_ENDPOINT", "") or f"https://{u.netloc}"
        digest = urllib.parse.parse_qs(u.query).get("digest", [""])[0]
        return base.rstrip("/"), repo, tag, digest

    # -- auth ------------------------------------------------------------
    def _fetch_token(self, base: str, repo: str, headers: dict) -> str:
        """Bearer token for ``repository:<repo>:pull``. A caller-supplied
        token header short-circuits; an Authorization header (basic auth)
        is forwarded to the token service, mirroring upstream's
        fetchTokenWithHeader."""
        if headers.get(self.TOKEN_HEADER):
            return headers[self.TOKEN_HEADER]
        tok_url = (
            f"{base}/service/token?"
            + urllib.parse.urlencode({"scope": f"repository:{repo}:pull"})
        )
        hdrs = {}
        if headers.get("Authorization"):
            hdrs["Authorization"] = headers["Authorization"]
            hdrs["Accept"] = "application/json"
        req = urllib.request.Request(tok_url, headers=hdrs)
        try:
            with open_url(req, self.timeout) as resp:
                return str(json.loads(resp.read()).get("token", ""))
        except urllib.error.HTTPError as e:
            if e.code == 404:  # registry without a token service: anonymous
                return ""
            raise SourceError(f"oras token fetch: {e.code}") from e
        except urllib.error.URLError as e:
            raise SourceError(f"oras token fetch: {e.reason}") from e

    def _get(self, url: str, token: str, accept: str = "", rng: str = ""):
        hdrs = {}
        if token:
            hdrs["Authorization"] = f"Bearer {token}"
        if accept:
            hdrs["Accept"] = accept
        if rng:
            hdrs["Range"] = rng
        req = urllib.request.Request(url, headers=hdrs)
        try:
            return open_url(req, self.timeout)
        except urllib.error.HTTPError as e:
            raise SourceError(f"GET {url}: {e.code}") from e
        except urllib.error.URLError as e:
            raise SourceError(f"GET {url}: {e.reason}") from e

    def _first_layer(self, base: str, repo: str, tag: str, token: str) -> tuple[str, int]:
        """Manifest fetch → (digest, size) of layer 0 — the artifact
        payload (upstream fetchManifest takes Layers[0].Digest)."""
        with self._get(
            f"{base}/v2/{repo}/manifests/{tag}", token, accept=_OCI_MANIFEST_ACCEPT
        ) as resp:
            manifest = json.loads(resp.read())
        layers = manifest.get("layers") or []
        if not layers or not layers[0].get("digest"):
            raise SourceError(f"oras manifest for {repo}:{tag} has no layer digest")
        return layers[0]["digest"], int(layers[0].get("size", -1))

    # -- SourceClient surface -------------------------------------------
    def metadata(self, url: str, headers: dict | None = None) -> Metadata:
        headers = dict(headers or {})
        base, repo, tag, digest = self._parse(url)
        token = self._fetch_token(base, repo, headers)
        size = -1
        if not digest:
            digest, size = self._first_layer(base, repo, tag, token)
        if size < 0:
            hdrs = {"Authorization": f"Bearer {token}"} if token else {}
            req = urllib.request.Request(
                f"{base}/v2/{repo}/blobs/{digest}", method="HEAD", headers=hdrs
            )
            try:
                with open_url(req, self.timeout) as resp:
                    size = int(resp.headers.get("Content-Length", -1))
            except urllib.error.HTTPError as e:
                raise SourceError(f"HEAD blob {digest}: {e.code}") from e
            except urllib.error.URLError as e:
                raise SourceError(f"HEAD blob {digest}: {e.reason}") from e
        return Metadata(
            content_length=size,
            support_range=True,
            etag=digest,
            content_type="application/octet-stream",
        )

    def download(
        self,
        url: str,
        headers: dict | None = None,
        offset: int = 0,
        length: int = -1,
    ) -> Iterator[bytes]:
        headers = dict(headers or {})
        base, repo, tag, digest = self._parse(url)
        # upstream fast path: digest in query + token in header → blob
        # fetch directly, no token service / manifest round-trips
        if not (digest and headers.get(self.TOKEN_HEADER)):
            token = self._fetch_token(base, repo, headers)
            if not digest:
                digest, _ = self._first_layer(base, repo, tag, token)
        else:
            token = headers[self.TOKEN_HEADER]
        rng = ""
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            rng = f"bytes={offset}-{end}"
        with self._get(f"{base}/v2/{repo}/blobs/{digest}", token, rng=rng) as resp:
            while True:
                chunk = resp.read(CHUNK_SIZE)
                if not chunk:
                    break
                yield chunk

    def list(self, url: str, headers: dict | None = None) -> list[ListEntry]:
        raise SourceError("oras origin does not support recursive listing")
