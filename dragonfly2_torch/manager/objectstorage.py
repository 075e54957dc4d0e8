"""Object storage behind one interface (counterpart of the reference's
``manager/objectstorage.py``; role parity: upstream pkg/objectstorage —
S3/OSS drivers). The filesystem driver is the in-cluster default; the
interface is the S3 verb set so a real driver drops in."""

from __future__ import annotations

import shutil
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Iterator, Protocol

from dragonfly2_torch.utils.awssig import sigv4_headers


class ObjectStorage(Protocol):
    def put_object(self, bucket: str, key: str, data: bytes) -> None: ...

    def get_object(self, bucket: str, key: str) -> bytes: ...

    def head_object(self, bucket: str, key: str) -> bool: ...

    def stat_object(self, bucket: str, key: str) -> int: ...

    def delete_object(self, bucket: str, key: str) -> None: ...

    def list_objects(self, bucket: str, prefix: str = "") -> list[str]: ...

    def create_bucket(self, bucket: str) -> None: ...


class FSObjectStorage:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, bucket: str, key: str = "") -> Path:
        p = (self.root / bucket / key).resolve()
        # component-wise check — a string-prefix test would accept sibling
        # dirs sharing the root's name as a prefix (/data/backend-x)
        if not p.is_relative_to(self.root.resolve()):
            raise ValueError(f"object key escapes storage root: {key}")
        return p

    def create_bucket(self, bucket: str) -> None:
        self._path(bucket).mkdir(parents=True, exist_ok=True)

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        p = self._path(bucket, key)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_bytes(data)
        tmp.replace(p)  # atomic publish

    def get_object(self, bucket: str, key: str) -> bytes:
        return self._path(bucket, key).read_bytes()

    def head_object(self, bucket: str, key: str) -> bool:
        return self._path(bucket, key).is_file()

    def stat_object(self, bucket: str, key: str) -> int:
        """Object size without reading the bytes."""
        return self._path(bucket, key).stat().st_size

    def delete_object(self, bucket: str, key: str) -> None:
        self._path(bucket, key).unlink(missing_ok=True)

    def list_objects(self, bucket: str, prefix: str = "") -> list[str]:
        base = self._path(bucket)
        if not base.exists():
            return []
        out = []
        for p in base.rglob("*"):
            if p.is_file() and not p.name.endswith(".tmp"):
                key = str(p.relative_to(base))
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete_bucket(self, bucket: str) -> None:
        shutil.rmtree(self._path(bucket), ignore_errors=True)

    def list_buckets(self) -> list[str]:
        return sorted(p.name for p in self.root.iterdir() if p.is_dir())


def _s3_error_code(e: "urllib.error.HTTPError") -> str:
    """<Code> from an S3/OSS XML error body ('' when unparsable)."""
    try:
        root = ET.fromstring(e.read())
        ns = root.tag.partition("}")[0] + "}" if root.tag.startswith("{") else ""
        code = root.find(f"{ns}Code")
        return code.text or "" if code is not None else ""
    except Exception:
        return ""


class _HTTPObjectStorage:
    """Shared verb layer for REST object stores; subclasses provide the
    signed ``_request`` and the listing dialect. Missing objects surface
    as ``FileNotFoundError`` so both drivers are true drop-ins for
    ``FSObjectStorage`` behind the Protocol (the gateway maps that to
    HTTP 404)."""

    _scheme = "object"

    def __init__(self, endpoint: str, timeout: float = 30.0):
        if not endpoint:
            raise ValueError(f"{self._scheme} object storage needs an endpoint URL")
        self._e = urllib.parse.urlsplit(endpoint)
        self.timeout = timeout

    # subclasses implement: _request(method, bucket, key, query, data)
    # and the listing dialect hooks below.
    def _create_bucket_body(self) -> bytes:
        return b""

    def _list_query(self, prefix: str, token: str) -> dict:
        raise NotImplementedError

    def _list_next(self, root, ns: str) -> str:
        raise NotImplementedError

    # -- verbs ----------------------------------------------------------
    def create_bucket(self, bucket: str) -> None:
        try:
            with self._request("PUT", bucket, data=self._create_bucket_body() or None):
                pass
        except urllib.error.HTTPError as e:
            # only OUR existing bucket is success; a 409 for a bucket
            # owned by someone else must fail loudly now, not as
            # confusing 403s on the first put. Stores that return a
            # codeless 409 (our fakes, some MinIO setups) count as ours.
            code = _s3_error_code(e) if e.code == 409 else ""
            if e.code == 409 and code in ("", "BucketAlreadyOwnedByYou"):
                return
            raise

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        with self._request("PUT", bucket, key, data=data):
            pass

    def get_object(self, bucket: str, key: str) -> bytes:
        try:
            with self._request("GET", bucket, key) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise FileNotFoundError(f"{self._scheme}://{bucket}/{key}") from e
            raise

    def head_object(self, bucket: str, key: str) -> bool:
        try:
            with self._request("HEAD", bucket, key):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise

    def stat_object(self, bucket: str, key: str) -> int:
        try:
            with self._request("HEAD", bucket, key) as resp:
                return int(resp.headers.get("Content-Length", 0) or 0)
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise FileNotFoundError(f"{self._scheme}://{bucket}/{key}") from e
            raise

    def delete_object(self, bucket: str, key: str) -> None:
        try:
            with self._request("DELETE", bucket, key):
                pass
        except urllib.error.HTTPError as e:
            if e.code != 404:  # delete is idempotent, like the FS driver
                raise

    def list_objects(self, bucket: str, prefix: str = "") -> list[str]:
        """Paged listing; subclasses define the query/continuation dialect."""
        out: list[str] = []
        token = ""
        while True:
            # canonical query must be sorted AND percent-encoded the way
            # signatures canonicalize (quote, not quote_plus — a '+' for
            # space breaks verification server-side)
            query = urllib.parse.urlencode(
                sorted(self._list_query(prefix, token).items()),
                quote_via=urllib.parse.quote,
            )
            with self._request("GET", bucket, query=query) as resp:
                root = ET.fromstring(resp.read())
            ns = root.tag.partition("}")[0] + "}" if root.tag.startswith("{") else ""
            for c in root.findall(f"{ns}Contents"):
                k = c.find(f"{ns}Key")
                if k is not None and k.text:
                    out.append(k.text)
            trunc = root.find(f"{ns}IsTruncated")
            if trunc is None or trunc.text != "true":
                break
            token = self._list_next(root, ns)
            if not token:
                break
        return sorted(out)

    def delete_bucket(self, bucket: str) -> None:
        try:
            with self._request("DELETE", bucket):
                pass
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise


class S3ObjectStorage(_HTTPObjectStorage):
    """S3-compatible driver over SigV4-signed REST (role parity:
    upstream pkg/objectstorage s3 driver via aws-sdk) — endpoint-style
    addressing (``endpoint/bucket/key``), so MinIO/Ceph/R2-style
    S3-compatible stores work the same as AWS."""

    _scheme = "s3"

    def __init__(
        self,
        endpoint: str,
        access_key: str,
        secret_key: str,
        region: str = "us-east-1",
        timeout: float = 30.0,
    ):
        super().__init__(endpoint, timeout)
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def _request(self, method: str, bucket: str, key: str = "", query: str = "",
                 data: bytes | None = None):
        path = f"/{bucket}" + (f"/{urllib.parse.quote(key)}" if key else "")
        headers = sigv4_headers(
            method, self._e.netloc, path, query,
            self.region, self.access_key, self.secret_key,
        )
        url = f"{self._e.scheme}://{self._e.netloc}{path}"
        if query:
            url = f"{url}?{query}"
        req = urllib.request.Request(url, method=method, headers=headers, data=data)
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _create_bucket_body(self) -> bytes:
        # non-default regions need an explicit LocationConstraint body —
        # AWS rejects a bare PUT outside us-east-1
        if self.region == "us-east-1":
            return b""
        return (
            '<CreateBucketConfiguration xmlns='
            '"http://s3.amazonaws.com/doc/2006-03-01/">'
            f"<LocationConstraint>{self.region}</LocationConstraint>"
            "</CreateBucketConfiguration>"
        ).encode()

    def _list_query(self, prefix: str, token: str) -> dict:
        q = {"list-type": "2"}
        if prefix:
            q["prefix"] = prefix
        if token:
            q["continuation-token"] = token
        return q

    def _list_next(self, root, ns: str) -> str:
        nxt = root.find(f"{ns}NextContinuationToken")
        return nxt.text if nxt is not None and nxt.text else ""


class OSSObjectStorage(_HTTPObjectStorage):
    """Alibaba OSS driver: classic header signature
    (``OSS <key>:<base64 hmac-sha1>``; role parity: upstream
    pkg/objectstorage oss driver)."""

    _scheme = "oss"

    def __init__(
        self,
        endpoint: str,
        access_key: str,
        secret_key: str,
        timeout: float = 30.0,
    ):
        super().__init__(endpoint, timeout)
        self.access_key = access_key
        self.secret_key = secret_key

    def _request(self, method: str, bucket: str, key: str = "", query: str = "",
                 data: bytes | None = None):
        from dragonfly2_torch.utils.awssig import oss_sign_headers

        # urllib force-adds a Content-Type to data-carrying requests, and
        # OSS signs Content-Type — so writers declare one explicitly and
        # it participates in the signature
        content_type = "application/octet-stream" if data is not None else ""
        headers = oss_sign_headers(
            method, bucket, key, self.access_key, self.secret_key,
            content_type=content_type,
        )
        path = f"/{bucket}" + (f"/{urllib.parse.quote(key)}" if key else "")
        url = f"{self._e.scheme}://{self._e.netloc}{path}"
        if query:
            url = f"{url}?{query}"
        req = urllib.request.Request(url, method=method, headers=headers, data=data)
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _list_query(self, prefix: str, token: str) -> dict:
        q = {}
        if prefix:
            q["prefix"] = prefix
        if token:
            q["marker"] = token
        return q

    def _list_next(self, root, ns: str) -> str:
        nxt = root.find(f"{ns}NextMarker")
        return nxt.text if nxt is not None and nxt.text else ""


def new_object_storage(
    driver: str = "fs",
    root: str = "",
    endpoint: str = "",
    access_key: str = "",
    secret_key: str = "",
    region: str = "us-east-1",
) -> "ObjectStorage":
    """Driver factory (upstream pkg/objectstorage New): ``fs`` (default),
    ``s3`` (any S3-compatible endpoint), or ``oss``."""
    if driver == "s3":
        return S3ObjectStorage(
            endpoint, access_key, secret_key, region=region
        )
    if driver == "oss":
        return OSSObjectStorage(endpoint, access_key, secret_key)
    if driver in ("", "fs"):
        return FSObjectStorage(root)
    raise ValueError(f"unknown object-storage driver {driver!r} (fs | s3 | oss)")
