"""Back-to-source clients: protocol-pluggable origin fetch (counterpart
of the reference's ``client/source.py``).

Role parity: upstream pkg/source/source_client.go:102-161 (interface:
content length, range support, download, metadata, recursive list) with
clients under pkg/source/clients/{httpprotocol,...}. Scheme → client
registry mirrors pkg/source's loader; plugins register at import time.

http(s) and file are implemented here; s3 (SigV4), oss, hdfs
(WebHDFS), and oras (OCI registry artifacts) live in source_cloud.py —
real REST clients, no SDKs.
"""

from __future__ import annotations

import email.utils
import mimetypes
import os
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Iterator

CHUNK_SIZE = 1 << 20


class SourceError(Exception):
    pass


@dataclass
class Metadata:
    content_length: int = -1
    support_range: bool = False
    last_modified: float = 0.0
    etag: str = ""
    content_type: str = ""


@dataclass
class ListEntry:
    url: str
    name: str
    is_dir: bool
    content_length: int = -1


class SourceClient:
    """One origin protocol (upstream pkg/source/source_client.go:102)."""

    def metadata(self, url: str, headers: dict | None = None) -> Metadata:
        raise NotImplementedError

    def content_length(self, url: str, headers: dict | None = None) -> int:
        return self.metadata(url, headers).content_length

    def download(
        self,
        url: str,
        headers: dict | None = None,
        offset: int = 0,
        length: int = -1,
    ) -> Iterator[bytes]:
        """Yield chunks of the object; ``offset``/``length`` select a
        byte range when the origin supports it."""
        raise NotImplementedError

    def list(self, url: str, headers: dict | None = None) -> list[ListEntry]:
        """Recursive-download directory listing (upstream
        pkg/source list support, used by dfget --recursive)."""
        raise NotImplementedError


def open_url(req, timeout: float):
    """urlopen honoring ``DF_ORIGIN_CA``: a PEM bundle ADDED to the
    system trust store for origins behind a private CA (internal
    registries) — read per call so it can change at runtime (urllib's
    default opener freezes its SSL context on first use). Shared by the
    source clients and the daemon transport's direct route."""
    import os as _os
    import ssl as _ssl

    ca = _os.environ.get("DF_ORIGIN_CA")
    if ca:
        ctx = _ssl.create_default_context()  # system roots stay trusted
        ctx.load_verify_locations(cafile=ca)
        return urllib.request.urlopen(req, timeout=timeout, context=ctx)
    return urllib.request.urlopen(req, timeout=timeout)


class HTTPSourceClient(SourceClient):
    """http(s) origin (upstream pkg/source/clients/httpprotocol)."""

    def __init__(self, timeout: float = 30.0):
        self.timeout = timeout

    def metadata(self, url: str, headers: dict | None = None) -> Metadata:
        req = urllib.request.Request(url, method="HEAD", headers=headers or {})
        try:
            with open_url(req, self.timeout) as resp:
                h = resp.headers
                lm = 0.0
                if h.get("Last-Modified"):
                    try:
                        lm = email.utils.parsedate_to_datetime(
                            h["Last-Modified"]
                        ).timestamp()
                    except (TypeError, ValueError):
                        pass
                return Metadata(
                    content_length=int(h.get("Content-Length", -1)),
                    support_range=h.get("Accept-Ranges", "") == "bytes",
                    last_modified=lm,
                    etag=h.get("ETag", ""),
                    content_type=h.get("Content-Type", ""),
                )
        except urllib.error.HTTPError as e:
            raise SourceError(f"HEAD {url}: {e.code}") from e
        except urllib.error.URLError as e:
            raise SourceError(f"HEAD {url}: {e.reason}") from e

    def download(
        self,
        url: str,
        headers: dict | None = None,
        offset: int = 0,
        length: int = -1,
    ) -> Iterator[bytes]:
        hdrs = dict(headers or {})
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            hdrs["Range"] = f"bytes={offset}-{end}"
        req = urllib.request.Request(url, headers=hdrs)
        try:
            resp = open_url(req, self.timeout)
        except urllib.error.HTTPError as e:
            raise SourceError(f"GET {url}: {e.code}") from e
        except urllib.error.URLError as e:
            raise SourceError(f"GET {url}: {e.reason}") from e
        with resp:
            while True:
                chunk = resp.read(CHUNK_SIZE)
                if not chunk:
                    break
                yield chunk

    def list(self, url: str, headers: dict | None = None) -> list[ListEntry]:
        raise SourceError("http origin does not support recursive listing")


class FileSourceClient(SourceClient):
    """file:// origin — used by tests and dfcache import."""

    @staticmethod
    def _path(url: str) -> str:
        return urllib.parse.unquote(urllib.parse.urlparse(url).path)

    def metadata(self, url: str, headers: dict | None = None) -> Metadata:
        p = self._path(url)
        if not os.path.exists(p):
            raise SourceError(f"no such file: {p}")
        st = os.stat(p)
        return Metadata(
            content_length=st.st_size,
            support_range=True,
            last_modified=st.st_mtime,
            content_type=mimetypes.guess_type(p)[0] or "",
        )

    def download(
        self,
        url: str,
        headers: dict | None = None,
        offset: int = 0,
        length: int = -1,
    ) -> Iterator[bytes]:
        p = self._path(url)
        try:
            f = open(p, "rb")
        except OSError as e:
            raise SourceError(f"open {p}: {e}") from e
        with f:
            f.seek(offset)
            remaining = length if length >= 0 else None
            while True:
                want = CHUNK_SIZE if remaining is None else min(CHUNK_SIZE, remaining)
                if want == 0:
                    break
                chunk = f.read(want)
                if not chunk:
                    break
                if remaining is not None:
                    remaining -= len(chunk)
                yield chunk

    def list(self, url: str, headers: dict | None = None) -> list[ListEntry]:
        p = self._path(url)
        if not os.path.isdir(p):
            raise SourceError(f"not a directory: {p}")
        out = []
        for name in sorted(os.listdir(p)):
            fp = os.path.join(p, name)
            out.append(
                ListEntry(
                    url=f"file://{fp}",
                    name=name,
                    is_dir=os.path.isdir(fp),
                    content_length=os.path.getsize(fp) if os.path.isfile(fp) else -1,
                )
            )
        return out


_REGISTRY: dict[str, SourceClient] = {}


def register_client(scheme: str, client: SourceClient) -> None:
    _REGISTRY[scheme] = client


def client_for(url: str) -> SourceClient:
    scheme = urllib.parse.urlparse(url).scheme or "file"
    client = _REGISTRY.get(scheme)
    if client is None and scheme in _LAZY_CLOUD:
        client = _load_cloud(scheme)
    if client is None:
        raise SourceError(f"no source client registered for scheme {scheme!r}")
    return client


register_client("http", HTTPSourceClient())
register_client("https", HTTPSourceClient())
register_client("file", FileSourceClient())


# cloud clients register lazily on first use — importing source_cloud
# here would re-enter it while partially initialized when a caller
# imports source_cloud first (it imports this module for the base types)
_LAZY_CLOUD = {
    "s3": "S3SourceClient",
    "oss": "OSSSourceClient",
    "hdfs": "HDFSSourceClient",
    "oras": "ORASSourceClient",
}


def _load_cloud(scheme: str) -> SourceClient:
    from dragonfly2_torch.client import source_cloud as sc

    client = getattr(sc, _LAZY_CLOUD[scheme])()
    register_client(scheme, client)
    return client
