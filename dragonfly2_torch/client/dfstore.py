"""dfstore — object-storage CLI/SDK against the daemon's gateway
(counterpart of the reference's ``client/dfstore.py``).

Role parity: upstream client/dfstore/dfstore.go (809 LoC SDK) +
cmd/dfstore — copy/stat/remove objects through the daemon's
object-storage HTTP gateway, so reads ride the P2P swarm and writes can
seed the writing daemon (upstream objectstorage gateway replication).

SDK functions take the gateway address ("host:port"); the CLI maps
  dfstore cp <src> <dst>    (local ↔ df://bucket/key, or df://… → df://… object copy)
  dfstore stat df://bucket/key
  dfstore rm df://bucket/key
  dfstore ls df://bucket[/prefix]
  dfstore mb df://bucket          (make bucket)
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.parse
import urllib.request


class DfstoreError(Exception):
    pass


def _url(gateway: str, bucket: str, key: str = "", query: str = "") -> str:
    path = f"/buckets/{bucket}"
    if key:
        path += f"/objects/{urllib.parse.quote(key)}"
    return f"http://{gateway}{path}" + (f"?{query}" if query else "")


def _request(
    method: str,
    url: str,
    data: bytes | None = None,
    timeout: float = 300.0,
    headers: dict | None = None,
):
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        return urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        raise DfstoreError(f"{method} {url}: HTTP {e.code} {e.reason}") from e
    except urllib.error.URLError as e:
        raise DfstoreError(f"{method} {url}: {e.reason}") from e


# -- SDK --------------------------------------------------------------------


def create_bucket(gateway: str, bucket: str) -> None:
    _request("PUT", _url(gateway, bucket)).close()


def put_object(
    gateway: str, bucket: str, key: str, data: bytes, seed_local: bool = True
) -> None:
    """Store an object; ``seed_local`` also imports it into the writing
    daemon's piece store so it P2P-serves without a backend fetch."""
    mode = 1 if seed_local else 0
    _request(
        "PUT", _url(gateway, bucket, key, query=f"mode={mode}"), data=data
    ).close()


def get_object(
    gateway: str, bucket: str, key: str, byte_range: str = ""
) -> bytes:
    """Fetch an object (or, with ``byte_range``, a slice of it — RFC
    7233 forms; the gateway answers 206 + Content-Range)."""
    headers = {"Range": byte_range} if byte_range else None
    with _request("GET", _url(gateway, bucket, key), headers=headers) as resp:
        return resp.read()


def head_object(gateway: str, bucket: str, key: str) -> int | None:
    """→ object size, or None when absent."""
    try:
        with _request("HEAD", _url(gateway, bucket, key)) as resp:
            return int(resp.headers.get("Content-Length", 0))
    except DfstoreError as e:
        if "HTTP 404" in str(e):
            return None
        raise


def copy_object(
    gateway: str,
    bucket: str,
    key: str,
    dst_bucket: str,
    dst_key: str,
    seed_local: bool = True,
) -> None:
    """Object→object copy through the gateway (upstream dfstore
    CopyObject) — composed client-side as get+put; the destination write
    rides the normal seed-on-write path unless ``seed_local`` is off."""
    put_object(
        gateway, dst_bucket, dst_key, get_object(gateway, bucket, key),
        seed_local=seed_local,
    )


def delete_object(gateway: str, bucket: str, key: str) -> None:
    _request("DELETE", _url(gateway, bucket, key)).close()


def list_objects(gateway: str, bucket: str, prefix: str = "") -> list[str]:
    url = f"http://{gateway}/buckets/{bucket}/objects"
    if prefix:
        url += "?" + urllib.parse.urlencode({"prefix": prefix})
    with _request("GET", url) as resp:
        return json.loads(resp.read())["keys"]


# -- CLI --------------------------------------------------------------------


def _parse_df(uri: str) -> tuple[str, str]:
    """df://bucket/key → (bucket, key)."""
    if not uri.startswith("df://"):
        raise DfstoreError(f"not a df:// URI: {uri}")
    rest = uri[5:]
    bucket, _, key = rest.partition("/")
    if not bucket:
        raise DfstoreError(f"missing bucket in {uri}")
    return bucket, key


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="dfstore", description="object storage via daemon gateway")
    p.add_argument("--endpoint", default="127.0.0.1:65004", help="gateway host:port")
    sub = p.add_subparsers(dest="cmd", required=True)

    cp = sub.add_parser("cp", help="copy local↔object store")
    cp.add_argument("src")
    cp.add_argument("dst")
    cp.add_argument("--no-seed", action="store_true", help="don't seed the local daemon on upload")
    cp.add_argument(
        "--range", default="", dest="byte_range",
        help='byte range for a df://→local copy, e.g. "0-1023" or "bytes=-500"',
    )

    for name in ("stat", "rm"):
        s = sub.add_parser(name)
        s.add_argument("uri")

    ls = sub.add_parser("ls")
    ls.add_argument("uri")

    mb = sub.add_parser("mb", help="make bucket")
    mb.add_argument("uri")

    args = p.parse_args(argv)
    if getattr(args, "byte_range", ""):
        # validate client-side (like dfget): the gateway IGNORES a
        # malformed Range per RFC 7233, which would silently copy the
        # whole object; and a range only means something for df://→local
        from dragonfly2_torch.client.pieces import normalize_byte_range

        try:
            args.byte_range = normalize_byte_range(args.byte_range)
        except ValueError as e:
            p.error(str(e))
        if not (args.src.startswith("df://") and not args.dst.startswith("df://")):
            p.error("--range applies only to df://→local copies")
    try:
        if args.cmd == "cp":
            if args.src.startswith("df://") and args.dst.startswith("df://"):
                sb, sk = _parse_df(args.src)
                db_, dk = _parse_df(args.dst)
                copy_object(
                    args.endpoint, sb, sk, db_, dk, seed_local=not args.no_seed
                )
            elif args.src.startswith("df://"):
                bucket, key = _parse_df(args.src)
                data = get_object(args.endpoint, bucket, key, byte_range=args.byte_range)
                with open(args.dst, "wb") as f:
                    f.write(data)
            else:
                bucket, key = _parse_df(args.dst)
                with open(args.src, "rb") as f:
                    data = f.read()
                put_object(args.endpoint, bucket, key, data, seed_local=not args.no_seed)
        elif args.cmd == "stat":
            bucket, key = _parse_df(args.uri)
            size = head_object(args.endpoint, bucket, key)
            if size is None:
                print(f"{args.uri}: not found", file=sys.stderr)
                return 1
            print(f"{args.uri}\t{size} bytes")
        elif args.cmd == "rm":
            bucket, key = _parse_df(args.uri)
            delete_object(args.endpoint, bucket, key)
        elif args.cmd == "ls":
            bucket, key = _parse_df(args.uri)
            for k in list_objects(args.endpoint, bucket, prefix=key):
                print(f"df://{bucket}/{k}")
        elif args.cmd == "mb":
            bucket, _ = _parse_df(args.uri)
            create_bucket(args.endpoint, bucket)
    except DfstoreError as e:
        print(f"dfstore: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
