"""dfget — file download CLI, a thin gRPC client of the local daemon.

Counterpart of the reference's ``client/dfget.py``.

Role parity: upstream client/dfget/dfget.go:47-386 +
cmd/dfget/cmd/root.go:246-300 — Download stream with progress, recursive
directory mode via source listing (dfget.go:317-386).
"""

from __future__ import annotations

import argparse
import os
import sys

from dragonfly2_torch.rpc import protos
common_pb2 = protos.load("common_pb2")
dfdaemon_pb2 = protos.load("dfdaemon_pb2")

from dragonfly2_torch.client import source
from dragonfly2_torch.rpc import glue

from dragonfly2_torch.rpc.glue import DFDAEMON_SERVICE


def daemon_alive(daemon_address: str, timeout: float = 2.0) -> bool:
    """Liveness probe: can a channel to the daemon become ready within
    ``timeout``?"""
    try:
        channel = glue.dial(daemon_address, retries=1, ready_timeout=timeout)
        channel.close()
        return True
    except Exception:
        return False


def ensure_daemon(
    daemon_address: str,
    scheduler_address: str,
    data_dir: str,
    wait: float = 15.0,
) -> bool:
    """Spawn-or-reuse the local daemon (upstream cmd/dfget/cmd/root.go:279
    checkAndSpawnDaemon): probe ``daemon_address`` (normally a
    ``unix:/path`` socket); when dead, fork a detached
    ``python -m dragonfly2_torch.client.daemon`` serving that address and
    wait for it to come up. Returns True when the daemon got spawned."""
    import subprocess
    import time

    if daemon_alive(daemon_address):
        return False
    overrides = [
        "--set", f"scheduler_address={scheduler_address}",
        "--set", f"data_dir={data_dir}",
    ]
    if daemon_address.startswith("unix:"):
        overrides += ["--set", f"unix_socket={daemon_address[5:]}"]
    else:
        overrides += ["--set", f"listen={daemon_address}"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_torch.client.daemon", *overrides],
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        start_new_session=True,  # outlive this dfget invocation
    )
    deadline = time.monotonic() + wait
    while time.monotonic() < deadline:
        if daemon_alive(daemon_address, timeout=0.5):
            return True
        if proc.poll() is not None:
            # OUR spawn exiting is not fatal by itself: in a concurrent
            # spawn race the loser exits ("another daemon is serving")
            # while the winner is still starting — keep probing until
            # the deadline and only then conclude nothing is serving
            time.sleep(0.2)
            continue
        time.sleep(0.2)
    if daemon_alive(daemon_address, timeout=1.0):
        return True
    if proc.poll() is not None:
        raise RuntimeError(
            f"spawned daemon exited with rc={proc.returncode} and nothing"
            f" is serving {daemon_address}"
        )
    raise TimeoutError(f"spawned daemon not ready on {daemon_address} within {wait}s")


def add_spawn_daemon_args(parser) -> None:
    """The spawn-or-reuse CLI trio shared by dfget/dfcache (upstream:
    both CLIs spawn the daemon over the unix socket when none answers)."""
    parser.add_argument("--spawn-daemon", action="store_true")
    parser.add_argument(
        "--scheduler",
        default=os.environ.get("DF_SCHEDULER_ADDR", "127.0.0.1:8002"),
        help="scheduler address(es) a spawned daemon announces to",
    )
    parser.add_argument(
        "--daemon-data-dir",
        default=os.path.expanduser("~/.dragonfly2/daemon"),
        help="data dir a spawned daemon uses",
    )


def download(
    daemon_address: str,
    url: str,
    output: str,
    tag: str = "",
    application: str = "",
    digest: str = "",
    byte_range: str = "",
    headers: dict | None = None,
    disable_back_source: bool = False,
    recursive: bool = False,
    on_progress=None,
) -> list[str]:
    """Download ``url`` to ``output`` through the daemon; returns the
    list of written paths (1 for a file, N for recursive)."""
    if recursive:
        if byte_range:
            # a byte range of a directory is meaningless; dropping it
            # silently would hand back full files the caller didn't ask for
            raise ValueError("--range cannot be combined with --recursive")
        if digest:
            # one digest cannot pin N different files — silently skipping
            # verification would betray exactly the caller who asked for it
            raise ValueError("--digest cannot be combined with --recursive")
        return _download_recursive(
            daemon_address, url, output, tag=tag, application=application,
            headers=headers, on_progress=on_progress,
        )
    client = glue.ServiceClient(glue.dial(daemon_address), DFDAEMON_SERVICE)
    req = dfdaemon_pb2.DownloadRequest(
        url=url,
        output=os.path.abspath(output),
        url_meta=common_pb2.UrlMeta(
            tag=tag,
            application=application,
            digest=digest,
            range=byte_range,
            header=headers or {},
        ),
        disable_back_source=disable_back_source,
    )
    for result in client.Download(req):
        if on_progress:
            on_progress(result)
        if result.done:
            return [output]
    raise RuntimeError("download stream ended without completion")


def _download_recursive(
    daemon_address: str, url: str, output: str, tag: str = "",
    application: str = "", headers: dict | None = None, on_progress=None,
) -> list[str]:
    """Directory mode: list the origin, download each file through the
    daemon (upstream dfget.go:317-386). ``headers`` authenticate both
    the listing and every per-file back-to-source fetch."""
    entries = source.client_for(url).list(url, headers)
    written: list[str] = []
    for e in entries:
        dest = os.path.join(output, e.name)
        if e.is_dir:
            written += _download_recursive(
                daemon_address, e.url, dest, tag=tag,
                application=application, headers=headers, on_progress=on_progress,
            )
        else:
            os.makedirs(output, exist_ok=True)
            written += download(
                daemon_address, e.url, dest, tag=tag,
                application=application, headers=headers, on_progress=on_progress,
            )
    return written


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="dfget", description="P2P file download")
    p.add_argument("url")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--daemon", default=os.environ.get("DFDAEMON_ADDR", "127.0.0.1:65000"))
    p.add_argument("--tag", default="")
    p.add_argument("--application", default="")
    p.add_argument(
        "--digest",
        default="",
        help='pin the downloaded content: "sha256:<hex>" or "md5:<hex>";'
        " verified before success is reported (with --range, the pin"
        " covers the slice — the task's content)",
    )
    p.add_argument(
        "-H",
        "--header",
        action="append",
        default=[],
        dest="origin_headers",
        metavar="'K: V'",
        help="origin request header (repeatable) — auth for private"
        " registries / signed URLs on the back-to-source fetch",
    )
    p.add_argument(
        "--range",
        default="",
        dest="byte_range",
        help='byte range of the origin object, e.g. "0-1023" or "bytes=4096-" '
        "(inclusive HTTP semantics; the range is part of the task identity)",
    )
    p.add_argument("--disable-back-source", action="store_true")
    p.add_argument("--recursive", action="store_true")
    # spawn-or-reuse: start a local daemon on --daemon when none answers
    # (upstream dfget root.go:279 checkAndSpawnDaemon)
    add_spawn_daemon_args(p)
    args = p.parse_args(argv)

    if args.byte_range:
        # fail fast with the real message — daemon-side validation would
        # surface as an opaque gRPC error
        from dragonfly2_torch.client.pieces import normalize_byte_range

        try:
            args.byte_range = normalize_byte_range(args.byte_range)
        except ValueError as e:
            p.error(str(e))

    if args.spawn_daemon:
        ensure_daemon(args.daemon, args.scheduler, args.daemon_data_dir)

    def progress(r):
        if r.content_length > 0:
            pct = 100.0 * r.completed_length / r.content_length
            print(f"\r{pct:6.2f}% {r.completed_length}/{r.content_length}", end="", file=sys.stderr)

    origin_headers = {}
    for spec in args.origin_headers:
        k, sep, v = spec.partition(":")
        if not sep or not k.strip():
            p.error(f"malformed --header {spec!r} (need 'Name: value')")
        k = k.strip()
        if k in origin_headers:
            # repeated names combine per RFC 9110 — silent last-wins
            # would drop a Cookie/Forwarded entry the origin requires
            origin_headers[k] = f"{origin_headers[k]}, {v.strip()}"
        else:
            origin_headers[k] = v.strip()

    paths = download(
        args.daemon, args.url, args.output,
        tag=args.tag, application=args.application, digest=args.digest,
        byte_range=args.byte_range, headers=origin_headers,
        disable_back_source=args.disable_back_source,
        recursive=args.recursive, on_progress=progress,
    )
    print(file=sys.stderr)
    for path in paths:
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
