"""dfcache — P2P cache CLI: stat/import/export/delete of cached blobs.

Counterpart of the reference's ``client/dfcache.py``.

Role parity: upstream client/dfcache/ + cmd/dfcache/cmd/root.go:42 —
thin client of the local daemon's dfdaemon gRPC cache ops.
"""

from __future__ import annotations

import argparse
import os
import sys

from dragonfly2_torch.rpc import protos
common_pb2 = protos.load("common_pb2")
dfdaemon_pb2 = protos.load("dfdaemon_pb2")

import grpc

from dragonfly2_torch.rpc import glue

from dragonfly2_torch.rpc.glue import DFDAEMON_SERVICE


def _client(daemon_address: str) -> glue.ServiceClient:
    return glue.ServiceClient(glue.dial(daemon_address), DFDAEMON_SERVICE)


def _meta(tag: str, application: str) -> common_pb2.UrlMeta:
    return common_pb2.UrlMeta(tag=tag, application=application)


def stat(daemon_address: str, url: str, tag: str = "", application: str = "") -> bool:
    try:
        _client(daemon_address).StatTask(
            dfdaemon_pb2.StatTaskRequest(url=url, url_meta=_meta(tag, application), local_only=True)
        )
        return True
    except grpc.RpcError as e:
        if e.code() == grpc.StatusCode.NOT_FOUND:
            return False
        raise


def import_file(daemon_address: str, path: str, url: str, tag: str = "", application: str = "") -> None:
    _client(daemon_address).ImportTask(
        dfdaemon_pb2.ImportTaskRequest(
            path=os.path.abspath(path), url=url, url_meta=_meta(tag, application)
        )
    )


def export_file(
    daemon_address: str, url: str, output: str, tag: str = "",
    application: str = "", local_only: bool = False,
) -> None:
    _client(daemon_address).ExportTask(
        dfdaemon_pb2.ExportTaskRequest(
            url=url, output=os.path.abspath(output),
            url_meta=_meta(tag, application), local_only=local_only,
        )
    )


def delete(daemon_address: str, url: str, tag: str = "", application: str = "") -> None:
    _client(daemon_address).DeleteTask(
        dfdaemon_pb2.DeleteTaskRequest(url=url, url_meta=_meta(tag, application))
    )


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="dfcache", description="P2P cache ops")
    p.add_argument("command", choices=["stat", "import", "export", "delete"])
    p.add_argument("url")
    p.add_argument("--daemon", default=os.environ.get("DFDAEMON_ADDR", "127.0.0.1:65000"))
    p.add_argument("--path", default="", help="local file (import)")
    p.add_argument("--output", default="", help="destination path (export)")
    p.add_argument("--tag", default="")
    p.add_argument("--application", default="")
    p.add_argument("--local-only", action="store_true")
    # spawn-or-reuse, same as dfget (upstream dfcache also spawns the
    # daemon over the unix socket when none answers)
    from dragonfly2_torch.client.dfget import add_spawn_daemon_args

    add_spawn_daemon_args(p)
    args = p.parse_args(argv)

    if args.spawn_daemon:
        from dragonfly2_torch.client.dfget import ensure_daemon

        ensure_daemon(args.daemon, args.scheduler, args.daemon_data_dir)

    if args.command == "stat":
        ok = stat(args.daemon, args.url, args.tag, args.application)
        print("cached" if ok else "not cached")
        return 0 if ok else 1
    if args.command == "import":
        import_file(args.daemon, args.path, args.url, args.tag, args.application)
    elif args.command == "export":
        export_file(args.daemon, args.url, args.output, args.tag, args.application, args.local_only)
    elif args.command == "delete":
        delete(args.daemon, args.url, args.tag, args.application)
    return 0


if __name__ == "__main__":
    sys.exit(main())
