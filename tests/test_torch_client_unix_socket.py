"""The reference's ``tests/test_unix_socket.py``, case for case, on the port's
modules (``dragonfly2_torch``).

Unix-socket daemon serving + dfget spawn-or-reuse (reference
pkg/rpc/mux.go tcp+unix mux; cmd/dfget/cmd/root.go:279
checkAndSpawnDaemon)."""

import http.server
import os
import threading

import pytest

from dragonfly2_torch.client import dfget
from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_torch.rpc.glue import serve
from dragonfly2_torch.scheduler import resource as res
from dragonfly2_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
from dragonfly2_torch.scheduler.service import SERVICE_NAME as SCHED_SERVICE
from dragonfly2_torch.scheduler.service import SchedulerService
from dragonfly2_torch.scheduler.storage import Storage

PAYLOAD = os.urandom(96 * 1024)


@pytest.fixture
def sched(tmp_path):
    resource = res.Resource()
    service = SchedulerService(
        resource,
        Scheduling(
            BaseEvaluator(),
            SchedulingConfig(retry_interval=0.0, retry_back_to_source_limit=1),
        ),
        storage=Storage(tmp_path / "sched", buffer_size=1),
    )
    server, port = serve({SCHED_SERVICE: service})
    yield f"127.0.0.1:{port}"
    server.stop(grace=None)


def test_daemon_serves_unix_socket(sched, tmp_path):
    """The same dfdaemon gRPC answers on TCP and the unix socket, and
    dfget downloads through the socket path."""
    sock = tmp_path / "run" / "dfdaemon.sock"
    origin = tmp_path / "origin.bin"
    origin.write_bytes(PAYLOAD)
    d = Daemon(
        DaemonConfig(
            data_dir=str(tmp_path / "daemon"),
            scheduler_address=sched,
            hostname="h-unix",
            ip="127.0.0.1",
            unix_socket=str(sock),
            piece_length=32 * 1024,
            schedule_timeout=5.0,
            announce_interval=60.0,
        )
    )
    d.start()
    try:
        assert sock.exists()
        out = tmp_path / "out.bin"
        dfget.download(f"unix:{sock}", f"file://{origin}", str(out))
        assert out.read_bytes() == PAYLOAD
        # TCP listener still answers too
        assert dfget.daemon_alive(f"127.0.0.1:{d.port}")
    finally:
        d.stop()


def test_ensure_daemon_spawns_and_reuses(sched, tmp_path):
    """ensure_daemon forks a real daemon subprocess on a dead socket and
    is a no-op when one already answers."""
    sock = tmp_path / "spawn" / "dfdaemon.sock"
    addr = f"unix:{sock}"
    assert not dfget.daemon_alive(addr, timeout=0.5)
    spawned = dfget.ensure_daemon(
        addr, sched, str(tmp_path / "spawned-daemon"), wait=20.0
    )
    assert spawned is True
    try:
        assert dfget.daemon_alive(addr)
        # the spawned binary is the port's daemon, never the reference's
        import subprocess

        pids = subprocess.run(["pgrep", "-f", str(sock)], capture_output=True, text=True).stdout.split()
        cmdlines = [open(f"/proc/{p}/cmdline", "rb").read().replace(b"\0", b" ").decode() for p in pids]
        assert cmdlines and all(
            "-m dragonfly2_torch.client.daemon" in c and "dragonfly2_tpu" not in c for c in cmdlines
        ), cmdlines
        # an answering daemon is reused, not respawned
        assert dfget.ensure_daemon(addr, sched, str(tmp_path / "x")) is False
        # and a real download works through the spawned daemon
        origin = tmp_path / "o2.bin"
        origin.write_bytes(PAYLOAD)
        out = tmp_path / "out2.bin"
        dfget.download(addr, f"file://{origin}", str(out))
        assert out.read_bytes() == PAYLOAD
    finally:
        import signal
        import subprocess

        # the daemon was started detached; find and stop it via its socket
        subprocess.run(
            ["pkill", "-f", str(sock)], check=False
        )


def test_dfcache_spawn_daemon(sched, tmp_path):
    """dfcache shares dfget's spawn-or-reuse: import a blob through a
    daemon it spawned itself on the unix socket, then stat it."""
    from dragonfly2_torch.client import dfcache

    sock = tmp_path / "cache" / "dfd.sock"
    addr = f"unix:{sock}"
    blob = tmp_path / "blob.bin"
    blob.write_bytes(PAYLOAD)
    try:
        rc = dfcache.main([
            "import", "d7y://cache-blob", "--path", str(blob),
            "--daemon", addr, "--spawn-daemon", "--scheduler", sched,
            "--daemon-data-dir", str(tmp_path / "spawned"),
        ])
        assert rc == 0
        rc = dfcache.main(["stat", "d7y://cache-blob", "--daemon", addr])
        assert rc == 0  # cached
    finally:
        import subprocess

        subprocess.run(["pkill", "-f", str(sock)], check=False)
