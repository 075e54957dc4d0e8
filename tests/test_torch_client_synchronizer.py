"""The reference's ``tests/test_synchronizer.py``, case for case, on the port's
modules (``dragonfly2_torch``).

Piece-metadata synchronizer + cross-task traffic shaper (reference
peertask_piecetask_synchronizer.go, traffic_shaper.go:126-175)."""

import os
import threading
import time

import pytest

from dragonfly2_torch.client.piece_manager import ParentInfo, RateLimiter, TrafficShaper


# ---------------------------------------------------------------------------
# Traffic shaper
# ---------------------------------------------------------------------------


def test_limiter_tracks_usage_and_rate_change():
    lim = RateLimiter(0)  # unlimited
    lim.acquire(100)
    lim.acquire(50)
    assert lim.take_usage() == 150
    assert lim.take_usage() == 0
    lim.set_rate(1000)
    assert lim.rate == 1000


def test_shaper_fair_share_on_join_and_release():
    sh = TrafficShaper(total_rate=1000.0)
    a = sh.limiter_for("task-a")
    assert a.rate == pytest.approx(1000.0)
    b = sh.limiter_for("task-b")
    assert a.rate == pytest.approx(500.0)
    assert b.rate == pytest.approx(500.0)
    sh.release("task-a")
    # b keeps its rate until the next sample rebalances
    sh.sample_once()
    assert b.rate == pytest.approx(1000.0)


def test_shaper_reallocates_surplus_to_hot_task():
    sh = TrafficShaper(total_rate=1000.0, interval=1.0)
    hot = sh.limiter_for("hot")
    idle = sh.limiter_for("idle")
    # hot saturated its 500 B/s share this window; idle used almost nothing
    hot.consumed = 500
    idle.consumed = 10
    sh.sample_once()
    assert hot.rate > 900  # fair share + idle's surplus
    # donor clamped near demand so allocations sum to ≤ total
    assert idle.rate < 100
    assert hot.rate + idle.rate <= 1000.0 + 1e-6
    # next window: both saturate → no surplus → equal fair shares again
    hot.consumed = int(hot.rate)
    idle.consumed = 500
    sh.sample_once()
    assert hot.rate == pytest.approx(500.0)
    assert idle.rate == pytest.approx(500.0)


def test_limiter_actually_paces():
    lim = RateLimiter(100_000)  # 100 KB/s
    lim.acquire(100_000)  # drain the initial bucket
    t0 = time.monotonic()
    lim.acquire(20_000)  # needs ~0.2s of refill
    assert time.monotonic() - t0 > 0.1


def test_disabled_shaper_is_free():
    sh = TrafficShaper(0.0)
    assert not sh.enabled
    lim = sh.limiter_for("t")
    t0 = time.monotonic()
    lim.acquire(10**9)
    assert time.monotonic() - t0 < 0.05


# ---------------------------------------------------------------------------
# Synchronizer against a real daemon gRPC server
# ---------------------------------------------------------------------------


def test_synchronizer_tracks_parent_progress(tmp_path):
    """A parent that keeps finishing pieces after the scheduler snapshot:
    the child's ParentInfo must learn the new pieces over the sync
    stream, plus the task geometry."""
    from dragonfly2_torch.client.rpcserver import SERVICE_NAME, DfdaemonService
    from dragonfly2_torch.client.storage import StorageManager
    from dragonfly2_torch.client.synchronizer import PieceTaskSynchronizer
    from dragonfly2_torch.rpc.glue import serve

    storage = StorageManager(str(tmp_path / "parent"))
    piece = os.urandom(4096)
    ts = storage.register_task("task-sync", "peer-parent", url="https://o/x")
    ts.meta.content_length = 4096 * 4
    ts.meta.piece_length = 4096
    ts.write_piece(0, 0, piece, traffic_type="back_to_source")

    service = DfdaemonService(
        task_manager=None, storage=storage, upload_addr="127.0.0.1:1"
    )
    server, port = serve({SERVICE_NAME: service})
    try:
        parent = ParentInfo(peer_id="peer-parent", upload_addr="x", finished_pieces={0})
        sync = PieceTaskSynchronizer("task-sync", "peer-child", interval=0.05)
        sync.watch(parent, f"127.0.0.1:{port}")

        # parent finishes more pieces — the child must see them appear
        ts.write_piece(1, 4096, piece, traffic_type="remote_peer")
        ts.write_piece(2, 8192, piece, traffic_type="remote_peer")
        deadline = time.time() + 5
        while time.time() < deadline and not {1, 2} <= parent.finished_pieces:
            time.sleep(0.05)
        assert {0, 1, 2} <= parent.finished_pieces
        sync.stop()
    finally:
        server.stop(0)


def test_synchronizer_survives_unreachable_parent():
    from dragonfly2_torch.client.synchronizer import PieceTaskSynchronizer

    parent = ParentInfo(peer_id="p", upload_addr="x")
    sync = PieceTaskSynchronizer("t", "child")
    sync.watch(parent, "127.0.0.1:1")  # nothing listens there
    time.sleep(0.3)
    sync.stop()  # no exception, no hang
    assert parent.finished_pieces == set()


def test_p2p_download_with_shaped_traffic(tmp_path):
    """E2E: a rate-limited daemon still completes a P2P download and the
    shaper saw its bytes."""
    from dragonfly2_torch.client import dfget
    from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_torch.rpc.glue import serve
    from dragonfly2_torch.scheduler import resource as res
    from dragonfly2_torch.scheduler.evaluator import BaseEvaluator
    from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
    from dragonfly2_torch.scheduler.service import SERVICE_NAME, SchedulerService

    resource = res.Resource()
    service = SchedulerService(
        resource, Scheduling(BaseEvaluator(), SchedulingConfig(retry_interval=0.0))
    )
    server, port = serve({SERVICE_NAME: service})
    d = Daemon(
        DaemonConfig(
            data_dir=str(tmp_path / "daemon"),
            scheduler_address=f"127.0.0.1:{port}",
            hostname="host-shaped",
            piece_length=16 * 1024,
            announce_interval=60.0,
            total_download_rate=10 * 1024 * 1024,
        )
    )
    d.start()
    try:
        payload = os.urandom(64 * 1024)
        origin = tmp_path / "o.bin"
        origin.write_bytes(payload)
        out = tmp_path / "out.bin"
        dfget.download(f"127.0.0.1:{d.port}", f"file://{origin}", str(out))
        assert out.read_bytes() == payload
    finally:
        d.stop()
        server.stop(0)
