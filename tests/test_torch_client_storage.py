"""The reference's ``tests/test_client_storage.py``, case for case, on the port's
modules (``dragonfly2_torch``).

Client plane units: piece store, piece math, source clients, and the
upload-server ↔ piece-downloader HTTP pair (role parity: reference
client/daemon/storage + pkg/source + upload/piece_downloader tests)."""

import os

import pytest

from dragonfly2_torch.client import source
from dragonfly2_torch.client.downloader import PieceDownloadError, download_piece
from dragonfly2_torch.client.pieces import (
    compute_piece_length,
    DEFAULT_PIECE_LENGTH,
    MAX_PIECE_COUNT,
    piece_count,
    piece_ranges,
)
from dragonfly2_torch.client.storage import StorageError, StorageManager
from dragonfly2_torch.client.uploader import UploadServer


# ---------------------------------------------------------------------------
# piece math
# ---------------------------------------------------------------------------


def test_piece_length_default_and_scaling():
    assert compute_piece_length(-1) == DEFAULT_PIECE_LENGTH
    assert compute_piece_length(10 * DEFAULT_PIECE_LENGTH) == DEFAULT_PIECE_LENGTH
    huge = DEFAULT_PIECE_LENGTH * MAX_PIECE_COUNT * 4
    assert compute_piece_length(huge) == DEFAULT_PIECE_LENGTH * 4


def test_piece_ranges_cover_exactly():
    prs = piece_ranges(10_000, 4_096)
    assert piece_count(10_000, 4_096) == 3
    assert [p.length for p in prs] == [4096, 4096, 10_000 - 2 * 4096]
    assert prs[-1].offset + prs[-1].length == 10_000


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------


def test_storage_write_read_store_roundtrip(tmp_path):
    sm = StorageManager(str(tmp_path / "data"))
    ts = sm.register_task("t" * 64, "peer-1", url="file:///x", piece_length=4)
    payload = b"hello world!"
    for pr in piece_ranges(len(payload), 4):
        ts.write_piece(pr.number, pr.offset, payload[pr.offset : pr.offset + pr.length])
    assert ts.read_piece(0) == b"hell"
    ts.mark_done(len(payload))
    assert ts.read_all() == payload
    out = tmp_path / "out.bin"
    ts.store(str(out))
    assert out.read_bytes() == payload


def test_storage_digest_verification(tmp_path):
    sm = StorageManager(str(tmp_path))
    ts = sm.register_task("a" * 64, "peer-1")
    with pytest.raises(StorageError, match="digest mismatch"):
        ts.write_piece(0, 0, b"data", digest="md5:deadbeef")


def test_storage_recovery_after_restart(tmp_path):
    """Persisted tasks are reusable after daemon restart (reference
    peertask_reuse.go resume)."""
    sm = StorageManager(str(tmp_path))
    ts = sm.register_task("b" * 64, "peer-1", piece_length=4)
    ts.write_piece(0, 0, b"data")
    ts.mark_done(4)

    sm2 = StorageManager(str(tmp_path))
    again = sm2.find_completed_task("b" * 64)
    assert again is not None
    assert again.read_all() == b"data"


def test_storage_reclaimer_evicts_lru(tmp_path):
    sm = StorageManager(str(tmp_path), max_bytes=6)
    for i, tid in enumerate(["c" * 64, "d" * 64, "e" * 64]):
        ts = sm.register_task(tid, f"peer-{i}", piece_length=4)
        ts.write_piece(0, 0, b"1234")
        ts.mark_done(4)
        ts.meta.access_time = i  # oldest first
    evicted = sm.reclaim()
    assert evicted == 2
    assert sm.load("e" * 64) is not None
    assert sm.load("c" * 64) is None


# ---------------------------------------------------------------------------
# source clients
# ---------------------------------------------------------------------------


def test_file_source_metadata_download_range(tmp_path):
    p = tmp_path / "origin.bin"
    p.write_bytes(bytes(range(256)))
    url = f"file://{p}"
    client = source.client_for(url)
    meta = client.metadata(url)
    assert meta.content_length == 256 and meta.support_range
    assert b"".join(client.download(url)) == bytes(range(256))
    assert b"".join(client.download(url, offset=10, length=5)) == bytes(range(10, 15))


def test_file_source_list(tmp_path):
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.txt").write_bytes(b"aa")
    (tmp_path / "sub" / "b.txt").write_bytes(b"bb")
    entries = source.client_for(f"file://{tmp_path}").list(f"file://{tmp_path}")
    names = {(e.name, e.is_dir) for e in entries}
    assert names == {("a.txt", False), ("sub", True)}


def test_unavailable_scheme_raises():
    # every declared protocol has a real client now; unknown schemes
    # still fail loudly rather than silently falling through
    with pytest.raises(source.SourceError, match="no source client"):
        source.client_for("ftp://host/x").metadata("ftp://host/x")


def test_http_source_roundtrip(tmp_path):
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    payload = os.urandom(10_000)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _common(self):
            rng = self.headers.get("Range")
            if rng:
                start, end = rng.removeprefix("bytes=").split("-")
                start = int(start)
                end = int(end) if end else len(payload) - 1
                body = payload[start : end + 1]
                self.send_response(206)
            else:
                body = payload
                self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Accept-Ranges", "bytes")
            self.end_headers()
            return body

        def do_HEAD(self):
            self._common()

        def do_GET(self):
            self.wfile.write(self._common())

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/blob"
        client = source.client_for(url)
        meta = client.metadata(url)
        assert meta.content_length == len(payload) and meta.support_range
        assert b"".join(client.download(url)) == payload
        assert b"".join(client.download(url, offset=100, length=50)) == payload[100:150]
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# upload server ↔ piece downloader
# ---------------------------------------------------------------------------


def test_upload_download_piece_roundtrip(tmp_path):
    sm = StorageManager(str(tmp_path))
    ts = sm.register_task("f" * 64, "parent-peer", piece_length=8)
    payload = os.urandom(20)
    for pr in piece_ranges(len(payload), 8):
        ts.write_piece(pr.number, pr.offset, payload[pr.offset : pr.offset + pr.length])
    ts.mark_done(len(payload))

    server = UploadServer(sm)
    server.start()
    try:
        data, digest, _ = download_piece(server.address, "f" * 64, 1, peer_id="child")
        assert data == payload[8:16]
        assert digest.startswith("md5:")
        with pytest.raises(PieceDownloadError):
            download_piece(server.address, "0" * 64, 0)
    finally:
        server.stop()


def test_upload_server_rate_limit(tmp_path):
    """The upload server throttles body writes through a shared token
    bucket (reference upload totalRateLimit): serving 256 KiB at
    256 KiB/s must take ~1s, unlimited must be near-instant."""
    import time
    import urllib.request

    from dragonfly2_torch.client.storage import StorageManager
    from dragonfly2_torch.client.uploader import UploadServer

    payload = os.urandom(256 * 1024)
    storage = StorageManager(str(tmp_path / "store"))
    ts = storage.register_task(
        "task-rl", "peer-rl", url="file:///x", piece_length=64 * 1024,
        content_length=len(payload),
    )
    for n in range(4):
        ts.write_piece(n, n * 64 * 1024, payload[n * 65536 : (n + 1) * 65536])
    ts.mark_done(len(payload))

    fast = UploadServer(storage, port=0)
    fast.start()
    try:
        t0 = time.monotonic()
        with urllib.request.urlopen(
            f"http://{fast.address}/download/task-rl", timeout=10
        ) as r:
            assert r.read() == payload
        assert time.monotonic() - t0 < 1.0
    finally:
        fast.stop()

    # budget of HALF the payload per second: the pre-filled bucket
    # covers 128 KiB, the rest must wait ~1s of refill
    slow = UploadServer(storage, port=0, rate_limit_bps=128 * 1024)
    slow.start()
    try:
        t0 = time.monotonic()
        with urllib.request.urlopen(
            f"http://{slow.address}/download/task-rl", timeout=30
        ) as r:
            assert r.read() == payload
        elapsed = time.monotonic() - t0
        assert elapsed >= 0.5, f"rate limit had no effect ({elapsed:.2f}s)"
    finally:
        slow.stop()


def test_reclaimer_never_evicts_busy_incomplete_tasks(tmp_path):
    """A live conductor's incomplete task is never an eviction candidate
    no matter how stale its access time; abandoned (crash-leftover)
    incomplete tasks past the TTL are."""
    import time as _time

    from dragonfly2_torch.client.storage import StorageManager

    sm = StorageManager(str(tmp_path / "s"), max_bytes=1, abandoned_ttl=100.0)
    live = sm.register_task("t-live", "p1", url="u", piece_length=4, content_length=8)
    live.busy = True
    live.write_piece(0, 0, b"aaaa")
    dead = sm.register_task("t-dead", "p2", url="u", piece_length=4, content_length=8)
    dead.write_piece(0, 0, b"bbbb")
    old = _time.time() - 1000
    live.meta.access_time = old
    dead.meta.access_time = old

    evicted = sm.reclaim()
    assert evicted == 1
    assert "t-live" in sm.tasks and "t-dead" not in sm.tasks
