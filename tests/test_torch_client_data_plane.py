"""The reference's ``tests/test_data_plane.py``, case for case, on the port's
modules (``dragonfly2_torch``). The proxy transport's in-flight bound is
held in ``tests/test_torch_proxy.py`` with the rest of the transport; the
reference's last two cases (the ``tools.stress`` data-plane soak and race)
wait for the module they drive (ROADMAP queue A item 13).

Zero-copy data plane (docs/data-plane.md): the sendfile
upload loop, the readiness-based transfer pool, content-addressed piece
dedup with refcounted GC, and the soak/bench gates."""

import os
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from dragonfly2_torch.client import transfer
from dragonfly2_torch.client.downloader import PieceDownloadError, download_piece
from dragonfly2_torch.client.pieces import piece_ranges
from dragonfly2_torch.client.storage import StorageManager
from dragonfly2_torch.client.uploader import UploadServer
from dragonfly2_torch.client import metrics as M


def _seed_task(sm, task_id, payload, piece_length):
    ts = sm.register_task(task_id, f"peer-{task_id[:4]}", piece_length=piece_length)
    for pr in piece_ranges(len(payload), piece_length):
        ts.write_piece(pr.number, pr.offset, payload[pr.offset:pr.offset + pr.length])
    ts.mark_done(len(payload))
    return ts


# ---------------------------------------------------------------------------
# upload loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_sendfile", [True, False])
def test_piece_and_whole_object_roundtrip(tmp_path, use_sendfile):
    """Both serve arms (zero-copy sendfile and the buffered fallback)
    produce byte-identical pieces and whole objects."""
    sm = StorageManager(str(tmp_path))
    payload = os.urandom(300 * 1024 + 17)
    _seed_task(sm, "a" * 64, payload, 64 * 1024)
    srv = UploadServer(sm, use_sendfile=use_sendfile)
    srv.start()
    try:
        data, digest, _ = download_piece(srv.address, "a" * 64, 1, peer_id="c")
        assert data == payload[64 * 1024: 128 * 1024]
        assert digest.startswith("md5:")
        with urllib.request.urlopen(
            f"http://{srv.address}/download/{'a' * 64}", timeout=10
        ) as r:
            assert r.read() == payload
    finally:
        srv.stop()


def test_keep_alive_serves_multiple_requests_on_one_socket(tmp_path):
    sm = StorageManager(str(tmp_path))
    payload = os.urandom(8 * 1024)
    _seed_task(sm, "b" * 64, payload, 1024)
    srv = UploadServer(sm)
    srv.start()
    try:
        s = socket.create_connection((srv.host, srv.port), timeout=5)
        for number in (0, 3, 7):
            s.sendall(
                f"GET /download/{'b' * 64}?number={number}&peerId=k HTTP/1.1\r\n"
                "Host: x\r\n\r\n".encode()
            )
            buf = b""
            while b"\r\n\r\n" not in buf:
                buf += s.recv(65536)
            head, body = buf.split(b"\r\n\r\n", 1)
            length = int(
                [l for l in head.split(b"\r\n") if l.lower().startswith(b"content-length")][0]
                .split(b":")[1]
            )
            while len(body) < length:
                body += s.recv(65536)
            assert body == payload[number * 1024: (number + 1) * 1024]
        s.close()
    finally:
        srv.stop()


def test_open_ended_range_with_unknown_content_length(tmp_path):
    """Regression: ``Range: bytes=N-`` on a task whose
    content_length is still unknown must serve to the current
    end-of-data, not 416 a valid request."""
    sm = StorageManager(str(tmp_path))
    ts = sm.register_task("c" * 64, "p", piece_length=1024)  # content_length -1
    payload = os.urandom(4096)
    for pr in piece_ranges(len(payload), 1024):
        ts.write_piece(pr.number, pr.offset, payload[pr.offset:pr.offset + pr.length])
    assert ts.meta.content_length == -1
    srv = UploadServer(sm)
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://{srv.address}/download/{'c' * 64}",
            headers={"Range": "bytes=1000-"},
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 206
            assert r.read() == payload[1000:]
    finally:
        srv.stop()


def test_range_beyond_data_still_416s(tmp_path):
    sm = StorageManager(str(tmp_path))
    _seed_task(sm, "d" * 64, b"x" * 100, 50)
    srv = UploadServer(sm)
    srv.start()
    try:
        req = urllib.request.Request(
            f"http://{srv.address}/download/{'d' * 64}",
            headers={"Range": "bytes=oops"},
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 416
    finally:
        srv.stop()


def test_child_disconnect_mid_body_is_counted_not_raised(tmp_path):
    """A child dropping mid-body increments
    daemon_child_disconnect_total and lands a daemon.child_disconnect
    flight event — never a handler traceback."""
    from dragonfly2_torch.utils import flight

    sm = StorageManager(str(tmp_path))
    payload = os.urandom(4 * 1024 * 1024)  # big enough to outlive a recv
    _seed_task(sm, "e" * 64, payload, 4 * 1024 * 1024)
    # a rate limit guarantees the body is still in flight when we bail
    srv = UploadServer(sm, rate_limit_bps=512 * 1024)
    srv.start()
    prev_enabled = flight.enabled()
    flight.set_enabled(True)
    before = M.CHILD_DISCONNECT_TOTAL.value
    try:
        s = socket.create_connection((srv.host, srv.port), timeout=5)
        s.sendall(
            f"GET /download/{'e' * 64}?number=0&peerId=gone HTTP/1.1\r\n"
            "Host: x\r\n\r\n".encode()
        )
        s.recv(1024)  # first bytes are flowing
        s.close()  # vanish mid-body
        deadline = time.monotonic() + 10
        while M.CHILD_DISCONNECT_TOTAL.value == before:
            assert time.monotonic() < deadline, "disconnect never counted"
            time.sleep(0.05)
        events = flight.snapshot(["daemon"]).get("daemon", [])
        assert any(e["type"] == "daemon.child_disconnect" for e in events)
    finally:
        flight.set_enabled(prev_enabled)
        srv.stop()


def test_concurrent_children_split_the_rate_budget(tmp_path):
    """N children share ONE upload token bucket: aggregate throughput
    stays at (not N×) the budget."""
    piece = 128 * 1024
    rate = 256 * 1024.0
    sm = StorageManager(str(tmp_path))
    payload = os.urandom(piece * 2)
    _seed_task(sm, "f" * 64, payload, piece)
    srv = UploadServer(sm, rate_limit_bps=rate)
    srv.start()
    results = []
    lock = threading.Lock()

    def child(number):
        data, _, _ = download_piece(srv.address, "f" * 64, number, timeout=30)
        with lock:
            results.append(data)

    try:
        t0 = time.monotonic()
        threads = [threading.Thread(target=child, args=(i % 2,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        elapsed = time.monotonic() - t0
        assert len(results) == 4
        for i, data in enumerate(results):
            assert data in (payload[:piece], payload[piece:])
        # 4 × 128 KiB = 512 KiB through a 256 KiB/s bucket (256 KiB
        # pre-filled): ≥ ~1s of refill must have been waited out
        assert elapsed >= 0.8, f"rate budget not shared: {elapsed:.2f}s"
    finally:
        srv.stop()


def test_upload_loop_serves_while_another_child_is_throttled(tmp_path):
    """Single-threaded loop, no head-of-line blocking: a rate-limited
    transfer parks on a timer; an unlimited error response on another
    connection answers immediately."""
    sm = StorageManager(str(tmp_path))
    payload = os.urandom(1024 * 1024)
    _seed_task(sm, "a1" + "0" * 62, payload, 1024 * 1024)
    srv = UploadServer(sm, rate_limit_bps=256 * 1024)
    srv.start()
    try:
        slow = socket.create_connection((srv.host, srv.port), timeout=5)
        slow.sendall(
            f"GET /download/{'a1' + '0' * 62}?number=0&peerId=s HTTP/1.1\r\n"
            "Host: x\r\n\r\n".encode()
        )
        slow.recv(1024)  # transfer underway (and now throttled)
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://{srv.address}/download/{'9' * 64}", timeout=5
            )
        assert ei.value.code == 404
        assert time.monotonic() - t0 < 2.0, "404 stuck behind a throttled body"
        slow.close()
    finally:
        srv.stop()


def test_prof_phases_tick_on_piece_serve(tmp_path):
    from dragonfly2_torch.utils import profiling

    serve = profiling.phase_type("daemon.piece_serve")
    sendfile_ph = profiling.phase_type("daemon.piece_sendfile")
    before = serve.count
    before_sf = sendfile_ph.count
    sm = StorageManager(str(tmp_path))
    _seed_task(sm, "ab" + "0" * 62, os.urandom(2048), 1024)
    srv = UploadServer(sm)
    srv.start()
    try:
        download_piece(srv.address, "ab" + "0" * 62, 0)
    finally:
        srv.stop()
    assert serve.count > before
    assert sendfile_ph.count > before_sf


# ---------------------------------------------------------------------------
# transfer pool
# ---------------------------------------------------------------------------


def test_pool_reuses_keep_alive_connection(tmp_path):
    sm = StorageManager(str(tmp_path))
    _seed_task(sm, "aa" + "0" * 62, os.urandom(4096), 1024)
    srv = UploadServer(sm)
    srv.start()
    pool = transfer.TransferPool()
    try:
        for n in range(4):
            status, headers, body = pool.fetch(
                srv.address, f"/download/{'aa' + '0' * 62}?number={n}&peerId=x"
            )
            assert status == 200 and len(body) == 1024
        # sequential fetches ride ONE parked connection
        idle = sum(len(v) for v in pool._idle.values())
        assert idle == 1, pool._idle
    finally:
        pool.stop()
        srv.stop()


def test_pool_retries_stale_keep_alive_socket(tmp_path):
    """A parent closing an idle pooled socket between requests must cost
    a transparent retry, not a piece failure."""
    sm = StorageManager(str(tmp_path))
    _seed_task(sm, "ac" + "0" * 62, os.urandom(1024), 1024)
    srv = UploadServer(sm)
    srv.start()
    pool = transfer.TransferPool()
    try:
        status, _, _ = pool.fetch(
            srv.address, f"/download/{'ac' + '0' * 62}?number=0&peerId=x"
        )
        assert status == 200
        # kill the parked server-side socket under the pool
        srv.stop()
        sm2_dir = str(tmp_path / "second")
        sm2 = StorageManager(sm2_dir)
        _seed_task(sm2, "ac" + "0" * 62, os.urandom(1024), 1024)
        srv2 = UploadServer(sm2, port=srv.port)  # same port, fresh loop
        srv2.start()
        try:
            status, _, body = pool.fetch(
                srv.address, f"/download/{'ac' + '0' * 62}?number=0&peerId=x"
            )
            assert status == 200 and len(body) == 1024
        finally:
            srv2.stop()
    finally:
        pool.stop()


def test_pool_times_out_against_a_black_hole():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)  # accepts but never answers
    addr = f"127.0.0.1:{srv.getsockname()[1]}"
    pool = transfer.TransferPool()
    try:
        t0 = time.monotonic()
        with pytest.raises(transfer.TransferError, match="timed out"):
            pool.fetch(addr, "/download/x?number=0", timeout=1.5)
        assert time.monotonic() - t0 < 10
    finally:
        pool.stop()
        srv.close()


def test_pool_release_idle_drops_parked_connections(tmp_path):
    sm = StorageManager(str(tmp_path))
    _seed_task(sm, "ad" + "0" * 62, os.urandom(1024), 1024)
    srv = UploadServer(sm)
    srv.start()
    pool = transfer.TransferPool()
    try:
        pool.fetch(srv.address, f"/download/{'ad' + '0' * 62}?number=0&peerId=x")
        assert sum(len(v) for v in pool._idle.values()) == 1
        pool.release_idle([srv.address])
        deadline = time.monotonic() + 5
        while sum(len(v) for v in pool._idle.values()):
            assert time.monotonic() < deadline
            time.sleep(0.02)
    finally:
        pool.stop()
        srv.stop()


# ---------------------------------------------------------------------------
# content-addressed dedup
# ---------------------------------------------------------------------------


def test_dedup_stores_shared_piece_bytes_once(tmp_path):
    """Two tasks carrying an identical-digest piece store the bytes
    once, verified on-disk: the second task's data file has a sparse
    hole (no allocated blocks) where the ref lives."""
    piece = 256 * 1024
    shared = os.urandom(piece)
    sm = StorageManager(str(tmp_path))
    a = sm.register_task("a" * 64, "p1", piece_length=piece)
    a.write_piece(0, 0, shared)
    a.mark_done(piece)
    b = sm.register_task("b" * 64, "p2", piece_length=piece)
    b.write_piece(0, 0, shared)
    b.write_piece(1, piece, os.urandom(piece))
    b.mark_done(2 * piece)

    assert b.meta.pieces[0].ref_task == "a" * 64
    assert b.read_all()[:piece] == shared
    # on-disk proof: b's file allocates ~one piece of blocks, not two
    blocks_b = os.stat(b.data_path).st_blocks * 512
    assert blocks_b < 1.5 * piece, f"no sparse hole: {blocks_b} bytes allocated"
    assert M.PIECE_DEDUP_TOTAL.value > 0


def test_dedup_served_over_http_resolves_refs(tmp_path):
    piece = 64 * 1024
    shared = os.urandom(piece)
    sm = StorageManager(str(tmp_path))
    a = sm.register_task("a" * 64, "p1", piece_length=piece)
    a.write_piece(0, 0, shared)
    a.mark_done(piece)
    b = sm.register_task("b" * 64, "p2", piece_length=piece)
    b.write_piece(0, 0, shared)
    b.mark_done(piece)
    srv = UploadServer(sm)
    srv.start()
    try:
        data, _, _ = download_piece(srv.address, "b" * 64, 0)
        assert data == shared
    finally:
        srv.stop()


def test_dedup_refcount_gc_migrates_then_reclaims(tmp_path):
    """Delete the owning task → the shared piece migrates to the
    referrer and survives; delete the referrer too → bytes reclaimed."""
    piece = 64 * 1024
    shared = os.urandom(piece)
    sm = StorageManager(str(tmp_path))
    a = sm.register_task("a" * 64, "p1", piece_length=piece)
    a.write_piece(0, 0, shared)
    a.mark_done(piece)
    b = sm.register_task("b" * 64, "p2", piece_length=piece)
    b.write_piece(0, 0, shared)
    b.mark_done(piece)
    assert b.meta.pieces[0].ref_task

    sm.delete_task("a" * 64)
    assert sm.load("a" * 64) is None
    assert b.meta.pieces[0].ref_task == ""  # b owns the bytes now
    assert b.read_piece(0) == shared
    assert M.PIECE_DEDUP_MIGRATE_TOTAL.value > 0

    sm.delete_task("b" * 64)
    assert sm.piece_index.stats()["digests"] == 0
    leftovers = [
        f for _, _, files in os.walk(str(tmp_path)) for f in files if f == "data"
    ]
    assert not leftovers, "bytes survived the last referent"


def test_dedup_recovery_after_crash_drops_unresolvable_refs(tmp_path):
    """Crash-mid-write recovery on the new index: a persisted ref whose
    owner vanished (crash between owner GC and referrer re-point) is
    dropped on reload — the task resumes and refetches, never serves a
    hole."""
    import shutil

    piece = 4096
    shared = os.urandom(piece)
    sm = StorageManager(str(tmp_path))
    a = sm.register_task("a" * 64, "p1", piece_length=piece)
    a.write_piece(0, 0, shared)
    b = sm.register_task("b" * 64, "p2", piece_length=piece)
    b.write_piece(0, 0, shared)
    b.write_piece(1, piece, os.urandom(piece))
    b.persist()
    assert b.meta.pieces[0].ref_task
    # crash: the OWNER's directory disappears without any migration
    shutil.rmtree(a.dir, ignore_errors=True)

    sm2 = StorageManager(str(tmp_path))
    b2 = sm2.load("b" * 64)
    assert b2 is not None
    assert 0 not in b2.meta.pieces, "unresolvable ref survived recovery"
    assert 1 in b2.meta.pieces  # the physically-owned piece is intact
    # and the piece can be re-written (resume path)
    b2.write_piece(0, 0, shared)
    assert b2.read_piece(0) == shared


def test_dedup_disabled_by_flag(tmp_path):
    piece = 4096
    shared = os.urandom(piece)
    sm = StorageManager(str(tmp_path), dedup=False)
    a = sm.register_task("a" * 64, "p1", piece_length=piece)
    a.write_piece(0, 0, shared)
    b = sm.register_task("b" * 64, "p2", piece_length=piece)
    b.write_piece(0, 0, shared)
    assert b.meta.pieces[0].ref_task == ""


def test_dedup_mismatched_length_never_aliases(tmp_path):
    """Same digest is only trusted at the same length (belt and
    braces against a pathological collision)."""
    sm = StorageManager(str(tmp_path))
    holder = sm.piece_index
    holder.record_holder("md5:x", 10, "t1", 0)
    assert holder.find_holder("md5:x", 11) is None
    assert holder.find_holder("md5:x", 10, exclude_task="t1") is None
