"""The port's client modules (``dragonfly2_torch.client``) against the
reference's (``dragonfly2_tpu.client``) on the same inputs: piece math and
digests, the source clients on a local HTTP origin and on ``file://``, the
piece store's bytes and metadata, the rate limiter and the traffic shaper
under one scripted clock, the host-stat overrides, the piece-metadata
synchronizer across packages, the wire between the two packages' daemons
(piece fetches, P2P downloads and dfget, both ways), the download records a
port daemon's download writes against a reference daemon's (the daemon's
``kv_address`` is held to the reference's in ``tests/test_torch_fleet.py``)."""

from __future__ import annotations

import dataclasses
import hashlib
import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dragonfly2_torch.client import daemon as t_daemon
from dragonfly2_torch.client import dfget as t_dfget
from dragonfly2_torch.client import downloader as t_downloader
from dragonfly2_torch.client import piece_manager as t_pm
from dragonfly2_torch.client import pieces as t_pieces
from dragonfly2_torch.client import rpcserver as t_rpcserver
from dragonfly2_torch.client import source as t_source
from dragonfly2_torch.client import storage as t_storage
from dragonfly2_torch.client import synchronizer as t_sync
from dragonfly2_torch.client import uploader as t_uploader
from dragonfly2_torch.client import hostinfo as t_hostinfo
from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.scheduler import resource as t_res
from dragonfly2_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
from dragonfly2_torch.scheduler.service import SERVICE_NAME as SCHED_SERVICE
from dragonfly2_torch.scheduler.service import SchedulerService
from dragonfly2_torch.scheduler.storage import Storage
from dragonfly2_torch.utils import digest as t_digest
from dragonfly2_torch.utils import profiling as t_profiling

from dragonfly2_tpu.client import daemon as j_daemon
from dragonfly2_tpu.client import dfget as j_dfget
from dragonfly2_tpu.client import downloader as j_downloader
from dragonfly2_tpu.client import hostinfo as j_hostinfo
from dragonfly2_tpu.client import piece_manager as j_pm
from dragonfly2_tpu.client import pieces as j_pieces
from dragonfly2_tpu.client import rpcserver as j_rpcserver
from dragonfly2_tpu.client import source as j_source
from dragonfly2_tpu.client import storage as j_storage
from dragonfly2_tpu.client import synchronizer as j_sync
from dragonfly2_tpu.client import uploader as j_uploader
from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.utils import digest as j_digest
from dragonfly2_tpu.utils import profiling as j_profiling

PIECE = 64 * 1024
PAYLOAD = random.Random(0).randbytes(300 * 1024)  # 5 pieces at 64 KiB


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # each package's daemons and servers start its process-wide stack sampler
    # and leave it running, as a server process would; stop both once the
    # module is done so their sweeps do not tax the files run after it in
    # this process
    yield
    t_profiling.stop()
    j_profiling.stop()


def _outcome(fn, *args):
    """fn(*args) → ("ok", value) or ("raise", exception class name, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the two packages' exception classes differ by module
        return ("raise", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# pieces and digests
# ---------------------------------------------------------------------------

_SPECS = st.one_of(
    st.text(alphabet="0123456789-= bytes", max_size=16),
    st.builds(lambda a, b, p: f"{p}{a}-{b}", st.integers(0, 10**9), st.integers(0, 10**9),
              st.sampled_from(["", "bytes=", " "])),
    st.builds(lambda n, p: f"{p}-{n}", st.integers(0, 10**9), st.sampled_from(["", "bytes="])),
    st.builds(lambda n: f"{n}-", st.integers(0, 10**9)),
)


@settings(max_examples=300, deadline=None)
@given(spec=_SPECS, total=st.integers(0, 10**9))
def test_byte_range_forms_match_the_reference(spec, total):
    for name in ("parse_byte_range", "normalize_byte_range"):
        assert _outcome(getattr(t_pieces, name), spec) == _outcome(getattr(j_pieces, name), spec)
    assert _outcome(t_pieces.resolve_byte_range, spec, total) == _outcome(
        j_pieces.resolve_byte_range, spec, total
    )


@settings(max_examples=300, deadline=None)
@given(length=st.integers(-5, 1 << 44), piece=st.integers(1, 1 << 26))
def test_piece_geometry_matches_the_reference(length, piece):
    assert t_pieces.compute_piece_length(length) == j_pieces.compute_piece_length(length)
    assert t_pieces.piece_count(length, piece) == j_pieces.piece_count(length, piece)
    if t_pieces.piece_count(length, piece) <= 4096:
        assert [dataclasses.astuple(p) for p in t_pieces.piece_ranges(length, piece)] == [
            dataclasses.astuple(p) for p in j_pieces.piece_ranges(length, piece)
        ]


def test_piece_constants_and_seeded_geometry():
    assert (t_pieces.DEFAULT_PIECE_LENGTH, t_pieces.MAX_PIECE_COUNT) == (4 << 20, 2048)
    assert (t_pieces.DEFAULT_PIECE_LENGTH, t_pieces.MAX_PIECE_COUNT) == (
        j_pieces.DEFAULT_PIECE_LENGTH, j_pieces.MAX_PIECE_COUNT,
    )
    rng = random.Random(1)
    for _ in range(200):
        length = rng.randrange(0, 1 << 36)
        pl = t_pieces.compute_piece_length(length)
        assert pl == j_pieces.compute_piece_length(length)
        assert t_pieces.piece_count(length, pl) <= t_pieces.MAX_PIECE_COUNT
    # a 1 GiB object: 4 MiB pieces, 256 of them
    assert t_pieces.compute_piece_length(1 << 30) == 4 << 20
    assert t_pieces.piece_count(1 << 30, 4 << 20) == 256


def test_digests_match_the_reference():
    rng = random.Random(2)
    for n in (0, 1, 63, 4096, 1 << 20):
        data = rng.randbytes(n)
        assert t_digest.sha256_from_bytes(data) == j_digest.sha256_from_bytes(data)
        assert t_digest.md5_from_bytes(data) == j_digest.md5_from_bytes(data)
        parts = [data[:n // 2].hex(), data[n // 2:].hex()]
        assert t_digest.sha256_from_strings(*parts) == j_digest.sha256_from_strings(*parts)
        for algo, fn in (("sha256", hashlib.sha256), ("md5", hashlib.md5)):
            pin = t_digest.digest_string(algo, fn(data).hexdigest())
            assert pin == j_digest.digest_string(algo, fn(data).hexdigest())
            assert t_digest.verify(data, pin) and j_digest.verify(data, pin)
            assert t_digest.verify(data + b"x", pin) == j_digest.verify(data + b"x", pin) is False
    for bad in ("", "sha1:abcd", "sha256:xyz", "md5:" + "0" * 31, "sha256", "md5:" + "g" * 32):
        assert _outcome(t_digest.parse_digest, bad) == _outcome(j_digest.parse_digest, bad)
    assert _outcome(t_digest.digest_string, "crc", "0") == _outcome(j_digest.digest_string, "crc", "0")


# ---------------------------------------------------------------------------
# source clients
# ---------------------------------------------------------------------------


@pytest.fixture
def http_origin():
    """An origin with Range, validators and a header gate on ``/private``."""
    body = PAYLOAD

    class Origin(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _head(self, status, length, extra=()):
            self.send_response(status)
            self.send_header("Content-Length", str(length))
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Last-Modified", "Wed, 21 Oct 2015 07:28:00 GMT")
            self.send_header("ETag", '"v1"')
            self.send_header("Content-Type", "application/octet-stream")
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()

        def _gate(self):
            if self.path.startswith("/private") and self.headers.get("X-Token") != "t0k":
                self.send_error(401)
                return False
            if self.path.startswith("/missing"):
                self.send_error(404)
                return False
            return True

        def do_HEAD(self):
            if self._gate():
                self._head(200, len(body))

        def do_GET(self):
            if not self._gate():
                return
            rng = self.headers.get("Range")
            if rng:
                lo, _, hi = rng.removeprefix("bytes=").partition("-")
                lo = int(lo)
                hi = int(hi) if hi else len(body) - 1
                part = body[lo : hi + 1]
                self._head(206, len(part), [("Content-Range", f"bytes {lo}-{hi}/{len(body)}")])
                self.wfile.write(part)
            else:
                self._head(200, len(body))
                self.wfile.write(body)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Origin)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _fetch(pkg, url, headers, offset, length):
    return b"".join(pkg.client_for(url).download(url, headers, offset, length))


def test_http_source_matches_the_reference(http_origin):
    for path, headers in (("/blob", None), ("/private/blob", {"X-Token": "t0k"})):
        url = http_origin + path
        assert dataclasses.asdict(t_source.client_for(url).metadata(url, headers)) == dataclasses.asdict(
            j_source.client_for(url).metadata(url, headers)
        )
        for offset, length in ((0, -1), (0, 1000), (4096, -1), (1000, 65536), (len(PAYLOAD) - 1, 1)):
            got = _fetch(t_source, url, headers, offset, length)
            assert got == _fetch(j_source, url, headers, offset, length)
            assert got == PAYLOAD[offset:] if length < 0 else got == PAYLOAD[offset : offset + length]
    # the header gate and a missing object fail alike (SourceError, same text)
    for path in ("/private/blob", "/missing"):
        url = http_origin + path
        t_got = _outcome(lambda: t_source.client_for(url).metadata(url))
        assert t_got[0] == "raise" and t_got == _outcome(lambda: j_source.client_for(url).metadata(url))
        t_got = _outcome(lambda: _fetch(t_source, url, None, 0, -1))
        assert t_got[0] == "raise" and t_got == _outcome(lambda: _fetch(j_source, url, None, 0, -1))
    url = http_origin + "/blob"
    assert _outcome(lambda: t_source.client_for(url).list(url)) == _outcome(
        lambda: j_source.client_for(url).list(url)
    )


def test_file_source_matches_the_reference(tmp_path):
    (tmp_path / "tree" / "sub").mkdir(parents=True)
    blob = tmp_path / "tree" / "blob.bin"
    blob.write_bytes(PAYLOAD)
    (tmp_path / "tree" / "sub" / "x.json").write_bytes(b"{}")
    url = f"file://{blob}"
    assert dataclasses.asdict(t_source.client_for(url).metadata(url)) == dataclasses.asdict(
        j_source.client_for(url).metadata(url)
    )
    for offset, length in ((0, -1), (7, 100), (PIECE, PIECE), (len(PAYLOAD), -1)):
        assert _fetch(t_source, url, None, offset, length) == _fetch(j_source, url, None, offset, length)
    tree = f"file://{tmp_path / 'tree'}"
    assert [dataclasses.asdict(e) for e in t_source.client_for(tree).list(tree)] == [
        dataclasses.asdict(e) for e in j_source.client_for(tree).list(tree)
    ]
    missing = f"file://{tmp_path / 'nope'}"
    t_got = _outcome(lambda: t_source.client_for(missing).metadata(missing))
    assert t_got[0] == "raise" and t_got == _outcome(lambda: j_source.client_for(missing).metadata(missing))
    assert _outcome(t_source.client_for, "gopher://x") == _outcome(j_source.client_for, "gopher://x")


# ---------------------------------------------------------------------------
# piece store
# ---------------------------------------------------------------------------


def _meta_fields(ts) -> dict:
    meta = dataclasses.asdict(ts.meta)
    for key in [k for k in meta if k.endswith(("_at", "_ns", "_time"))]:
        meta.pop(key)
    for p in meta.get("pieces", {}).values():
        p.pop("cost_ns", None)
    return meta


def test_storage_managers_write_alike(tmp_path):
    rng = random.Random(3)
    stores = {
        "torch": t_storage.StorageManager(str(tmp_path / "torch")),
        "jax": j_storage.StorageManager(str(tmp_path / "jax")),
    }
    tasks = [("a" * 64, 300 * 1024, 64 * 1024), ("b" * 64, 3, 4096), ("c" * 64, 1 << 20, 1 << 18)]
    datas = {tid: rng.randbytes(n) for tid, n, _ in tasks}
    order = {tid: rng.sample(range(t_pieces.piece_count(n, pl)), t_pieces.piece_count(n, pl))
             for tid, n, pl in tasks}
    out = {}
    for name, sm in stores.items():
        pieces = t_pieces if name == "torch" else j_pieces
        for tid, n, pl in tasks:
            ts = sm.register_task(tid, "peer-" + tid[:4], url=f"file:///{tid[:4]}", piece_length=pl,
                                  content_length=n)
            ranges = pieces.piece_ranges(n, pl)
            for k in order[tid]:
                pr = ranges[k]
                chunk = datas[tid][pr.offset : pr.offset + pr.length]
                ts.write_piece(pr.number, pr.offset, chunk,
                               digest="md5:" + hashlib.md5(chunk).hexdigest(),
                               traffic_type="remote_peer" if k % 2 else "back_to_source")
            ts.mark_done(n, expected_digest="sha256:" + hashlib.sha256(datas[tid]).hexdigest())
            dest = tmp_path / f"{name}-{tid[:4]}.out"
            ts.store(str(dest))
            out[(name, tid)] = (ts.read_all(), dest.read_bytes(), _meta_fields(ts),
                                ts.read_piece(order[tid][0]))
        # a wrong piece digest fails in both
        ts = sm.register_task("d" * 64, "peer-d", piece_length=4)
        out[(name, "bad")] = _outcome(ts.write_piece, 0, 0, b"data", "md5:" + "0" * 32)
        # restart: the completed tasks are found again with the same metadata
        again = type(sm)(str(tmp_path / name))
        out[(name, "reload")] = sorted(
            (tid, _meta_fields(again.find_completed_task(tid))["content_length"]) for tid, _, _ in tasks
        )
    for tid, n, _ in tasks:
        t, j = out[("torch", tid)], out[("jax", tid)]
        assert t[0] == j[0] == datas[tid] and t[1] == j[1] == datas[tid]
        assert t[2] == j[2]
        assert t[3] == j[3]
    assert out[("torch", "bad")][0] == "raise"
    assert out[("torch", "bad")][2] == out[("jax", "bad")][2]
    assert out[("torch", "reload")] == out[("jax", "reload")]


# ---------------------------------------------------------------------------
# rate limiter and traffic shaper, under one scripted clock
# ---------------------------------------------------------------------------


def test_rate_limiter_and_shaper_match_the_reference(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    rng = random.Random(4)
    script = [(rng.choice(["acquire", "advance", "usage", "rate"]), rng.randrange(1, 300_000))
              for _ in range(400)]

    def run(pm):
        clock[0] = 1000.0
        lim = pm.RateLimiter(100_000)
        got = []
        for op, n in script:
            if op == "acquire":
                got.append(round(lim.acquire_nowait(n), 12))
            elif op == "advance":
                clock[0] += n / 1e6
            elif op == "usage":
                got.append(lim.take_usage())
            else:
                lim.set_rate(n)
            got.append((lim.rate, round(lim.tokens, 6)))
        sh = pm.TrafficShaper(1000.0, interval=1.0)
        lims = [sh.limiter_for(f"t{i}") for i in range(4)]
        for _ in range(50):
            for lim in lims:
                lim.consumed = rng_shaper.randrange(0, 800)
            sh.sample_once()
            got.append([round(lim.rate, 9) for lim in lims])
        sh.release("t1")
        sh.sample_once()
        got.append([round(lim.rate, 9) for lim in lims])
        return got

    rng_shaper = random.Random(5)
    t = run(t_pm)
    rng_shaper = random.Random(5)
    assert t == run(j_pm)


def test_stat_overrides_match_the_reference():
    good = {"cpu.percent": 91.5, "memory.used_percent": 42.0, "disk.inodes_used_percent": 7.0,
            "network.tcp_connection_count": 12}
    t, j = t_hostinfo.HostStats(), j_hostinfo.HostStats()
    t_daemon._apply_stat_overrides(t, good)
    j_daemon._apply_stat_overrides(j, good)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for bad in ({"cpu.percnt": 1.0}, {"gpu.percent": 1.0}, {"cpu": 1.0}):
        assert _outcome(t_daemon._apply_stat_overrides, t_hostinfo.HostStats(), bad) == _outcome(
            j_daemon._apply_stat_overrides, j_hostinfo.HostStats(), bad
        )


# ---------------------------------------------------------------------------
# synchronizer and piece fetches across the two packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parent_pkg", ["jax", "torch"])
def test_synchronizer_across_packages(tmp_path, parent_pkg):
    """A child of one package syncs piece metadata from the other's
    dfdaemon service while the parent keeps finishing pieces."""
    sm_mod, rpc, glue, sync_mod, pm = (
        (j_storage, j_rpcserver, j_glue, t_sync, t_pm) if parent_pkg == "jax"
        else (t_storage, t_rpcserver, t_glue, j_sync, j_pm)
    )
    storage = sm_mod.StorageManager(str(tmp_path / "parent"))
    piece = os.urandom(4096)
    ts = storage.register_task("task-sync", "peer-parent", url="https://o/x")
    ts.meta.content_length = 4096 * 4
    ts.meta.piece_length = 4096
    ts.write_piece(0, 0, piece, traffic_type="back_to_source")
    server, port = glue.serve({rpc.SERVICE_NAME: rpc.DfdaemonService(
        task_manager=None, storage=storage, upload_addr="127.0.0.1:1")})
    try:
        parent = pm.ParentInfo(peer_id="peer-parent", upload_addr="x", finished_pieces={0})
        sync = sync_mod.PieceTaskSynchronizer("task-sync", "peer-child", interval=0.05)
        sync.watch(parent, f"127.0.0.1:{port}")
        ts.write_piece(1, 4096, piece, traffic_type="remote_peer")
        ts.write_piece(3, 12288, piece, traffic_type="remote_peer")
        deadline = time.time() + 10
        while time.time() < deadline and not {1, 3} <= parent.finished_pieces:
            time.sleep(0.05)
        sync.stop()
        assert parent.finished_pieces == {0, 1, 3}
    finally:
        server.stop(0)


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_piece_fetch_across_packages(tmp_path, server_pkg):
    """``download_piece`` of one package against the other's upload server:
    every piece's bytes, a ranged tail, and a missing piece's error."""
    sm_mod, up_mod, dl = (
        (j_storage, j_uploader, t_downloader) if server_pkg == "jax"
        else (t_storage, t_uploader, j_downloader)
    )
    sm = sm_mod.StorageManager(str(tmp_path / "parent"))
    ts = sm.register_task("e" * 64, "peer-parent", piece_length=PIECE)
    for pr in t_pieces.piece_ranges(len(PAYLOAD), PIECE):
        ts.write_piece(pr.number, pr.offset, PAYLOAD[pr.offset : pr.offset + pr.length])
    ts.mark_done(len(PAYLOAD))
    srv = up_mod.UploadServer(sm)
    srv.start()
    try:
        for pr in t_pieces.piece_ranges(len(PAYLOAD), PIECE):
            got = dl.download_piece(srv.address, "e" * 64, pr.number, "peer-child")
            data = got[0] if isinstance(got, tuple) else got
            assert data == PAYLOAD[pr.offset : pr.offset + pr.length]
        with pytest.raises(dl.PieceDownloadError):
            dl.download_piece(srv.address, "f" * 64, 0, "peer-child")
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# daemons of both packages in one swarm
# ---------------------------------------------------------------------------


def _scheduler(tmp_path):
    resource = t_res.Resource()
    storage = Storage(tmp_path / "sched", buffer_size=1)
    service = SchedulerService(
        resource,
        Scheduling(BaseEvaluator(), SchedulingConfig(retry_interval=0.05, retry_back_to_source_limit=3)),
        storage=storage,
    )
    server, port = t_glue.serve({SCHED_SERVICE: service})
    return server, f"127.0.0.1:{port}", storage


_STATS = {"cpu.percent": 12.5, "cpu.logical_count": 8, "memory.total": 1 << 34,
          "memory.used_percent": 40.0, "disk.total": 1 << 40, "disk.used_percent": 30.0}


def _daemon(mod, tmp_path, name, sched_addr):
    d = mod.Daemon(mod.DaemonConfig(
        data_dir=str(tmp_path / f"daemon-{name}"), scheduler_address=sched_addr,
        hostname=f"host-{name}", ip="127.0.0.1", piece_length=PIECE, schedule_timeout=5.0,
        announce_interval=60.0, collect_host_stats=False, host_stats_override=dict(_STATS),
    ))
    d.start()
    return d


_TRAFFIC_BTS, _TRAFFIC_PEER = t_pm.TRAFFIC_BACK_TO_SOURCE, t_pm.TRAFFIC_REMOTE_PEER


@pytest.mark.parametrize("first,second", [("jax", "torch"), ("torch", "jax")])
def test_p2p_and_dfget_across_packages(tmp_path, first, second):
    """Daemon A of one package goes back to source; daemon B of the other
    pulls every piece from A over A's upload server. Each package's dfget
    drives the other package's daemon."""
    assert (j_pm.TRAFFIC_BACK_TO_SOURCE, j_pm.TRAFFIC_REMOTE_PEER) == (_TRAFFIC_BTS, _TRAFFIC_PEER)
    mods = {"jax": (j_daemon, j_dfget), "torch": (t_daemon, t_dfget)}
    server, addr, storage = _scheduler(tmp_path)
    origin = tmp_path / "origin.bin"
    origin.write_bytes(PAYLOAD)
    url = f"file://{origin}"
    da = _daemon(mods[first][0], tmp_path, "a", addr)
    db = _daemon(mods[second][0], tmp_path, "b", addr)
    try:
        # dfget of the second package drives daemon A, of the first daemon B
        mods[second][1].download(f"127.0.0.1:{da.port}", url, str(tmp_path / "a.bin"))
        deadline = time.time() + 10  # A's finish reached the scheduler
        while time.time() < deadline and not storage.list_download():
            time.sleep(0.05)
        mods[first][1].download(f"127.0.0.1:{db.port}", url, str(tmp_path / "b.bin"))
        assert (tmp_path / "a.bin").read_bytes() == PAYLOAD == (tmp_path / "b.bin").read_bytes()
        task_id = da.task_manager.task_id_for(url, None)
        assert task_id == db.task_manager.task_id_for(url, None)
        ts_a = da.storage.find_completed_task(task_id)
        ts_b = db.storage.find_completed_task(task_id)
        assert {p.traffic_type for p in ts_a.meta.pieces.values()} == {_TRAFFIC_BTS}
        assert {p.traffic_type for p in ts_b.meta.pieces.values()} == {_TRAFFIC_PEER}
        assert {p.parent_id for p in ts_b.meta.pieces.values()} == {ts_a.meta.peer_id}
    finally:
        db.stop()
        da.stop()
        server.stop(0)


def _record_view(rec) -> dict:
    """A download record without ids, times, costs and ports (each run's
    own), nested dicts and lists kept in order."""
    drop = {"id", "created_at", "updated_at", "cost", "port", "download_port"}

    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items() if k not in drop}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v

    return strip(dataclasses.asdict(rec))


def test_download_records_match_the_reference(tmp_path):
    """The same two downloads (A back to source, then B from A) through the
    port's daemons and through the reference's, each pair on a fresh port
    scheduler: the records are equal on every field but ids, times, costs
    and ports."""
    origin = tmp_path / "origin.bin"
    origin.write_bytes(PAYLOAD)
    url = f"file://{origin}"
    views = {}
    for name, mod, dfget in (("torch", t_daemon, t_dfget), ("jax", j_daemon, j_dfget)):
        server, addr, storage = _scheduler(tmp_path / name)
        da = _daemon(mod, tmp_path / name, "a", addr)
        db = _daemon(mod, tmp_path / name, "b", addr)
        try:
            for k, d in enumerate((da, db), 1):
                dfget.download(f"127.0.0.1:{d.port}", url, str(tmp_path / name / f"{k}.bin"))
                # B registers only once the scheduler has A's finish (its
                # record): under load it could otherwise find no parent
                deadline = time.time() + 10
                while time.time() < deadline and len(list(storage.list_download())) < k:
                    time.sleep(0.05)
            records = list(storage.list_download())
        finally:
            db.stop()
            da.stop()
            server.stop(0)
        assert len(records) == 2
        views[name] = sorted((_record_view(r) for r in records), key=lambda v: v["host"]["hostname"])
    assert views["torch"] == views["jax"]
    a, b = views["torch"]
    assert a["host"]["hostname"] == "host-a" and a["parents"] == []
    assert [p["host"]["hostname"] for p in b["parents"]] == ["host-a"]
    assert b["host"]["cpu"]["percent"] == 12.5 and b["task"]["content_length"] == len(PAYLOAD)
