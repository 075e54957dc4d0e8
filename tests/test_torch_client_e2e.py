"""The reference's client end-to-end suite (``tests/test_client_e2e.py``)
on the port's stack: dfget → the port's daemon → the port's scheduler →
a parent daemon of the port → bytes on disk, with the download records
written. Every case of the reference's file is kept, case for case, and
one more runs the P2P slice under ``algorithm="ml"`` with a seeded MLP
served by the port's ``ScoringService`` on the CPU.

Daemon A fetches from the origin (back-to-source), daemon B then fetches
the same task and must receive A as a candidate parent and pull pieces
over A's HTTP upload server (remote_peer traffic).
"""

import os

import pytest

from dragonfly2_torch.rpc import protos
common_pb2 = protos.load("common_pb2")

from dragonfly2_torch.client import dfcache, dfget
from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_torch.client.piece_manager import TRAFFIC_BACK_TO_SOURCE, TRAFFIC_REMOTE_PEER
from dragonfly2_torch.rpc.glue import serve
from dragonfly2_torch.scheduler import resource as res
from dragonfly2_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_torch.scheduler.networktopology import NetworkTopology
from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
from dragonfly2_torch.scheduler.service import SERVICE_NAME as SCHED_SERVICE
from dragonfly2_torch.scheduler.service import SchedulerService
from dragonfly2_torch.scheduler.storage import Storage
from dragonfly2_torch.utils.kvstore import KVStore
from dragonfly2_torch.utils import profiling as t_profiling
from dragonfly2_tpu.utils import profiling as j_profiling

PIECE = 64 * 1024
PAYLOAD = os.urandom(300 * 1024)  # 5 pieces at 64 KiB


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # each package's daemons and servers start its process-wide stack sampler
    # and leave it running, as a server process would; stop both once the
    # module is done so their sweeps do not tax the files run after it in
    # this process
    yield
    t_profiling.stop()
    j_profiling.stop()


def _cluster(tmp_path, evaluator):
    """Scheduler + two daemons, all real servers on localhost."""
    resource = res.Resource()
    storage = Storage(tmp_path / "sched", buffer_size=1)
    nt = NetworkTopology(KVStore(), resource.host_manager, storage)
    service = SchedulerService(
        resource,
        Scheduling(
            evaluator,
            # a couple of retries with a real interval: under full-suite
            # load daemon B can register before the scheduler has
            # processed A's finished event, and with zero settling time a
            # single empty candidate search would send B to the origin
            # (observed as a rare pure-P2P assertion flake)
            SchedulingConfig(retry_interval=0.05, retry_back_to_source_limit=3),
        ),
        storage=storage,
        networktopology=nt,
    )
    server, port = serve({SCHED_SERVICE: service})
    sched_addr = f"127.0.0.1:{port}"

    daemons = []
    for name in ("a", "b"):
        d = Daemon(
            DaemonConfig(
                data_dir=str(tmp_path / f"daemon-{name}"),
                scheduler_address=sched_addr,
                hostname=f"host-{name}",
                ip="127.0.0.1",
                piece_length=PIECE,
                schedule_timeout=5.0,
                announce_interval=60.0,
            )
        )
        d.start()
        daemons.append(d)

    origin = tmp_path / "origin.bin"
    origin.write_bytes(PAYLOAD)

    yield {
        "resource": resource,
        "storage": storage,
        "daemons": daemons,
        "url": f"file://{origin}",
        "tmp": tmp_path,
    }
    for d in daemons:
        d.stop()
    server.stop(0)


@pytest.fixture
def cluster(tmp_path):
    yield from _cluster(tmp_path, BaseEvaluator())


def test_p2p_download_slice(cluster):
    da, db = cluster["daemons"]
    url = cluster["url"]
    tmp = cluster["tmp"]

    # ---- daemon A: no parents exist → back-to-source from origin ----
    out_a = tmp / "out-a.bin"
    paths = dfget.download(f"127.0.0.1:{da.port}", url, str(out_a))
    assert paths == [str(out_a)]
    assert out_a.read_bytes() == PAYLOAD

    task_id = da.task_manager.task_id_for(url, None)
    ts_a = da.storage.find_completed_task(task_id)
    assert ts_a is not None
    assert len(ts_a.meta.pieces) == 5
    assert all(p.traffic_type == TRAFFIC_BACK_TO_SOURCE for p in ts_a.meta.pieces.values())

    # ---- daemon B: must be scheduled onto A and pull over HTTP ----
    out_b = tmp / "out-b.bin"
    dfget.download(f"127.0.0.1:{db.port}", url, str(out_b))
    assert out_b.read_bytes() == PAYLOAD

    ts_b = db.storage.find_completed_task(task_id)
    assert ts_b is not None
    traffic = {p.traffic_type for p in ts_b.meta.pieces.values()}
    assert traffic == {TRAFFIC_REMOTE_PEER}, f"expected pure P2P transfer, got {traffic}"
    parents = {p.parent_id for p in ts_b.meta.pieces.values()}
    assert parents == {ts_a.meta.peer_id}

    # ---- training records landed in scheduler storage ----
    records = list(cluster["storage"].list_download())
    assert len(records) >= 2, "download records must be written for the trainer"

    # ---- task state on the scheduler reflects the swarm ----
    task = cluster["resource"].task_manager.load(task_id)
    assert task is not None
    assert task.content_length == len(PAYLOAD)


def test_empty_file_download(cluster):
    """A zero-byte origin completes as an empty output file on both the
    back-to-source path and the second-daemon path (the reference gates
    an e2e suite on exactly this: feature_gate.go dfget-empty-file;
    scheduler-side SIZE_SCOPE_EMPTY short-circuits parent scheduling)."""
    da, db = cluster["daemons"]
    tmp = cluster["tmp"]
    origin = tmp / "empty.bin"
    origin.write_bytes(b"")
    url = f"file://{origin}"

    out_a = tmp / "empty-a.bin"
    paths = dfget.download(f"127.0.0.1:{da.port}", url, str(out_a))
    assert paths == [str(out_a)]
    assert out_a.exists() and out_a.read_bytes() == b""

    # a second daemon must also complete (no parents have pieces to
    # serve for an empty task — it must not hang waiting for any)
    out_b = tmp / "empty-b.bin"
    dfget.download(f"127.0.0.1:{db.port}", url, str(out_b))
    assert out_b.exists() and out_b.read_bytes() == b""

    # the scheduler saw the task and recorded its true (zero) length
    task_id = da.task_manager.task_id_for(url, None)
    task = cluster["resource"].task_manager.load(task_id)
    assert task is not None
    assert task.content_length == 0


def test_reuse_completed_task(cluster):
    da, _ = cluster["daemons"]
    url = cluster["url"]
    tmp = cluster["tmp"]
    out1 = tmp / "r1.bin"
    out2 = tmp / "r2.bin"
    dfget.download(f"127.0.0.1:{da.port}", url, str(out1))
    # second download of the same url is served from the local piece
    # store without a new conductor (reference peertask_reuse.go)
    dfget.download(f"127.0.0.1:{da.port}", url, str(out2))
    assert out2.read_bytes() == PAYLOAD


def test_dfcache_import_stat_export_delete(cluster, tmp_path):
    da, db = cluster["daemons"]
    blob = tmp_path / "blob.bin"
    blob.write_bytes(b"cached-bytes" * 1000)
    url = "d7y://cache/blob-1"
    addr_a = f"127.0.0.1:{da.port}"

    assert not dfcache.stat(addr_a, url)
    dfcache.import_file(addr_a, str(blob), url)
    assert dfcache.stat(addr_a, url)

    out = tmp_path / "exported.bin"
    dfcache.export_file(addr_a, url, str(out), local_only=True)
    assert out.read_bytes() == blob.read_bytes()

    dfcache.delete(addr_a, url)
    assert not dfcache.stat(addr_a, url)


def test_recursive_download(cluster, tmp_path):
    da, _ = cluster["daemons"]
    src = tmp_path / "tree"
    (src / "sub").mkdir(parents=True)
    (src / "one.bin").write_bytes(b"one")
    (src / "sub" / "two.bin").write_bytes(b"two")

    dest = tmp_path / "tree-out"
    written = dfget.download(
        f"127.0.0.1:{da.port}", f"file://{src}", str(dest), recursive=True
    )
    assert len(written) == 2
    assert (dest / "one.bin").read_bytes() == b"one"
    assert (dest / "sub" / "two.bin").read_bytes() == b"two"


def test_import_announce_seeds_swarm(cluster, tmp_path):
    """dfcache import on daemon A announces the completed task to the
    scheduler, so daemon B finds A as a parent instead of back-sourcing
    (reference rpcserver announcePeerTask → scheduler AnnounceTask)."""
    da, db = cluster["daemons"]
    tmp = cluster["tmp"]

    blob = os.urandom(3 * PIECE)
    src = tmp / "imported.bin"
    src.write_bytes(blob)
    # the url is a cache key only — it resolves to nothing, so any
    # back-to-source attempt from B would fail the download
    url = "file:///nonexistent/cache-key-object"
    dfcache.import_file(f"127.0.0.1:{da.port}", str(src), url)

    task_id = da.task_manager.task_id_for(url, None)
    peer = None
    for p in cluster["resource"].peer_manager.all():
        if p.task.id == task_id:
            peer = p
    assert peer is not None, "import must announce a peer to the scheduler"
    assert peer.fsm.current == res.PEER_STATE_SUCCEEDED

    out_b = tmp / "imported-out.bin"
    dfget.download(f"127.0.0.1:{db.port}", url, str(out_b))
    assert out_b.read_bytes() == blob
    ts_b = db.storage.find_completed_task(task_id)
    traffic = {p.traffic_type for p in ts_b.meta.pieces.values()}
    assert traffic == {TRAFFIC_REMOTE_PEER}, f"expected pure P2P, got {traffic}"


def test_host_stats_flow_into_download_records(cluster):
    """The features the MLP trains on (host cpu/mem/disk/tcp columns)
    must be alive in written Download records, end to end: daemon sampling
    → AnnounceHost → resource.Host → record."""
    da, _ = cluster["daemons"]
    url = cluster["url"]
    tmp = cluster["tmp"]
    dfget.download(f"127.0.0.1:{da.port}", url, str(tmp / "stats-out.bin"))

    records = list(cluster["storage"].list_download())
    assert records
    host = records[-1].host
    assert host.memory.used_percent > 0
    assert host.memory.total > 0
    assert host.disk.total > 0
    assert host.cpu.logical_count > 0


def test_stream_task_frontend(cluster):
    """Stream frontend (reference peertask_stream.go): bytes yield in
    piece order while the download is live, and a completed local task
    streams from disk."""
    from dragonfly2_torch.client.peertask import FileTaskRequest

    da, db = cluster["daemons"]
    url = cluster["url"]
    # daemon A seeds via the seed frontend (origin-first registration)
    task_id, _, conductor = da.task_manager.start_seed_task(url)
    assert conductor is not None
    assert conductor.wait(10).done
    ts_a = da.storage.find_completed_task(task_id)
    assert all(
        p.traffic_type == TRAFFIC_BACK_TO_SOURCE for p in ts_a.meta.pieces.values()
    )

    # daemon B streams the task: live P2P download, chunks arrive in order
    sid, _, content_length, headers, body = db.task_manager.start_stream_task(
        FileTaskRequest(url=url), timeout=10
    )
    assert sid == task_id
    assert content_length == len(PAYLOAD)
    data = b"".join(body)
    assert data == PAYLOAD

    # second stream on B = reuse path, served from completed local storage
    sid2, _, cl2, _, body2 = db.task_manager.start_stream_task(
        FileTaskRequest(url=url), timeout=10
    )
    assert sid2 == task_id and cl2 == len(PAYLOAD)
    assert b"".join(body2) == PAYLOAD


def test_stream_task_failure_raises(cluster, tmp_path):
    """A stream on a task that can neither find parents nor back-source
    must raise, not hang."""
    from dragonfly2_torch.client.peertask import FileTaskRequest

    da, _ = cluster["daemons"]
    with pytest.raises((IOError, TimeoutError, RuntimeError)):
        _, _, _, _, body = da.task_manager.start_stream_task(
            FileTaskRequest(
                url=f"file://{tmp_path}/definitely-missing.bin",
            ),
            timeout=5,
        )
        b"".join(body)


def test_parse_byte_range_forms():
    from dragonfly2_torch.client.pieces import parse_byte_range

    assert parse_byte_range("") == (0, -1)
    assert parse_byte_range("0-1023") == (0, 1024)
    assert parse_byte_range("bytes=4096-") == (4096, -1)
    assert parse_byte_range("100-100") == (100, 1)
    for bad in ("abc", "5", "9-3", "-5-2", "1-x"):
        with pytest.raises(ValueError):
            parse_byte_range(bad)


def test_ranged_download_end_to_end(cluster):
    """dfget --range: the slice is the task (reference dfget-range
    feature gate) — back-to-source fetches only the range, and a second
    peer gets the same slice over P2P."""
    url = cluster["url"]
    tmp = cluster["tmp"]
    d_a, d_b = cluster["daemons"]

    out_a = tmp / "slice-a.bin"
    dfget.download(
        f"127.0.0.1:{d_a.port}", url, str(out_a), byte_range="1000-99999"
    )
    assert out_a.read_bytes() == PAYLOAD[1000:100000]

    # same range from daemon B rides P2P (same task id, remote pieces)
    out_b = tmp / "slice-b.bin"
    dfget.download(
        f"127.0.0.1:{d_b.port}", url, str(out_b), byte_range="1000-99999"
    )
    assert out_b.read_bytes() == PAYLOAD[1000:100000]
    tid = d_b.task_manager.task_id_for(
        url, common_pb2.UrlMeta(range="1000-99999")
    )
    ts_b = d_b.storage.find_completed_task(tid)
    assert ts_b is not None
    assert TRAFFIC_REMOTE_PEER in {
        p.traffic_type for p in ts_b.meta.pieces.values()
    }

    # open-ended range
    out_c = tmp / "tail.bin"
    dfget.download(
        f"127.0.0.1:{d_a.port}", url, str(out_c),
        byte_range=f"bytes={len(PAYLOAD) - 777}-",
    )
    assert out_c.read_bytes() == PAYLOAD[-777:]

    # a DIFFERENT range is a different task (distinct content)
    out_d = tmp / "other.bin"
    dfget.download(f"127.0.0.1:{d_a.port}", url, str(out_d), byte_range="0-999")
    assert out_d.read_bytes() == PAYLOAD[:1000]


def test_range_normalization_and_bounds(cluster):
    """Equivalent range spellings share one task; out-of-bounds ranges
    fail cleanly (HTTP 416 semantics), never complete empty."""
    from dragonfly2_torch.client.pieces import normalize_byte_range

    d_a, _ = cluster["daemons"]
    tm = d_a.task_manager
    url = cluster["url"]
    specs = ("0-1023", "bytes=0-1023", " 0-1023 ")
    ids = {tm.task_id_for(url, common_pb2.UrlMeta(range=s)) for s in specs}
    assert len(ids) == 1
    assert normalize_byte_range("bytes=4096-") == "4096-"
    assert normalize_byte_range("") == ""
    with pytest.raises(ValueError):
        tm.task_id_for(url, common_pb2.UrlMeta(range="9-3"))

    # range starting past EOF fails the download (no empty success)
    out = cluster["tmp"] / "past-eof.bin"
    with pytest.raises(Exception):
        dfget.download(
            f"127.0.0.1:{d_a.port}", url, str(out),
            byte_range=f"{len(PAYLOAD) + 10}-",
        )


def test_suffix_range_and_whole_object_canonicalization(cluster):
    """RFC 7233 suffix ranges ('-n') work end-to-end, and '0-' IS the
    unranged task (one cache entry, not two)."""
    from dragonfly2_torch.client.pieces import normalize_byte_range

    d_a, _ = cluster["daemons"]
    url = cluster["url"]
    tmp = cluster["tmp"]

    out = tmp / "suffix.bin"
    dfget.download(f"127.0.0.1:{d_a.port}", url, str(out), byte_range="bytes=-512")
    assert out.read_bytes() == PAYLOAD[-512:]

    tm = d_a.task_manager
    assert normalize_byte_range("0-") == "" == normalize_byte_range("bytes=0-")
    assert tm.task_id_for(url, common_pb2.UrlMeta(range="0-")) == tm.task_id_for(url, None)
    # suffix longer than the object clamps to the whole object (RFC 7233)
    out2 = tmp / "clamped.bin"
    dfget.download(
        f"127.0.0.1:{d_a.port}", url, str(out2),
        byte_range=f"-{len(PAYLOAD) * 2}",
    )
    assert out2.read_bytes() == PAYLOAD

    # recursive + range is rejected up front
    with pytest.raises(ValueError, match="recursive"):
        dfget.download(
            f"127.0.0.1:{d_a.port}", url, str(tmp / "x"),
            byte_range="0-9", recursive=True,
        )


def test_whole_task_digest_gate(cluster):
    """UrlMeta.digest: success is only reported when the assembled
    content hashes to the pinned digest — a wrong pin fails the task
    (the reference left this check TODO, peertask_conductor.go:607)."""
    import hashlib

    d_a, _ = cluster["daemons"]
    url = cluster["url"]
    tmp = cluster["tmp"]

    good = "sha256:" + hashlib.sha256(PAYLOAD).hexdigest()
    out = tmp / "pinned.bin"
    dfget.download(f"127.0.0.1:{d_a.port}", url, str(out), digest=good)
    assert out.read_bytes() == PAYLOAD

    # uppercase pins match (hex case-insensitive)
    out_u = tmp / "upper.bin"
    dfget.download(
        f"127.0.0.1:{d_a.port}", url, str(out_u),
        digest="sha256:" + hashlib.sha256(PAYLOAD).hexdigest().upper(),
    )
    assert out_u.read_bytes() == PAYLOAD

    bad = "sha256:" + hashlib.sha256(b"not the payload").hexdigest()
    with pytest.raises(Exception, match="digest"):
        dfget.download(
            f"127.0.0.1:{d_a.port}", url, str(tmp / "bad.bin"), digest=bad
        )
    # retry with the SAME wrong pin must re-verify, not reuse the
    # invalidated bytes (the task was un-completed on mismatch)
    with pytest.raises(Exception, match="digest"):
        dfget.download(
            f"127.0.0.1:{d_a.port}", url, str(tmp / "bad2.bin"), digest=bad
        )

    # malformed pins fail at registration, before any transfer
    with pytest.raises(Exception, match="[Ii]nvalid digest"):
        dfget.download(
            f"127.0.0.1:{d_a.port}", url, str(tmp / "m.bin"), digest="sha1:abcd"
        )


def test_recursive_rejects_digest_pin(cluster):
    d_a, _ = cluster["daemons"]
    with pytest.raises(ValueError, match="digest.*recursive"):
        dfget.download(
            f"127.0.0.1:{d_a.port}", cluster["url"], "/tmp/x",
            digest="sha256:" + "0" * 64, recursive=True,
        )


def test_origin_headers_ride_back_to_source(cluster, tmp_path):
    """dfget --header: origin request headers (private-registry auth)
    reach the back-to-source fetch; without them the origin refuses."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    payload = os.urandom(40_000)

    class AuthOrigin(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _authed(self):
            return self.headers.get("Authorization") == "Bearer s3cr3t"

        def do_HEAD(self):
            if not self._authed():
                self.send_error(401)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Accept-Ranges", "bytes")
            self.end_headers()

        def do_GET(self):
            if not self._authed():
                self.send_error(401)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

    origin = ThreadingHTTPServer(("127.0.0.1", 0), AuthOrigin)
    threading.Thread(target=origin.serve_forever, daemon=True).start()
    try:
        d_a, _ = cluster["daemons"]
        url = f"http://127.0.0.1:{origin.server_address[1]}/private.bin"
        out = tmp_path / "authed.bin"
        dfget.download(
            f"127.0.0.1:{d_a.port}", url, str(out),
            headers={"Authorization": "Bearer s3cr3t"},
        )
        assert out.read_bytes() == payload

        # without the header the origin 401s and the download fails
        with pytest.raises(Exception):
            dfget.download(
                f"127.0.0.1:{d_a.port}", url + "?v=2", str(tmp_path / "no.bin")
            )
    finally:
        origin.shutdown()
        origin.server_close()


def test_recursive_download_carries_headers(cluster, tmp_path, monkeypatch):
    """--header + --recursive: the listing AND every per-file fetch get
    the origin headers (not silently dropped)."""
    from dragonfly2_torch.client import source as source_mod

    seen = {"list": None, "downloads": 0}
    real_client_for = source_mod.client_for

    class Spy:
        def __init__(self, inner):
            self.inner = inner

        def list(self, url, headers=None):
            seen["list"] = dict(headers or {})
            return self.inner.list(url, headers)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    monkeypatch.setattr(
        dfget, "source", type("S", (), {"client_for": lambda u: Spy(real_client_for(u))})
    )
    src = tmp_path / "tree2"
    src.mkdir()
    (src / "one.bin").write_bytes(b"one")
    d_a, _ = cluster["daemons"]
    dest = tmp_path / "tree2-out"
    written = dfget.download(
        f"127.0.0.1:{d_a.port}", f"file://{src}", str(dest),
        recursive=True, headers={"Authorization": "Bearer r"},
    )
    assert len(written) == 1 and (dest / "one.bin").read_bytes() == b"one"
    assert seen["list"] == {"Authorization": "Bearer r"}


def test_p2p_download_slice_under_ml_evaluator(tmp_path):
    """The P2P slice with the ``ml`` evaluator: daemon B's parent is ranked
    by a seeded MLP ``[19, 128, 128, 1]`` that the port's scoring service
    serves on the CPU, on the ``serving`` rung, and B still pulls every
    piece from A."""
    import torch

    from dragonfly2_torch.models.mlp import init_mlp
    from dragonfly2_torch.scheduler.evaluator import MLEvaluator
    from dragonfly2_torch.scheduler.serving import MLPServed, ScoringService
    from dragonfly2_torch.schema.features import MLP_FEATURE_DIM
    from dragonfly2_torch.trainer.serving import MLPScorer

    torch.set_num_threads(1)
    params = init_mlp(torch.Generator().manual_seed(0), [MLP_FEATURE_DIM, 128, 128, 1])
    service = ScoringService()
    service.start()
    service.install(MLPServed(MLPScorer(params, device="cpu")), version="mlp/seeded")
    evaluator = MLEvaluator(serving=service)
    scored = []
    real = service.score_wave

    def recording(features, pairs, counts, budget_s=None):
        out = real(features, pairs, counts, budget_s=budget_s)
        scored.append((list(counts), out))
        return out

    service.score_wave = recording
    gen = _cluster(tmp_path, evaluator)
    c = next(gen)
    try:
        da, db = c["daemons"]
        url = c["url"]
        dfget.download(f"127.0.0.1:{da.port}", url, str(tmp_path / "a.bin"))
        dfget.download(f"127.0.0.1:{db.port}", url, str(tmp_path / "b.bin"))
        assert (tmp_path / "b.bin").read_bytes() == PAYLOAD
        task_id = db.task_manager.task_id_for(url, None)
        ts_a = da.storage.find_completed_task(task_id)
        ts_b = db.storage.find_completed_task(task_id)
        assert {p.traffic_type for p in ts_b.meta.pieces.values()} == {TRAFFIC_REMOTE_PEER}
        assert {p.parent_id for p in ts_b.meta.pieces.values()} == {ts_a.meta.peer_id}
        # B's decision was a W = 1 wave with A as its one candidate,
        # scored by the served MLP: the serving rung, no demotion
        assert scored and all(counts == [1] and out[0] is not None for counts, out in scored)
        assert evaluator._rung == "serving"
        assert service.model_kind() == "mlp"
        assert len(list(c["storage"].list_download())) >= 2
    finally:
        next(gen, None)
        service.stop()
