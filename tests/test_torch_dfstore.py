"""The reference's ``tests/test_dfstore.py``, case for case, on the port's
object-storage gateway and dfstore (``dragonfly2_torch.client.objectstorage``
and ``.dfstore``): objects ride the P2P swarm.

Two daemons front one shared backend dir (the NFS/S3 stand-in): an
object PUT through daemon A's gateway (seed-on-write) must be GETtable
through daemon B's gateway with the bytes arriving over P2P.

Then parity: a port cluster and a reference cluster — a scheduler of the
package and two of its daemons on one backend path — answer one sequence
of gateway requests alike (status, every header but ``Date``, body);
each package's dfstore CLI drives the other's gateway; ``_slice_stream``
and ``_parse_df`` agree; the daemon binary prints its ``GATEWAY`` line;
and a daemon serves no gateway unless asked. Every server listens on
port 0 and is stopped in a fixture or ``finally``; a reader waits until
the scheduler holds the writer's finished task before it asks."""

from __future__ import annotations

import hashlib
import http.client
import os
import random
import re
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from dragonfly2_torch.client import daemon as t_daemon
from dragonfly2_torch.client import dfstore
from dragonfly2_torch.client import objectstorage as t_objectstorage
from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_torch.client.piece_manager import TRAFFIC_REMOTE_PEER
from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.scheduler import evaluator as t_evaluator
from dragonfly2_torch.scheduler import resource as t_res
from dragonfly2_torch.scheduler import scheduling as t_scheduling
from dragonfly2_torch.scheduler import service as t_service
from dragonfly2_torch.scheduler import storage as t_storage
from dragonfly2_torch.utils import flows as t_flows
from dragonfly2_torch.utils.idgen import URLMeta, task_id_v1
from dragonfly2_torch.utils import profiling as t_profiling

from dragonfly2_tpu.client import daemon as j_daemon
from dragonfly2_tpu.client import dfstore as j_dfstore
from dragonfly2_tpu.client import objectstorage as j_objectstorage
from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.scheduler import evaluator as j_evaluator
from dragonfly2_tpu.scheduler import resource as j_res
from dragonfly2_tpu.scheduler import scheduling as j_scheduling
from dragonfly2_tpu.scheduler import service as j_service
from dragonfly2_tpu.scheduler import storage as j_storage
from dragonfly2_tpu.utils import profiling as j_profiling

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PIECE = 32 * 1024
OBJ = os.urandom(2 * PIECE + 17)


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # each package's daemons and servers start its process-wide stack sampler
    # and leave it running, as a server process would; stop both once the
    # module is done so their sweeps do not tax the files run after it in
    # this process
    yield
    t_profiling.stop()
    j_profiling.stop()


# (daemon, dfstore, glue, resource, evaluator, scheduling, service, storage)
# of each package
_PKGS = {
    "torch": (t_daemon, dfstore, t_glue, t_res, t_evaluator, t_scheduling, t_service, t_storage),
    "jax": (j_daemon, j_dfstore, j_glue, j_res, j_evaluator, j_scheduling, j_service, j_storage),
}


class _Cluster:
    """A scheduler of one package and two daemons of it ("a" and "b"),
    each serving its gateway on port 0 over ``backend``."""

    def __init__(self, pkg: str, tmp_path: Path, backend: Path):
        daemon, _, glue, res, evaluator, scheduling, service, storage = _PKGS[pkg]
        self.pkg, self.res, self.daemons = pkg, res, []
        self.resource = res.Resource()
        svc = service.SchedulerService(
            self.resource,
            scheduling.Scheduling(
                evaluator.BaseEvaluator(),
                # a few retries with a real interval: under the suite's load
                # a daemon can register before the scheduler has taken its
                # parent's finish, and one empty search sends it to the origin
                scheduling.SchedulingConfig(retry_interval=0.05, retry_back_to_source_limit=3),
            ),
            storage=storage.Storage(tmp_path / "sched", buffer_size=1),
        )
        self.server, port = glue.serve({glue.SCHEDULER_SERVICE: svc})
        try:
            for name in ("a", "b"):
                d = daemon.Daemon(daemon.DaemonConfig(
                    data_dir=str(tmp_path / f"daemon-{name}"),
                    scheduler_address=f"127.0.0.1:{port}",
                    hostname=f"host-{name}",
                    ip="127.0.0.1",
                    piece_length=PIECE,
                    schedule_timeout=5.0,
                    announce_interval=60.0,
                    collect_host_stats=False,
                    object_storage_port=0,
                    object_storage_dir=str(backend),
                ))
                self.daemons.append(d)
                d.start()
        except BaseException:
            self.stop()
            raise

    def wait_seeded(self, task_id: str, hostname: str, timeout: float = 10.0) -> None:
        """Until the scheduler holds ``hostname``'s peer of ``task_id`` as
        succeeded: the next daemon to ask finds it as a parent."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if any(p.task.id == task_id and p.host.hostname == hostname
                   and p.fsm.is_state(self.res.PEER_STATE_SUCCEEDED)
                   for p in self.resource.peer_manager.all()):
                return
            time.sleep(0.02)
        raise AssertionError(f"the scheduler never held {hostname}'s task {task_id[:16]}")

    def wait_object(self, backend: Path, bucket: str, key: str, data: bytes,
                    hostname: str = "host-a") -> None:
        """The writer's seed-on-write import is recorded by the scheduler."""
        self.wait_seeded(_object_task(backend, bucket, key, data), hostname)

    def stop(self) -> None:
        for d in self.daemons:
            d.stop()
        self.server.stop(0)


def _object_task(backend: Path, bucket: str, key: str, data: bytes) -> str:
    digest = "sha256:" + hashlib.sha256(data).hexdigest()
    return task_id_v1(f"file://{backend}/{bucket}/{key}", URLMeta(digest=digest))


@pytest.fixture
def store_cluster(tmp_path):
    backend = tmp_path / "backend"  # shared across both daemons
    cluster = _Cluster("torch", tmp_path, backend)
    yield {"daemons": cluster.daemons, "tmp": tmp_path, "cluster": cluster, "backend": backend}
    cluster.stop()


def _gw(d) -> str:
    return f"127.0.0.1:{d.object_gateway.port}"


# ---------------------------------------------------------------------------
# the reference's tests/test_dfstore.py, case for case
# ---------------------------------------------------------------------------


def test_object_roundtrip_via_p2p(store_cluster):
    da, db = store_cluster["daemons"]

    dfstore.create_bucket(_gw(da), "models")
    dfstore.put_object(_gw(da), "models", "v1/weights.npz", OBJ)

    # A holds a local seed copy (seed-on-write); the task id includes the
    # content digest so overwrites re-seed under a fresh identity
    obj_url = f"file://{store_cluster['tmp']}/backend/models/v1/weights.npz"
    digest = "sha256:" + hashlib.sha256(OBJ).hexdigest()
    tid = task_id_v1(obj_url, URLMeta(digest=digest))
    assert da.storage.find_completed_task(tid) is not None
    store_cluster["cluster"].wait_seeded(tid, "host-a")

    # B reads through its own gateway — bytes come via the P2P pipeline
    got = dfstore.get_object(_gw(db), "models", "v1/weights.npz")
    assert got == OBJ

    assert dfstore.head_object(_gw(db), "models", "v1/weights.npz") == len(OBJ)
    assert dfstore.list_objects(_gw(db), "models") == ["v1/weights.npz"]
    assert dfstore.list_objects(_gw(db), "models", prefix="v1/") == ["v1/weights.npz"]

    dfstore.delete_object(_gw(da), "models", "v1/weights.npz")
    assert dfstore.head_object(_gw(da), "models", "v1/weights.npz") is None


def test_dfstore_cli(store_cluster, tmp_path):
    da = store_cluster["daemons"][0]
    src = tmp_path / "upload.bin"
    src.write_bytes(OBJ)
    endpoint = _gw(da)

    assert dfstore.main(["--endpoint", endpoint, "mb", "df://cache"]) == 0
    assert dfstore.main(["--endpoint", endpoint, "cp", str(src), "df://cache/a/b.bin"]) == 0
    assert dfstore.main(["--endpoint", endpoint, "stat", "df://cache/a/b.bin"]) == 0
    out = tmp_path / "download.bin"
    assert dfstore.main(["--endpoint", endpoint, "cp", "df://cache/a/b.bin", str(out)]) == 0
    assert out.read_bytes() == OBJ
    assert dfstore.main(["--endpoint", endpoint, "rm", "df://cache/a/b.bin"]) == 0
    assert dfstore.main(["--endpoint", endpoint, "stat", "df://cache/a/b.bin"]) == 1


def test_missing_object_404(store_cluster):
    da = store_cluster["daemons"][0]
    dfstore.create_bucket(_gw(da), "empty")
    with pytest.raises(dfstore.DfstoreError, match="404"):
        dfstore.get_object(_gw(da), "empty", "nope")


def test_overwrite_serves_fresh_bytes(store_cluster):
    """Rewriting an object must not leave the swarm serving stale bytes:
    the content digest is part of the task identity."""
    da, db = store_cluster["daemons"]
    cluster, backend = store_cluster["cluster"], store_cluster["backend"]
    dfstore.create_bucket(_gw(da), "cfg")

    dfstore.put_object(_gw(da), "cfg", "app.conf", b"version-1")
    cluster.wait_object(backend, "cfg", "app.conf", b"version-1")
    assert dfstore.get_object(_gw(db), "cfg", "app.conf") == b"version-1"

    dfstore.put_object(_gw(da), "cfg", "app.conf", b"version-2-longer")
    cluster.wait_object(backend, "cfg", "app.conf", b"version-2-longer")
    assert dfstore.get_object(_gw(db), "cfg", "app.conf") == b"version-2-longer"
    assert dfstore.get_object(_gw(da), "cfg", "app.conf") == b"version-2-longer"


def test_copy_object_between_keys(store_cluster):
    """df://→df:// copy (upstream dfstore CopyObject): composed through
    the gateway, destination readable and seeded like any PUT."""
    da = store_cluster["daemons"][0]
    addr = f"127.0.0.1:{da.object_gateway.port}"
    dfstore.create_bucket(addr, "cpb")
    dfstore.put_object(addr, "cpb", "src/a.bin", b"copy-me")
    dfstore.copy_object(addr, "cpb", "src/a.bin", "cpb", "dst/b.bin")
    assert dfstore.get_object(addr, "cpb", "dst/b.bin") == b"copy-me"
    # CLI form
    rc = dfstore.main([
        "--endpoint", addr, "cp", "df://cpb/dst/b.bin", "df://cpb/dst/c.bin"
    ])
    assert rc == 0
    assert dfstore.get_object(addr, "cpb", "dst/c.bin") == b"copy-me"


def test_ranged_object_get(store_cluster):
    """S3-style ranged GETs on the gateway: 206 + Content-Range, slice
    bytes only — served through the transport's ranged-task path."""
    da, _ = store_cluster["daemons"]

    dfstore.put_object(_gw(da), "bkt", "ranged.bin", OBJ)
    req = urllib.request.Request(
        f"http://{_gw(da)}/buckets/bkt/objects/ranged.bin",
        headers={"Range": "bytes=100-4195"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        body = r.read()
        assert r.status == 206
        assert r.headers["Content-Range"].startswith("bytes 100-4195/")
    assert body == OBJ[100:4196]

    # suffix form (no absolute start): still correct bytes, any route
    req = urllib.request.Request(
        f"http://{_gw(da)}/buckets/bkt/objects/ranged.bin",
        headers={"Range": "bytes=-77"},
    )
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 206
        assert r.read() == OBJ[-77:]


def test_ranged_get_semantics_rfc7233(store_cluster):
    """Size probes get a real total in Content-Range; malformed Range is
    ignored (200 whole object); past-EOF is 416."""
    da, _ = store_cluster["daemons"]

    dfstore.put_object(_gw(da), "bkt", "sem.bin", OBJ)
    base = f"http://{_gw(da)}/buckets/bkt/objects/sem.bin"

    # size probe: the Content-Range total is the real size, never '*'
    req = urllib.request.Request(base, headers={"Range": "bytes=0-0"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 206
        assert r.headers["Content-Range"] == f"bytes 0-0/{len(OBJ)}"
        assert r.read() == OBJ[:1]

    # malformed Range → ignored, whole object with 200
    req = urllib.request.Request(base, headers={"Range": "bytes=zz"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200 and len(r.read()) == len(OBJ)

    # start past EOF → 416
    req = urllib.request.Request(base, headers={"Range": f"bytes={len(OBJ) + 5}-"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 416


def test_dfstore_cli_ranged_cp(store_cluster, tmp_path):
    da, _ = store_cluster["daemons"]
    dfstore.put_object(_gw(da), "bkt", "cli.bin", OBJ)
    out = tmp_path / "slice.bin"
    rc = dfstore.main(
        ["--endpoint", _gw(da), "cp", "df://bkt/cli.bin", str(out),
         "--range", "bytes=10-1033"]
    )
    assert rc == 0
    assert out.read_bytes() == OBJ[10:1034]


def test_dfstore_cli_range_validation(store_cluster, tmp_path):
    da, _ = store_cluster["daemons"]
    # malformed spec fails fast client-side (never a silent full copy)
    with pytest.raises(SystemExit):
        dfstore.main(["--endpoint", _gw(da), "cp", "df://b/k", str(tmp_path / "o"),
                      "--range", "bytes=zz"])
    # range on a df->df copy is meaningless → rejected
    with pytest.raises(SystemExit):
        dfstore.main(["--endpoint", _gw(da), "cp", "df://a/k", "df://b/k",
                      "--range", "0-9"])


def test_ranged_get_never_serves_stale_slices_after_overwrite(store_cluster):
    """An object overwrite must refresh RANGED reads too: the content
    digest versions the ranged task's identity (as tag salt), so the
    swarm can't keep serving v1 slice bytes forever."""
    da, _ = store_cluster["daemons"]

    v1 = bytes([65]) * 70000  # 'A' * 70000
    v2 = bytes([66]) * 70000  # 'B' * 70000
    dfstore.put_object(_gw(da), "bkt", "ver.bin", v1)

    def ranged():
        req = urllib.request.Request(
            f"http://{_gw(da)}/buckets/bkt/objects/ver.bin",
            headers={"Range": "bytes=10-109"},
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 206
            return r.read()

    assert ranged() == v1[10:110]
    dfstore.put_object(_gw(da), "bkt", "ver.bin", v2)
    assert dfstore.get_object(_gw(da), "bkt", "ver.bin") == v2  # unranged fresh
    assert ranged() == v2[10:110], "ranged read served stale pre-overwrite bytes"

    # 'bytes=0-' IS the whole object: same task as unranged (no
    # duplicate full-object cache copy) and the digest pin still applies
    assert dfstore.get_object(_gw(da), "bkt", "ver.bin", byte_range="bytes=0-") == v2

    # RFC surface: Accept-Ranges advertised; 416 carries the total
    req = urllib.request.Request(f"http://{_gw(da)}/buckets/bkt/objects/ver.bin")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.headers["Accept-Ranges"] == "bytes"

    req = urllib.request.Request(
        f"http://{_gw(da)}/buckets/bkt/objects/ver.bin",
        headers={"Range": "bytes=999999-"},
    )
    try:
        urllib.request.urlopen(req, timeout=30)
        raise AssertionError("want 416")
    except urllib.error.HTTPError as e:
        assert e.code == 416
        assert e.headers["Content-Range"] == f"bytes */{len(v2)}"


# ---------------------------------------------------------------------------
# the port's gateway against the reference's
# ---------------------------------------------------------------------------


def test_p2p_object_read_accounts_no_origin_bytes(store_cluster):
    """B's read of A's seeded object rides P2P: its pieces come from A, and
    the object plane's ledger gains parent bytes and no origin bytes."""
    da, db = store_cluster["daemons"]
    cluster, backend = store_cluster["cluster"], store_cluster["backend"]
    dfstore.put_object(_gw(da), "ledger", "shard-0", OBJ)
    tid = _object_task(backend, "ledger", "shard-0", OBJ)
    cluster.wait_seeded(tid, "host-a")
    before = t_flows.snapshot()["planes"]["object"]
    conn = http.client.HTTPConnection("127.0.0.1", db.object_gateway.port, timeout=30)
    try:
        conn.request("GET", "/buckets/ledger/objects/shard-0")
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    assert resp.status == 200 and body == OBJ
    assert resp.getheader("X-Dragonfly-Via-P2P") == "1" and resp.getheader("X-Dragonfly-Task-Id") == tid
    # the response ends at its last byte; the conductor's finish and the
    # gateway's served-bytes count follow moments later
    deadline = time.time() + 10
    while time.time() < deadline:
        ts = db.storage.find_completed_task(tid)
        after = t_flows.snapshot()["planes"]["object"]
        if ts is not None and after["served_bytes"] - before["served_bytes"] >= len(OBJ):
            break
        time.sleep(0.02)
    assert ts is not None
    assert {p.traffic_type for p in ts.meta.pieces.values()} == {TRAFFIC_REMOTE_PEER}
    assert after["bytes"]["origin"] == before["bytes"]["origin"]
    assert after["bytes"]["parent"] - before["bytes"]["parent"] == len(OBJ)
    assert after["served_bytes"] - before["served_bytes"] == len(OBJ)
    assert t_flows.task_plane(tid) == "object"


# (daemon, method, path, headers, body): one writer, one reader, every
# route, the range forms, an overwrite without seeding, the errors
_SEQUENCE = (
    ("a", "PUT", "/buckets/models", {}, b""),
    ("a", "PUT", "/buckets/models/objects/v1/weights.npz?mode=1", {}, "v1"),
    ("b", "HEAD", "/buckets/models/objects/v1/weights.npz", {}, b""),
    ("b", "GET", "/buckets/models/objects/v1/weights.npz", {}, b""),
    ("b", "GET", "/buckets/models/objects/v1/weights.npz", {"Range": "bytes=100-4195"}, b""),
    ("a", "GET", "/buckets/models/objects/v1/weights.npz", {"Range": "bytes=-77"}, b""),
    ("b", "GET", "/buckets/models/objects/v1/weights.npz", {"Range": "bytes=0-0"}, b""),
    ("b", "GET", "/buckets/models/objects/v1/weights.npz", {"Range": "bytes=zz"}, b""),
    ("b", "GET", "/buckets/models/objects/v1/weights.npz", {"Range": "bytes=999999-"}, b""),
    ("a", "GET", "/buckets/models/objects", {}, b""),
    ("b", "GET", "/buckets/models/objects?prefix=v1/", {}, b""),
    ("b", "GET", "/buckets/models/objects/v1/none.bin", {}, b""),
    ("b", "HEAD", "/buckets/models/objects/v1/none.bin", {}, b""),
    ("a", "PUT", "/buckets/models/objects/v1/weights.npz?mode=0", {}, "v2"),
    ("b", "GET", "/buckets/models/objects/v1/weights.npz", {}, b""),
    ("a", "GET", "/buckets/models/objects/v1/weights.npz", {"Range": "bytes=10-109"}, b""),
    ("a", "PUT", "/buckets/models/objects/v1/chunked.bin", {"Transfer-Encoding": "chunked"}, b""),
    ("a", "DELETE", "/buckets/models/objects/v1/weights.npz", {}, b""),
    ("a", "HEAD", "/buckets/models/objects/v1/weights.npz", {}, b""),
    ("a", "GET", "/nowhere", {}, b""),
    ("a", "POST", "/buckets/models", {}, b""),
)
_V1 = random.Random(18).randbytes(2 * PIECE + 100)
_V2 = random.Random(19).randbytes(PIECE + 3)


def _drive(cluster: _Cluster) -> list:
    """Send ``_SEQUENCE`` to the cluster's gateways → every answer's
    (daemon, method, path, status, headers but Date, body)."""
    answers = []
    for who, method, path, headers, body in _SEQUENCE:
        d = cluster.daemons[0 if who == "a" else 1]
        data = {"v1": _V1, "v2": _V2}.get(body, body)
        conn = http.client.HTTPConnection("127.0.0.1", d.object_gateway.port, timeout=30)
        try:
            if headers.get("Transfer-Encoding"):
                conn.putrequest(method, path)
                for k, v in headers.items():
                    conn.putheader(k, v)
                conn.endheaders(b"5\r\nhello\r\n0\r\n\r\n")
            else:
                conn.request(method, path, body=data or None, headers=headers)
            resp = conn.getresponse()
            got = resp.read()
            seen = {k: v for k, v in resp.getheaders() if k != "Date"}
        finally:
            conn.close()
        answers.append((who, method, path, resp.status, seen, got))
        if seen.get("X-Dragonfly-Via-P2P") == "1":
            # the reader's finish reaches the scheduler before the next
            # daemon asks, in both clusters alike
            tid = seen["X-Dragonfly-Task-Id"]
            deadline = time.time() + 10
            while d.storage.find_completed_task(tid) is None and time.time() < deadline:
                time.sleep(0.02)
            cluster.wait_seeded(tid, d.cfg.hostname)
        if method == "PUT" and "mode=1" in path:
            cluster.wait_seeded(
                _object_task(Path(d.cfg.object_storage_dir), "models", "v1/weights.npz", data),
                d.cfg.hostname,
            )
    return answers


def test_gateway_answers_match_the_reference(tmp_path):
    """The same gateway requests through the port's cluster and the
    reference's, each on one backend path (so the objects' task ids
    agree): every status, header but ``Date``, and body are equal."""
    backend = tmp_path / "backend"
    results = {}
    for pkg in ("torch", "jax"):
        shutil.rmtree(backend, ignore_errors=True)
        cluster = _Cluster(pkg, tmp_path / pkg, backend)
        try:
            results[pkg] = _drive(cluster)
        finally:
            cluster.stop()
    t, j = results["torch"], results["jax"]
    assert t == j
    assert [a[3] for a in t] == [201, 201, 200, 200, 206, 206, 206, 200, 416, 200, 200, 404, 404,
                                 201, 200, 206, 411, 204, 404, 404, 501]
    assert t[3][5] == _V1 and t[3][4]["X-Dragonfly-Via-P2P"] == "1"
    assert t[3][4]["X-Dragonfly-Task-Id"] == _object_task(backend, "models", "v1/weights.npz", _V1)
    assert t[4][5] == _V1[100:4196] and t[4][4]["Content-Range"] == f"bytes 100-4195/{len(_V1)}"
    assert t[5][5] == _V1[-77:] and t[6][4]["Content-Range"] == f"bytes 0-0/{len(_V1)}"
    assert t[8][4]["Content-Range"] == f"bytes */{len(_V1)}"
    assert t[9][5] == b'{"keys": ["v1/weights.npz"]}' == t[10][5]
    assert t[14][5] == _V2 and t[15][5] == _V2[10:110]


@pytest.mark.parametrize("cli_pkg,gateway_pkg", [("torch", "jax"), ("jax", "torch")])
def test_each_dfstore_drives_the_other_gateway(tmp_path, cli_pkg, gateway_pkg):
    """dfstore speaks the gateway's HTTP API: either package's CLI against
    the other package's gateway gives the same exit codes and bytes."""
    cli = _PKGS[cli_pkg][1]
    cluster = _Cluster(gateway_pkg, tmp_path, tmp_path / "backend")
    try:
        da, db = cluster.daemons
        src, out, part = tmp_path / "src.bin", tmp_path / "out.bin", tmp_path / "part.bin"
        src.write_bytes(OBJ)
        assert cli.main(["--endpoint", _gw(da), "mb", "df://x"]) == 0
        assert cli.main(["--endpoint", _gw(da), "cp", str(src), "df://x/k/obj.bin"]) == 0
        cluster.wait_object(tmp_path / "backend", "x", "k/obj.bin", OBJ)
        assert cli.main(["--endpoint", _gw(db), "cp", "df://x/k/obj.bin", str(out)]) == 0
        assert cli.main(["--endpoint", _gw(db), "cp", "df://x/k/obj.bin", str(part),
                         "--range", "5-99"]) == 0
        assert cli.main(["--endpoint", _gw(db), "stat", "df://x/k/obj.bin"]) == 0
        assert cli.main(["--endpoint", _gw(db), "cp", "df://x/k/obj.bin", "df://x/k/copy.bin",
                         "--no-seed"]) == 0
        assert cli.main(["--endpoint", _gw(da), "rm", "df://x/k/obj.bin"]) == 0
        assert cli.main(["--endpoint", _gw(da), "stat", "df://x/k/obj.bin"]) == 1
        assert out.read_bytes() == OBJ and part.read_bytes() == OBJ[5:100]
        assert dfstore.list_objects(_gw(da), "x") == j_dfstore.list_objects(_gw(db), "x") == ["k/copy.bin"]
    finally:
        cluster.stop()


@pytest.mark.parametrize("sizes,offset,length", [
    ((10, 10, 10), 0, 30),
    ((10, 10, 10), 5, 10),
    ((10, 10, 10), 10, 10),
    ((10, 10, 10), 25, 100),
    ((7, 0, 13, 1), 6, 9),
    ((4,), 0, 0),
    ((3, 3), 9, 2),
])
def test_slice_stream_matches_the_reference(sizes, offset, length):
    data = random.Random(sum(sizes)).randbytes(sum(sizes))
    chunks, at = [], 0
    for n in sizes:
        chunks.append(data[at:at + n])
        at += n
    t = list(t_objectstorage._slice_stream(iter(chunks), offset, length))
    j = list(j_objectstorage._slice_stream(iter(chunks), offset, length))
    assert t == j and b"".join(t) == data[offset:offset + length]


@pytest.mark.parametrize("uri", [
    "df://bucket/key", "df://bucket/a/b/c.bin", "df://bucket", "df://bucket/", "df:///key",
    "s3://bucket/key", "/local/path",
])
def test_parse_df_matches_the_reference(uri):
    def outcome(mod):
        try:
            return mod._parse_df(uri)
        except mod.DfstoreError as e:
            return ("DfstoreError", str(e))

    assert outcome(dfstore) == outcome(j_dfstore)


def test_daemon_serves_its_gateway_and_stops_it(store_cluster):
    """``DaemonConfig(object_storage_port=0, object_storage_dir=...)``
    serves the gateway on the ``object`` plane, its transport's one rule
    the backend's ``file://`` root; ``stop`` closes it."""
    da = store_cluster["daemons"][0]
    backend = str(store_cluster["backend"])
    gw = da.object_gateway
    assert gw.port > 0 and gw.transport.tasks is da.task_manager
    assert gw.plane == gw.transport.plane == "object"
    assert [r.regex for r in gw.transport.rules] == [re.escape(f"file://{backend}")]
    assert gw.url_for("b", "k/x") == f"file://{backend}/b/k/x"
    assert gw.importer == da._import_object
    store_cluster["cluster"].stop()
    store_cluster["cluster"].daemons = []
    conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=2)
    try:
        with pytest.raises(OSError):
            conn.request("GET", "/buckets/b/objects")
            conn.getresponse()
    finally:
        conn.close()


def test_daemon_without_object_storage_port_serves_none(tmp_path):
    d = Daemon(DaemonConfig(data_dir=str(tmp_path / "d"), scheduler_address="127.0.0.1:1"))
    try:
        assert d.object_gateway is None and d.cfg.object_storage_port == -1
    finally:
        d.upload.stop()


@pytest.mark.parametrize("cli", ["dfstore", "dfget", "dfcache"])
def test_client_clis_start_without_torch(cli):
    """The CLIs that move bytes load neither torch nor the card's stack:
    importing torch was most of a dfstore process's wall."""
    code = (f"import sys, dragonfly2_torch.client.{cli}; "
            "assert 'torch' not in sys.modules, sorted(m for m in sys.modules if m.startswith('torch'))")
    done = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert done.returncode == 0, done.stderr


def test_daemon_binary_prints_its_gateway_line(tmp_path):
    """``python -m dragonfly2_torch.client.daemon`` with a gateway prints
    ``GATEWAY daemon <host:port>`` before ``READY``, and dfstore reaches
    the gateway there."""
    cluster_resource = t_res.Resource()
    svc = t_service.SchedulerService(
        cluster_resource,
        t_scheduling.Scheduling(
            t_evaluator.BaseEvaluator(),
            t_scheduling.SchedulingConfig(retry_interval=0.05, retry_back_to_source_limit=3),
        ),
    )
    server, port = t_glue.serve({t_glue.SCHEDULER_SERVICE: svc})
    proc = None
    try:
        args = [sys.executable, "-m", "dragonfly2_torch.client.daemon"]
        for k, v in (("scheduler_address", f"127.0.0.1:{port}"), ("data_dir", tmp_path / "d"),
                     ("hostname", "gw-host"), ("announce_interval", 60), ("collect_host_stats", "false"),
                     ("object_storage_port", 0), ("object_storage_dir", tmp_path / "backend")):
            args += ["--set", f"{k}={v}"]
        env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
        proc = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                                cwd=str(REPO), env=env)
        lines = []
        while not lines or not lines[-1].startswith("READY "):
            line = proc.stdout.readline()
            assert line, f"the daemon exited before READY: {lines}"
            lines.append(line.strip())
        gateway = [ln for ln in lines if ln.startswith("GATEWAY ")]
        assert len(gateway) == 1 and gateway[0].split()[1] == "daemon"
        assert lines.index(gateway[0]) < len(lines) - 1
        addr = gateway[0].split()[2]
        assert addr.startswith("127.0.0.1:") and int(addr.rsplit(":", 1)[1]) > 0
        dfstore.create_bucket(addr, "b")
        dfstore.put_object(addr, "b", "k", b"through-the-binary")
        assert dfstore.get_object(addr, "b", "k") == b"through-the-binary"
        assert (tmp_path / "backend" / "b" / "k").read_bytes() == b"through-the-binary"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
    finally:
        if proc is not None:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
        server.stop(0)
