"""The reference's ``tests/test_concurrency.py``, case for case, on the port's
modules (``dragonfly2_torch``), its manager case on the port's REST front.

Systematic concurrency exercises (aux parity: the reference runs its
whole suite under go test -race; Python's races hide in shared dicts and
FSMs instead — these tests hammer the same invariants from many threads).
"""

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
from dragonfly2_torch.utils import profiling as t_profiling
from dragonfly2_tpu.utils import profiling as j_profiling

PAYLOAD = os.urandom(256 * 1024)


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # each package's daemons and servers start its process-wide stack sampler
    # and leave it running, as a server process would; stop both once the
    # module is done so their sweeps do not tax the files run after it in
    # this process
    yield
    t_profiling.stop()
    j_profiling.stop()


@pytest.fixture
def cluster(tmp_path):
    resource = res.Resource()
    storage = Storage(tmp_path / "records", buffer_size=4)
    service = SchedulerService(
        resource,
        Scheduling(
            BaseEvaluator(),
            SchedulingConfig(retry_interval=0.0, retry_back_to_source_limit=2),
        ),
        storage=storage,
    )
    server, port = serve({SCHED_SERVICE: service})
    d = Daemon(
        DaemonConfig(
            data_dir=str(tmp_path / "daemon"),
            scheduler_address=f"127.0.0.1:{port}",
            hostname="h-conc",
            ip="127.0.0.1",
            piece_length=32 * 1024,
            schedule_timeout=10.0,
            announce_interval=60.0,
        )
    )
    d.start()
    yield {"resource": resource, "daemon": d, "tmp": tmp_path}
    d.stop()
    server.stop(grace=None)


def test_concurrent_downloads_share_one_conductor(cluster):
    """16 threads requesting the same task concurrently must share one
    conductor (dedup under the task-manager lock), produce identical
    bytes, and leave exactly one peer on the scheduler."""
    d = cluster["daemon"]
    origin = cluster["tmp"] / "blob.bin"
    origin.write_bytes(PAYLOAD)
    url = f"file://{origin}"
    results: list[bytes] = [b""] * 16
    errors: list[Exception] = []
    barrier = threading.Barrier(16)

    def worker(i):
        try:
            barrier.wait(timeout=10)
            out = cluster["tmp"] / f"out-{i}.bin"
            dfget.download(f"127.0.0.1:{d.port}", url, str(out))
            results[i] = out.read_bytes()
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:3]
    assert all(r == PAYLOAD for r in results)
    # one task, one downloading peer on the scheduler (the conductor was
    # shared — concurrent requests did not register 16 peers)
    task_id = d.task_manager.task_id_for(url, None)
    task = cluster["resource"].task_manager.load(task_id)
    assert task is not None
    assert task.peer_count() == 1


def test_concurrent_distinct_tasks(cluster):
    """12 threads × distinct tasks: no cross-task interference, every
    task completes and records a distinct completed entry."""
    d = cluster["daemon"]
    payloads = {}
    for i in range(12):
        p = cluster["tmp"] / f"origin-{i}.bin"
        p.write_bytes(os.urandom(64 * 1024))
        payloads[i] = p
    errors: list[Exception] = []

    def worker(i):
        try:
            out = cluster["tmp"] / f"multi-out-{i}.bin"
            dfget.download(
                f"127.0.0.1:{d.port}", f"file://{payloads[i]}", str(out)
            )
            assert out.read_bytes() == payloads[i].read_bytes()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors[:3]


def test_concurrent_host_announce_and_leave():
    """AnnounceHost refresh racing LeaveHost on the resource layer must
    never corrupt the manager maps or deadlock."""
    from dragonfly2_torch.rpc import protos
    common_pb2 = protos.load("common_pb2")
    from dragonfly2_torch.rpc import protos
    scheduler_pb2 = protos.load("scheduler_pb2")

    resource = res.Resource()
    service = SchedulerService(
        resource, Scheduling(BaseEvaluator(), SchedulingConfig())
    )
    stop = threading.Event()
    errors: list[Exception] = []

    def announcer(i):
        info = common_pb2.HostInfo(
            id=f"host-{i % 4}", hostname=f"h{i}", ip="10.0.0.1", port=1
        )
        while not stop.is_set():
            try:
                service.AnnounceHost(
                    scheduler_pb2.AnnounceHostRequest(host=info), None
                )
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    def leaver():
        while not stop.is_set():
            try:
                for i in range(4):
                    service.LeaveHost(
                        scheduler_pb2.LeaveHostRequest(host_id=f"host-{i}"), None
                    )
            except Exception as e:  # pragma: no cover
                errors.append(e)
                return

    threads = [threading.Thread(target=announcer, args=(i,)) for i in range(6)]
    threads.append(threading.Thread(target=leaver))
    for t in threads:
        t.start()
    import time

    time.sleep(1.5)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    assert not errors, errors[:3]


def test_manager_rest_surfaces_under_concurrent_load(tmp_path):
    """Hammer the newest manager surfaces from many threads at once:
    config CRUD, group-job creation + leasing, and certificate issuance
    must produce no 500s and a consistent end state (sqlite behind one
    process-wide connection — exactly where races would hide)."""
    import json
    import urllib.error
    import urllib.request

    from dragonfly2_torch.manager.database import Database
    from dragonfly2_torch.manager.models_registry import ModelRegistry
    from dragonfly2_torch.manager.objectstorage import FSObjectStorage
    from dragonfly2_torch.manager.rest import RestServer
    from dragonfly2_torch.manager.service import SERVICE_NAME, ManagerService
    from dragonfly2_torch.rpc import glue, protos
    from dragonfly2_torch.utils.issuer import CertificateAuthority, obtain_certificate

    manager_pb2 = protos.load("manager_pb2")

    db = Database(tmp_path / "m.db")
    svc = ManagerService(
        db, ModelRegistry(db, FSObjectStorage(tmp_path / "o")),
        ca=CertificateAuthority(common_name="load CA"),
    )
    rest = RestServer(svc, tokens={"tok": "admin"})
    addr = rest.start()
    gsrv, gport = glue.serve({SERVICE_NAME: svc})
    errors: list[str] = []

    def call(method, path, body=None):
        req = urllib.request.Request(
            f"http://{addr}{path}", method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Authorization": "Bearer tok"},
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def guarded(label, fn):
        # ANY worker exception must land in `errors`, not silently kill
        # the thread and surface later as a bare count mismatch
        def runner(i):
            try:
                fn(i)
            except Exception as e:
                errors.append(f"{label}: {type(e).__name__}: {e}")
        return runner

    N = 6

    def config_worker(i):
        for j in range(8):
            st, _ = call("POST", "/api/v1/configs", {"name": f"c-{i}-{j}", "value": str(j)})
            if st >= 500:
                errors.append(f"config POST {st}")
            st, _ = call("GET", "/api/v1/configs")
            if st >= 500:
                errors.append(f"config GET {st}")

    def group_worker(i):
        for j in range(4):
            st, g = call(
                "POST", "/api/v1/jobs",
                {"type": "sync_peers", "scheduler_cluster_ids": [1, 2]},
            )
            if st != 200:
                errors.append(f"group POST {st}")
                continue
            st, _ = call("GET", f"/api/v1/jobs/groups/{g['group_id']}")
            if st >= 500:
                errors.append(f"group GET {st}")

    def lease_worker(i):
        chan = glue.dial(f"127.0.0.1:{gport}")
        client = glue.ServiceClient(chan, SERVICE_NAME)
        for j in range(6):
            try:
                leased = client.ListPendingJobs(
                    manager_pb2.ListPendingJobsRequest(
                        ip=f"10.0.0.{i}", hostname=f"w{i}", scheduler_cluster_id=1 + (j % 2)
                    )
                )
                for job in leased.jobs:
                    client.UpdateJobResult(
                        manager_pb2.UpdateJobResultRequest(
                            id=job.id, state="succeeded",
                            result_json=json.dumps({"hosts": []}),
                            ip=f"10.0.0.{i}", hostname=f"w{i}",
                        )
                    )
            except Exception as e:
                errors.append(f"lease: {e}")
        chan.close()

    def cert_worker(i):
        for j in range(3):
            try:
                _, leaf, _ = obtain_certificate(f"127.0.0.1:{gport}", f"svc-{i}-{j}")
                assert b"BEGIN CERTIFICATE" in leaf
            except Exception as e:
                errors.append(f"cert: {e}")

    threads = []
    for i in range(N):
        for fn in (config_worker, group_worker, lease_worker, cert_worker):
            threads.append(
                threading.Thread(target=guarded(fn.__name__, fn), args=(i,), daemon=True)
            )
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    try:
        hung = [t.name for t in threads if t.is_alive()]
        assert not hung, f"workers still running at the count asserts: {hung}"
        assert not errors, errors[:10]
        st, configs = call("GET", "/api/v1/configs")
        assert st == 200 and len(configs) == N * 8
        # every group eventually readable and internally consistent
        rows = db.query("SELECT DISTINCT group_id FROM jobs WHERE group_id != ''")
        assert len(rows) == N * 4
    finally:
        gsrv.stop(0)
        rest.stop()
        db.close()
