"""The reference's ``tests/test_concurrency.py``, case for case, on the port's
modules (``dragonfly2_torch``). The reference's manager REST case waits for the manager
server (ROADMAP queue A item A-D3).

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

PAYLOAD = os.urandom(256 * 1024)


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
