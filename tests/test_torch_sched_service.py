"""The scheduler's gRPC services (``scheduler/service.py`` v2 and
``scheduler/service_v1.py``) against the reference's, without a wire: the
conversations of ``tests/test_rpc.py`` and ``tests/test_scheduler_v1.py``
scripted on one thread (each request handed to the service's own
handler, scheduling under ``random.seed``) into a reference and a port
``SchedulerService`` over their own resource model, storage and KV-backed
network topology — with the base evaluator, and with the ``ml`` evaluator
holding the same npz MLP (the port's on the CPU).

Checked: the responses are equal message for message (their serialized
bytes; both packages' generated modules are byte-identical copies), the
download records are equal field for field apart from wall-clock stamps,
and the probe graph after ``SyncProbes`` is equal key for key in the KV
store and row for row in the topology export."""

import gc
import random
import weakref

import numpy as np
import pytest
import torch

from dragonfly2_torch.models.mlp import init_mlp as t_init_mlp
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.scheduler import evaluator as t_evaluator
from dragonfly2_torch.scheduler import networktopology as t_nt
from dragonfly2_torch.scheduler import resource as t_res
from dragonfly2_torch.scheduler import scheduling as t_scheduling
from dragonfly2_torch.scheduler import service as t_service
from dragonfly2_torch.scheduler import service_v1 as t_service_v1
from dragonfly2_torch.scheduler import storage as t_storage
from dragonfly2_torch.schema import records as t_records
from dragonfly2_torch.trainer import serving as t_serving
from dragonfly2_torch.utils import kvstore as t_kv
from dragonfly2_torch.weights import serialize_params

from dragonfly2_tpu.scheduler import evaluator as j_evaluator
from dragonfly2_tpu.scheduler import networktopology as j_nt
from dragonfly2_tpu.scheduler import resource as j_res
from dragonfly2_tpu.scheduler import scheduling as j_scheduling
from dragonfly2_tpu.scheduler import service as j_service
from dragonfly2_tpu.scheduler import service_v1 as j_service_v1
from dragonfly2_tpu.scheduler import storage as j_storage
from dragonfly2_tpu.schema import records as j_records
from dragonfly2_tpu.trainer import serving as j_serving
from dragonfly2_tpu.utils import kvstore as j_kv

torch.set_num_threads(1)

sp = protos.load("scheduler_pb2")
cp = protos.load("common_pb2")
v1 = protos.load("scheduler_v1_pb2")

PORT = dict(res=t_res, nt=t_nt, sched=t_scheduling, svc=t_service, svc1=t_service_v1,
            storage=t_storage, ev=t_evaluator, kv=t_kv, records=t_records)
REF = dict(res=j_res, nt=j_nt, sched=j_scheduling, svc=j_service, svc1=j_service_v1,
           storage=j_storage, ev=j_evaluator, kv=j_kv, records=j_records)
URL = "https://origin.example/blob"
# wall-clock stamps a record takes from the machine's clock, not the script
CLOCK_FIELDS = ("created_at", "updated_at")


class _Aborted(Exception):
    pass


class _Context:
    """The server context a handler may abort through."""

    def __init__(self):
        self.code = None

    def abort(self, code, details):
        self.code = code
        raise _Aborted(details)

    def invocation_metadata(self):
        return ()


@pytest.fixture(scope="module")
def mlp_blob():
    return serialize_params(t_init_mlp(torch.Generator().manual_seed(3), [19, 16, 16, 1]))


class Side:
    """One package's scheduler services over their own state."""

    def __init__(self, pkg, tmp, evaluator_kind, blob):
        self.p = pkg
        self.resource = pkg["res"].Resource()
        self.storage = pkg["storage"].Storage(tmp, buffer_size=1)
        self.nt = pkg["nt"].NetworkTopology(pkg["kv"].KVStore(), self.resource.host_manager, self.storage)
        if evaluator_kind == "ml":
            if pkg is PORT:
                scorer = t_serving.MLPScorer(t_serving.deserialize_params_auto(blob), device="cpu")
            else:
                scorer = j_serving.MLPScorer(j_serving.deserialize_params_auto(blob))
            ev = pkg["ev"].MLEvaluator(model=scorer)
        else:
            ev = pkg["ev"].BaseEvaluator()
        cfg = pkg["sched"].SchedulingConfig(retry_limit=2, retry_back_to_source_limit=1, retry_interval=0.0)
        self.scheduling = pkg["sched"].Scheduling(ev, cfg)
        self.v2 = pkg["svc"].SchedulerService(self.resource, self.scheduling, storage=self.storage,
                                              networktopology=self.nt)
        self.v1 = pkg["svc1"].SchedulerServiceV1(self.resource, self.scheduling, storage=self.storage,
                                                 networktopology=self.nt)
        self.streams = {}  # peer id → (adapter, state) of its AnnouncePeer stream
        self.v1_streams = {}  # peer id → the box of its ReportPieceResult stream
        self.out = []  # every response, serialized, in order

    # -- v2 ---------------------------------------------------------------
    def announce(self, req, step):
        random.seed(step)
        pid = req.peer_id
        if pid not in self.streams:
            self.streams[pid] = (self.p["svc"]._StreamAdapter(), {"peer": None})
        adapter, state = self.streams[pid]
        self.v2._handle_announce(req, adapter, state)
        self._drain(adapter.out)

    def unary(self, name, req, step, v1_side=False):
        random.seed(step)
        svc = self.v1 if v1_side else self.v2
        ctx = _Context()
        try:
            resp = getattr(svc, name)(req, ctx)
        except _Aborted as e:
            self.out.append(("aborted", str(ctx.code), str(e)))
            return
        self.out.append(resp.SerializeToString())

    def sync_probes(self, reqs, step):
        random.seed(step)
        for resp in self.v2._sync_probes(iter(reqs)):
            self.out.append(resp.SerializeToString())

    # -- v1 ---------------------------------------------------------------
    def report_piece(self, req, step):
        random.seed(step)
        box = self.v1_streams.setdefault(req.src_pid, {"adapter": None, "peer": None})
        self.v1._handle_piece_result(req, box)
        if box["adapter"] is not None:
            self._drain(box["adapter"].out)

    def _drain(self, q):
        while not q.empty():
            msg = q.get_nowait()
            self.out.append(None if msg is None else msg.SerializeToString())

    # -- results ----------------------------------------------------------
    def records(self):
        self.storage.flush()
        flat = [self.p["records"].flatten(r) for r in self.storage.list_download()]
        return [{k: v for k, v in f.items() if not k.endswith(CLOCK_FIELDS)} for f in flat]


def host(i, seed=False):
    return cp.HostInfo(
        id=f"host-{i}", type="super" if seed else "normal", hostname=f"h{i}", ip=f"10.0.0.{i}",
        port=8002, download_port=8001, concurrent_upload_limit=50,
        cpu=cp.CpuStat(percent=10.0 * i), memory=cp.MemoryStat(used_percent=5.0 * i),
        network=cp.NetworkStat(idc="idc-a", location=f"as|cn|sh|dc{i % 3}",
                               tcp_connection_count=7 * i, upload_tcp_connection_count=i),
        disk=cp.DiskStat(used_percent=3.0 * i),
    )


def ap(hid, pid, task="task-1", **kw):
    return sp.AnnouncePeerRequest(host_id=f"host-{hid}", task_id=task, peer_id=pid, **kw)


def register(hid, pid, task="task-1", demand=False):
    return ap(hid, pid, task, register_peer=sp.RegisterPeerRequest(
        task_id=task, peer_id=pid, url=URL, need_back_to_source=demand))


def piece(hid, pid, n, parent="", cost_ms=5.0, task="task-1"):
    return ap(hid, pid, task, download_piece_finished=sp.DownloadPieceFinishedRequest(piece=cp.PieceInfo(
        number=n, parent_id=parent, offset=n << 20, length=1 << 20,
        traffic_type="remote_peer" if parent else "back_to_source", cost_ns=int(cost_ms * 1e6),
        created_at_ns=1_700_000_000_000_000_000 + n)))


def finished(hid, pid, pieces=8, task="task-1"):
    return ap(hid, pid, task, download_peer_finished=sp.DownloadPeerFinishedRequest(
        content_length=pieces << 20, piece_count=pieces, cost_ns=int(1e9)))


def seed_script(task="task-1", pieces=8):
    """``tests/test_rpc.py``'s seed: register (demanding the origin),
    back-to-source, its pieces, finished."""
    return [
        ("unary", "AnnounceHost", sp.AnnounceHostRequest(host=host(0, seed=True))),
        ("announce", register(0, "seed-peer", task, demand=True)),
        ("announce", ap(0, "seed-peer", task, download_peer_back_to_source_started=(
            sp.DownloadPeerBackToSourceStartedRequest()))),
        *[("announce", piece(0, "seed-peer", n, task=task)) for n in range(pieces)],
        ("announce", finished(0, "seed-peer", pieces, task)),
    ]


def child_script(i, parents, task="task-1", pieces=8, finish=True):
    steps = [
        ("unary", "AnnounceHost", sp.AnnounceHostRequest(host=host(i))),
        ("announce", register(i, f"child-{i}", task)),
        ("announce", ap(i, f"child-{i}", task, download_peer_started=sp.DownloadPeerStartedRequest())),
        *[("announce", piece(i, f"child-{i}", n, parents[n % len(parents)], cost_ms=3.0 + i + n, task=task))
          for n in range(pieces)],
    ]
    if finish:
        steps.append(("announce", finished(i, f"child-{i}", pieces, task)))
    return steps


V2_SCRIPTS = {
    # a child scheduled off the seed, its pieces and record
    "child_off_seed": seed_script() + child_script(1, ["seed-peer"]),
    # a chain: later children see earlier ones as candidates
    "swarm": seed_script() + [s for i in range(1, 7) for s in child_script(i, ["seed-peer"])],
    # reschedule with the only parent blocked falls back to the origin
    "reschedule_blocks_parent": seed_script() + child_script(1, ["seed-peer"], finish=False) + [
        ("announce", ap(1, "child-1", reschedule=sp.RescheduleRequest(blocked_parent_ids=["seed-peer"]))),
    ],
    # a failed piece blocklists its parent; a failed peer writes an error record
    "failures": seed_script() + child_script(2, ["seed-peer"], finish=False) + [
        ("announce", ap(2, "child-2", download_piece_failed=sp.DownloadPieceFailedRequest(
            piece_number=3, parent_id="seed-peer"))),
        ("announce", ap(2, "child-2", download_peer_failed=sp.DownloadPeerFailedRequest(description="boom"))),
    ],
    # stat, leave and the unknown-peer abort
    "stat_and_leave": seed_script() + [
        ("unary", "StatPeer", sp.StatPeerRequest(task_id="task-1", peer_id="seed-peer")),
        ("unary", "StatTask", sp.StatTaskRequest(task_id="task-1")),
        ("unary", "LeavePeer", sp.LeavePeerRequest(task_id="task-1", peer_id="seed-peer")),
        ("unary", "StatPeer", sp.StatPeerRequest(task_id="task-1", peer_id="seed-peer")),
        ("unary", "StatPeer", sp.StatPeerRequest(task_id="task-1", peer_id="ghost")),
        ("unary", "StatTask", sp.StatTaskRequest(task_id="task-9")),
        ("unary", "LeaveHost", sp.LeaveHostRequest(host_id="host-0")),
    ],
    # an announced, already-downloaded task is a parent at once
    "announce_task": [
        ("unary", "AnnounceHost", sp.AnnounceHostRequest(host=host(5))),
        ("unary", "AnnounceTask", sp.AnnounceTaskRequest(
            host_id="host-5", task_id="task-1", peer_id="cached", url=URL, content_length=3 << 20,
            piece_length=1 << 20,
            pieces=[cp.PieceInfo(number=n, offset=n << 20, length=1 << 20, cost_ns=1) for n in range(3)])),
    ] + child_script(6, ["cached"], pieces=3),
    # two tasks interleaved
    "two_tasks": seed_script("task-a") + seed_script("task-b")[1:]
    + child_script(3, ["seed-peer"], task="task-a")[:4] + child_script(4, ["seed-peer"], task="task-b"),
}


def _run(script, side):
    for step, item in enumerate(script):
        if item[0] == "announce":
            side.announce(item[1], step)
        elif item[0] == "unary":
            side.unary(item[1], item[2], step)
        elif item[0] == "v1_unary":
            side.unary(item[1], item[2], step, v1_side=True)
        elif item[0] == "report":
            side.report_piece(item[1], step)
        elif item[0] == "sync":
            side.sync_probes(item[1], step)


@pytest.mark.parametrize("evaluator", ["base", "ml"])
@pytest.mark.parametrize("name", sorted(V2_SCRIPTS))
def test_v2_conversations_match(name, evaluator, tmp_path, mlp_blob):
    ref = Side(REF, tmp_path / "ref", evaluator, mlp_blob)
    port = Side(PORT, tmp_path / "port", evaluator, mlp_blob)
    _run(V2_SCRIPTS[name], ref)
    _run(V2_SCRIPTS[name], port)
    assert len(port.out) == len(ref.out) > 0
    for n, (a, b) in enumerate(zip(port.out, ref.out)):
        assert a == b, f"response {n} differs"
    assert port.records() == ref.records()
    for pid, (_, state) in ref.streams.items():
        peer = state["peer"]
        if peer is not None:
            twin = port.resource.peer_manager.load(pid)
            assert twin.fsm.current == peer.fsm.current and twin.finished_pieces == peer.finished_pieces


# -- v1 ---------------------------------------------------------------------


def peer_host(i):
    return v1.PeerHost(id=f"host-{i}", ip=f"10.0.0.{i}", rpc_port=8002, down_port=8001,
                       hostname=f"h{i}", idc="idc-a", location="as|cn|sh")


def v1_register(i, pid, demand=False):
    return ("v1_unary", "RegisterPeerTask",
            v1.PeerTaskRequest(url=URL, peer_id=pid, peer_host=peer_host(i), need_back_to_source=demand))


def _task_id():
    from dragonfly2_torch.utils.idgen import URLMeta, task_id_v1

    return task_id_v1(URL, URLMeta())


def v1_source(i, pid, pieces=3):
    """``tests/test_scheduler_v1.py``'s back-to-source download."""
    tid = _task_id()
    return [
        v1_register(i, pid, demand=True),
        ("report", v1.PieceResult(task_id=tid, src_pid=pid, piece_info=cp.PieceInfo(number=-1))),
        *[("report", v1.PieceResult(task_id=tid, src_pid=pid, success=True, finished_count=n + 1,
                                    piece_info=cp.PieceInfo(number=n, offset=n << 20, length=1 << 20,
                                                            traffic_type="back_to_source", cost_ns=5_000_000)))
          for n in range(pieces)],
        ("v1_unary", "ReportPeerResult", v1.PeerResult(task_id=tid, peer_id=pid, success=True,
                                                        content_length=pieces << 20, total_piece_count=pieces,
                                                        cost_ns=123_000_000)),
    ]


def v1_child(i, pid, parent, pieces=3):
    tid = _task_id()
    return [
        v1_register(i, pid),
        ("report", v1.PieceResult(task_id=tid, src_pid=pid, piece_info=cp.PieceInfo(number=-1))),
        *[("report", v1.PieceResult(task_id=tid, src_pid=pid, dst_pid=parent, success=True,
                                    finished_count=n + 1,
                                    piece_info=cp.PieceInfo(number=n, offset=n << 20, length=1 << 20,
                                                            traffic_type="remote_peer", cost_ns=(2 + n) * 10**6)))
          for n in range(pieces)],
        ("v1_unary", "ReportPeerResult", v1.PeerResult(task_id=tid, peer_id=pid, success=True,
                                                        content_length=pieces << 20, total_piece_count=pieces,
                                                        cost_ns=99_000_000)),
    ]


V1_SCRIPTS = {
    "back_to_source_then_child": v1_source(1, "peer-1") + v1_child(2, "peer-2", "peer-1"),
    "piece_failure_reschedules": v1_source(1, "peer-1") + v1_child(2, "peer-2", "peer-1")[:2] + [
        ("report", v1.PieceResult(task_id=_task_id(), src_pid="peer-2", dst_pid="peer-1", success=False,
                                  code=v1.CODE_CLIENT_PIECE_FAIL, piece_info=cp.PieceInfo(number=1))),
    ],
    "small_task_single_piece": v1_source(1, "peer-1", pieces=1) + [v1_register(2, "peer-2")],
    "failed_peer_result": v1_source(1, "peer-1")[:2] + [
        ("v1_unary", "ReportPeerResult", v1.PeerResult(task_id=_task_id(), peer_id="peer-1", success=False,
                                                        code=v1.CODE_CLIENT_PIECE_FAIL)),
    ],
    "peer_gone": [("report", v1.PieceResult(task_id="task-x", src_pid="ghost", piece_info=cp.PieceInfo(number=-1)))],
    "stat_and_leave": v1_source(1, "peer-1") + [
        ("v1_unary", "StatTask", v1.StatTaskRequest(task_id=_task_id())),
        ("v1_unary", "LeaveTask", v1.PeerTarget(task_id=_task_id(), peer_id="peer-1")),
        ("v1_unary", "LeaveHost", v1.LeaveHostRequest(host_id="host-1")),
        ("v1_unary", "StatTask", v1.StatTaskRequest(task_id="nope")),
    ],
    "cross_generation": v1_source(1, "peer-1") + child_script(3, ["peer-1"], task=_task_id(), pieces=3),
}


@pytest.mark.parametrize("evaluator", ["base", "ml"])
@pytest.mark.parametrize("name", sorted(V1_SCRIPTS))
def test_v1_conversations_match(name, evaluator, tmp_path, mlp_blob):
    ref = Side(REF, tmp_path / "ref", evaluator, mlp_blob)
    port = Side(PORT, tmp_path / "port", evaluator, mlp_blob)
    _run(V1_SCRIPTS[name], ref)
    _run(V1_SCRIPTS[name], port)
    assert len(port.out) == len(ref.out) > 0
    for n, (a, b) in enumerate(zip(port.out, ref.out)):
        assert a == b, f"response {n} differs"
    assert port.records() == ref.records()


# -- probes -----------------------------------------------------------------


def _probe_script(hosts=12, seed=5):
    rng = np.random.default_rng(seed)
    steps = [("unary", "AnnounceHost", sp.AnnounceHostRequest(host=host(i))) for i in range(hosts)]
    for i in range(hosts):
        others = [j for j in range(hosts) if j != i]
        dests = rng.choice(others, 4, replace=False)
        reqs = [sp.SyncProbesRequest(host=host(i), probe_started=sp.ProbeStartedRequest())]
        for rnd in range(2):
            reqs.append(sp.SyncProbesRequest(host=host(i), probe_finished=sp.ProbeFinishedRequest(probes=[
                sp.ProbeResult(host_id=f"host-{j}", rtt_ns=int(rng.integers(1, 90) * 1e6),
                               created_at_ns=1_700_000_000_000_000_000 + 10**9 * (rnd * 100 + k))
                for k, j in enumerate(dests)
            ])))
        steps.append(("sync", reqs))
    return steps


def _kv_dump(side):
    kv = side.nt.kv
    out = {}
    for key in sorted(kv.scan_iter("*")):
        if key.startswith("networktopology:"):
            # createdAt is the scheduler's clock at the edge's first probe
            out[key] = {f: v for f, v in kv.hgetall(key).items() if f != "createdAt"}
        elif key.startswith("probes:"):
            out[key] = kv.lrange(key, 0, -1)
        else:
            out[key] = kv.get(key)
    return out


def test_sync_probes_builds_the_same_graph(tmp_path):
    ref = Side(REF, tmp_path / "ref", "base", None)
    port = Side(PORT, tmp_path / "port", "base", None)
    script = _probe_script()
    _run(script, ref)
    _run(script, port)
    assert port.out == ref.out  # the probe targets named to each host
    assert _kv_dump(port) == _kv_dump(ref) and len(_kv_dump(ref)) > 0
    rows = [sorted((r.host.id, [(d.id, d.probes.average_rtt, d.probes.updated_at) for d in r.dest_hosts])
                   for r in s.nt.export_records()) for s in (port, ref)]
    assert rows[0] == rows[1] and len(rows[0]) == 12


def test_leave_host_purges_the_graph(tmp_path):
    sides = [Side(pkg, tmp_path / name, "base", None) for pkg, name in ((REF, "ref"), (PORT, "port"))]
    for side in sides:
        _run(_probe_script(hosts=6) + [("unary", "LeaveHost", sp.LeaveHostRequest(host_id="host-2"))], side)
    assert _kv_dump(sides[0]) == _kv_dump(sides[1])
    assert not any("host-2" in k for k in _kv_dump(sides[1]))


def test_departed_peers_die_without_the_collector(tmp_path, mlp_blob):
    # the scheduler server freezes its heap (scheduler/server.py), so a peer
    # that has left and been reclaimed must die by reference counting, never
    # only through the cyclic collector, which skips frozen objects
    side = Side(PORT, tmp_path, "base", mlp_blob)
    _run(V2_SCRIPTS["swarm"], side)
    for _, state in side.streams.values():
        state["peer"].delete_stream()  # the stream's teardown
    side.streams.clear()
    del state
    peers = side.resource.peer_manager.all()
    refs = [weakref.ref(p) for p in peers]
    pids = [p.id for p in peers]
    del peers
    assert len(refs) == 7
    gc.collect()
    gc.disable()
    try:
        for step, pid in enumerate(pids):
            side.unary("LeavePeer", sp.LeavePeerRequest(task_id="task-1", peer_id=pid), step)
        assert side.resource.peer_manager.run_gc(ttl=3600.0) == len(pids)
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()
