"""The port's RPC plane (``rpc/glue.py``, ``rpc/resilience.py``,
``rpc/diagnose.py``, ``manager/service.py``'s client) against the
reference's, over real gRPC on localhost.

- Wire interop: a port server answers a reference client and a reference
  server answers a port client, for each service the servers bind
  (scheduler v2 and v1, topology, trainer, diagnose, and the manager's
  model registry through the port's client).
- ``ConsistentHashRing`` gives the reference's assignments and successor
  orders for the same members and keys.
- ``wrap_call``'s retries, retry budget, circuit breaker, deadline and
  hedge behave as the reference's under the same scripted failures: the
  same attempt counts and the same outcomes.
- An injected fault at the announcer's upload (the client send point)
  degrades the same way in both packages: the port's ``InjectedFault`` is
  a ``grpc.RpcError``, so the Capabilities probe falls back to CSV."""

import json
import random
import time

import grpc
import pytest
import torch

from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.rpc import resilience as t_res
from dragonfly2_torch.rpc.diagnose import DiagnoseService as TDiagnose
from dragonfly2_torch.manager.service import ManagerGrpcClientAdapter as TManagerAdapter
from dragonfly2_torch.scheduler import resource as t_resource
from dragonfly2_torch.scheduler.announcer import Announcer as TAnnouncer
from dragonfly2_torch.scheduler.evaluator import BaseEvaluator as TBase
from dragonfly2_torch.scheduler.scheduling import Scheduling as TScheduling
from dragonfly2_torch.scheduler.service import SchedulerService as TService
from dragonfly2_torch.scheduler.service_v1 import SchedulerServiceV1 as TServiceV1
from dragonfly2_torch.scheduler.storage import Storage as TStorage
from dragonfly2_torch.scheduler.topology_service import TopologyService as TTopology
from dragonfly2_torch.schema import synth as t_synth
from dragonfly2_torch.topology import TopologyConfig, TopologyEngine
from dragonfly2_torch.utils import faults as t_faults

from dragonfly2_tpu.manager.database import Database
from dragonfly2_tpu.manager.models_registry import ModelRegistry
from dragonfly2_tpu.manager.objectstorage import FSObjectStorage
from dragonfly2_tpu.manager.service import ManagerService
from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.rpc import resilience as j_res
from dragonfly2_tpu.rpc.diagnose import DiagnoseService as JDiagnose
from dragonfly2_tpu.scheduler import resource as j_resource
from dragonfly2_tpu.scheduler.announcer import Announcer as JAnnouncer
from dragonfly2_tpu.scheduler.evaluator import BaseEvaluator as JBase
from dragonfly2_tpu.scheduler.scheduling import Scheduling as JScheduling
from dragonfly2_tpu.scheduler.service import SchedulerService as JService
from dragonfly2_tpu.scheduler.service_v1 import SchedulerServiceV1 as JServiceV1
from dragonfly2_tpu.scheduler.storage import Storage as JStorage
from dragonfly2_tpu.scheduler.topology_service import TopologyService as JTopology
from dragonfly2_tpu.schema import synth as j_synth
from dragonfly2_tpu.utils import faults as j_faults

torch.set_num_threads(1)

sp = protos.load("scheduler_pb2")
cp = protos.load("common_pb2")
v1 = protos.load("scheduler_v1_pb2")
tp = protos.load("topology_pb2")
trp = protos.load("trainer_pb2")
dp = protos.load("diagnose_pb2")
mp = protos.load("manager_pb2")

GLUES = {"port": t_glue, "ref": j_glue}


def test_service_names_and_method_tables_match():
    for name in ("SCHEDULER_SERVICE", "SCHEDULER_V1_SERVICE", "TOPOLOGY_SERVICE", "TRAINER_SERVICE",
                 "MANAGER_SERVICE", "DFDAEMON_SERVICE", "DIAGNOSE_SERVICE", "TELEMETRY_SERVICE"):
        assert getattr(t_glue, name) == getattr(j_glue, name)
    assert t_glue.SERVICES.keys() == j_glue.SERVICES.keys()
    for svc, methods in j_glue.SERVICES.items():
        got = t_glue.SERVICES[svc]
        assert got.keys() == methods.keys()
        for m, ref in methods.items():
            assert got[m].kind == ref.kind
            assert got[m].request.DESCRIPTOR.full_name == ref.request.DESCRIPTOR.full_name
            assert got[m].response.DESCRIPTOR.full_name == ref.response.DESCRIPTOR.full_name


def _host(i):
    return cp.HostInfo(id=f"host-{i}", hostname=f"h{i}", ip=f"10.0.0.{i}", port=8002, download_port=8001,
                       concurrent_upload_limit=50, network=cp.NetworkStat(idc="a", location="x|y"))


class _Trainer:
    """A trainer that keeps what it is sent."""

    def __init__(self, formats=("columnar-v1", "csv")):
        self.formats = formats
        self.requests = []

    def Capabilities(self, request, context):
        return trp.CapabilitiesResponse(train_formats=list(self.formats))

    def Train(self, request_iterator, context):
        self.requests.extend(request_iterator)
        return trp.TrainResponse()


def _impls(side, tmp_path):
    """One package's implementations of the services its servers bind."""
    if side == "port":
        res = t_resource.Resource()
        sched = TScheduling(TBase())
        engine = TopologyEngine(TopologyConfig(flush_threshold=10**9), device="cpu")
        return {
            t_glue.SCHEDULER_SERVICE: TService(res, sched),
            t_glue.SCHEDULER_V1_SERVICE: TServiceV1(res, sched),
            t_glue.TOPOLOGY_SERVICE: TTopology(engine),
            t_glue.TRAINER_SERVICE: _Trainer(),
            t_glue.DIAGNOSE_SERVICE: TDiagnose(),
        }, engine
    from dragonfly2_tpu.topology import TopologyConfig as JConfig
    from dragonfly2_tpu.topology import TopologyEngine as JEngine

    res = j_resource.Resource()
    sched = JScheduling(JBase())
    engine = JEngine(JConfig(backend="numpy", flush_threshold=10**9))
    return {
        j_glue.SCHEDULER_SERVICE: JService(res, sched),
        j_glue.SCHEDULER_V1_SERVICE: JServiceV1(res, sched),
        j_glue.TOPOLOGY_SERVICE: JTopology(engine),
        j_glue.TRAINER_SERVICE: _Trainer(),
        j_glue.DIAGNOSE_SERVICE: JDiagnose(),
    }, engine


def _conversation(glue, addr):
    """Each bound service once, through ``glue``'s client → its answers."""
    ch = glue.dial(addr)
    try:
        out = []
        s2 = glue.ServiceClient(ch, glue.SCHEDULER_SERVICE)
        for i in range(3):
            out.append(s2.AnnounceHost(sp.AnnounceHostRequest(host=_host(i))).SerializeToString())
        try:
            s2.StatTask(sp.StatTaskRequest(task_id="nope"))
        except grpc.RpcError as e:
            out.append(("StatTask", e.code().name))
        # a seed registers demanding the origin on a live AnnouncePeer stream
        reqs = iter([sp.AnnouncePeerRequest(host_id="host-0", task_id="t", peer_id="seed",
                                            register_peer=sp.RegisterPeerRequest(
                                                task_id="t", peer_id="seed", url="https://o/b",
                                                need_back_to_source=True))])
        out.extend(r.SerializeToString() for r in s2.AnnouncePeer(reqs))
        out.append(s2.StatTask(sp.StatTaskRequest(task_id="t")).SerializeToString())
        s1 = glue.ServiceClient(ch, glue.SCHEDULER_V1_SERVICE)
        out.append(s1.AnnounceHost(v1.AnnounceHostRequest(host=_host(7))).SerializeToString())
        out.append(s1.StatTask(v1.StatTaskRequest(task_id="t")).SerializeToString())
        topo = glue.ServiceClient(ch, glue.TOPOLOGY_SERVICE)
        out.append(topo.EstRtt(tp.EstRttRequest(src_host_id="host-0", dest_host_id="host-1")).SerializeToString())
        # age_s is the engine's clock at the query, not part of the answer
        out.append([(n.host_id, n.avg_rtt_ns)
                    for n in topo.Neighbors(tp.NeighborsRequest(host_id="host-0", limit=4)).neighbors])
        stats = topo.Stats(tp.StatsRequest())
        out.append((stats.hosts, stats.edges))
        tr = glue.ServiceClient(ch, glue.TRAINER_SERVICE)
        out.append(tr.Capabilities(trp.CapabilitiesRequest()).SerializeToString())
        tr.Train(iter([trp.TrainRequest(ip="1.2.3.4", hostname="h", train_mlp=trp.TrainMlpRequest(dataset=b"x"))]))
        diag = glue.ServiceClient(ch, glue.DIAGNOSE_SERVICE).Diagnose(dp.DiagnoseRequest(include_stacks=False))
        out.append(("diagnose", "rings" in json.loads(diag.snapshot_json)))
        return out
    finally:
        ch.close()


@pytest.mark.parametrize("server,client", [("port", "ref"), ("ref", "port"), ("port", "port")])
def test_servers_answer_clients_of_the_other_package(server, client, tmp_path):
    impls, engine = _impls(server, tmp_path)
    engine.enqueue("host-0", "host-1", 4_000_000, created_at=time.time())
    engine.enqueue("host-1", "host-2", 6_000_000, created_at=time.time())
    engine.flush()
    srv, port = GLUES[server].serve(impls)
    try:
        got = _conversation(GLUES[client], f"127.0.0.1:{port}")
    finally:
        srv.stop(0)
    # the same exchange within one package is the reference for the pair
    impls2, engine2 = _impls("ref", tmp_path)
    engine2.enqueue("host-0", "host-1", 4_000_000, created_at=time.time())
    engine2.enqueue("host-1", "host-2", 6_000_000, created_at=time.time())
    engine2.flush()
    srv2, port2 = j_glue.serve(impls2)
    try:
        want = _conversation(j_glue, f"127.0.0.1:{port2}")
    finally:
        srv2.stop(0)
    assert got == want
    trainer = impls[GLUES[server].TRAINER_SERVICE]
    assert [r.train_mlp.dataset for r in trainer.requests] == [b"x"]


def test_port_manager_client_speaks_to_the_reference_manager(tmp_path):
    db = Database(tmp_path / "manager.db")
    registry = ModelRegistry(db, FSObjectStorage(tmp_path / "objects"))
    srv, port = j_glue.serve({j_glue.MANAGER_SERVICE: ManagerService(db, registry)})
    ch = t_glue.dial(f"127.0.0.1:{port}")
    try:
        adapter = TManagerAdapter(ch)
        params = {"layers": [{"w": torch.ones(19, 2).numpy(), "b": torch.zeros(2).numpy()}]}
        adapter.create_model("mlp-x", "mlp", "10.0.0.9", "sched", params, {"mse": 0.5})
        adapter.keepalive("scheduler", "sched", "10.0.0.9", cluster_id=1)
        client = t_glue.ServiceClient(ch, t_glue.MANAGER_SERVICE)
        models = client.ListModels(mp.ListModelsRequest(scheduler_cluster_id=0)).models
        assert [(m.model_id, m.type, m.evaluation.mse) for m in models] == [("mlp-x", "mlp", 0.5)]
        w = client.GetModelWeights(mp.GetModelRequest(model_id="mlp-x", version=models[0].version))
        from dragonfly2_tpu.trainer.serving import deserialize_params_auto

        tree = deserialize_params_auto(w.weights)
        assert tree["layers"][0]["w"].shape == (19, 2)
    finally:
        ch.close()
        srv.stop(0)
        db.close()


# -- consistent hashing -------------------------------------------------------


@pytest.mark.parametrize("members", [3, 7, 16])
def test_consistent_hash_ring_matches(members):
    addrs = [f"10.0.{i}.1:8002" for i in range(members)]
    rings = [g.ConsistentHashRing(addrs) for g in (t_glue, j_glue)]
    keys = [f"task-{k:04x}" for k in range(500)]
    assert [rings[0].pick(k) for k in keys] == [rings[1].pick(k) for k in keys]
    assert [rings[0].successors(k, 3) for k in keys[:50]] == [rings[1].successors(k, 3) for k in keys[:50]]
    for ring in rings:
        ring.remove(addrs[1])
        ring.add("10.9.9.9:8002")
    assert [rings[0].pick(k) for k in keys] == [rings[1].pick(k) for k in keys]
    assert rings[0].version == rings[1].version


# -- wrap_call ----------------------------------------------------------------


class _Err(grpc.RpcError):
    def __init__(self, code):
        self._code = code

    def code(self):
        return self._code

    def details(self):
        return self._code.name


def _scripted(outcomes, delays=None):
    """An inner call that answers from ``outcomes`` in order: a status
    code raises, anything else is returned; ``delays`` sleeps first."""
    calls = []

    def inner(request, timeout=None, metadata=None, **kw):
        n = len(calls)
        calls.append((request, timeout))
        if delays:
            time.sleep(delays[min(n, len(delays) - 1)])
        o = outcomes[min(n, len(outcomes) - 1)]
        if isinstance(o, grpc.StatusCode):
            raise _Err(o)
        return o

    return inner, calls


SVC = "dragonfly2_tpu.manager.Manager"
U, D = grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED
CASES = {
    "retry_then_ok": ([U, U, "ok"], {}, 1),
    "retries_exhausted": ([U, U, U, U], {}, 1),
    "not_retryable": ([grpc.StatusCode.INVALID_ARGUMENT, "ok"], {}, 1),
    "breaker_opens": ([U], {"max_attempts": 1, "breaker_failures": 3, "breaker_open_s": 60.0}, 6),
    "budget_drains": ([U], {"retry_budget_cap": 2.0, "breaker_failures": 100}, 4),
}


def _drive(res_mod, outcomes, policy, rounds, target):
    saved = res_mod.policy_for(SVC)
    res_mod.tune_policy(SVC, backoff_base_s=0.001, backoff_cap_s=0.002, **policy)
    try:
        inner, calls = _scripted(outcomes)
        call = res_mod.wrap_call(SVC, "GetModel", "unary_unary", target, inner)
        results = []
        random.seed(0)
        for _ in range(rounds):
            try:
                results.append(call("req"))
            except grpc.RpcError as e:
                results.append(e.code().name)
        return results, len(calls)
    finally:
        res_mod.set_policy(SVC, saved)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrap_call_matches_the_reference(case):
    outcomes, policy, rounds = CASES[case]
    target = f"target-{case}-{time.time_ns()}"
    got = _drive(t_res, outcomes, policy, rounds, target + "-port")
    want = _drive(j_res, outcomes, policy, rounds, target + "-ref")
    assert got == want


def test_deadline_and_hedge_match():
    out = {}
    for name, mod in (("port", t_res), ("ref", j_res)):
        saved = mod.policy_for(SVC)
        mod.tune_policy(SVC, hedge_delay_s=0.02, max_attempts=1)
        try:
            # the first attempt stalls, the hedge answers; then an exhausted
            # inherited budget is shed before the wire
            inner, calls = _scripted(["slow", "fast"], delays=[0.3, 0.0])
            call = mod.wrap_call(SVC, "GetModel", "unary_unary", f"hedge-{name}-{time.time_ns()}", inner)
            first = call("req")
            with mod.deadline_scope(-1.0):
                try:
                    call("req")
                    shed = None
                except grpc.RpcError as e:
                    shed = e.code().name
            out[name] = (first, len(calls), shed, isinstance(calls[0][1], float))
        finally:
            mod.set_policy(SVC, saved)
    assert out["port"] == out["ref"] and out["ref"][0] == "fast" and out["ref"][2] == "DEADLINE_EXCEEDED"


def test_resilience_error_is_a_wire_error():
    err = t_res.ResilienceError(grpc.StatusCode.UNAVAILABLE, "open")
    assert isinstance(err, grpc.RpcError) and err.code() is grpc.StatusCode.UNAVAILABLE
    assert err.details() == "open"


# -- an injected fault at the announcer's upload ------------------------------


def _announce_round(glue, announcer_cls, storage_cls, synth, faults, tmp_path, spec):
    trainer = _Trainer()
    srv, port = glue.serve({glue.TRAINER_SERVICE: trainer})
    ch = glue.dial(f"127.0.0.1:{port}")
    storage = storage_cls(tmp_path, buffer_size=8)
    for rec in synth.make_download_records(16, seed=2):
        storage.create_download(rec)
    storage.flush()
    faults.configure(spec)
    try:
        ann = announcer_cls(storage, ip="10.0.0.1", hostname="s", trainer_channel=ch, cluster_id="1")
        try:
            ok = ann.train_once()
            raised = None
        except grpc.RpcError as e:
            ok, raised = None, e.code().name
        arms = sorted({r.WhichOneof("request") for r in trainer.requests})
        pending = sorted(p.name for p in (tmp_path / "upload-pending").rglob("*") if p.is_file())
        return ok, raised, ann._train_format, arms, pending
    finally:
        faults.clear()
        ch.close()
        srv.stop(0)


@pytest.mark.parametrize("spec", [
    # the Capabilities probe fails: both fall back to the CSV payload
    "rpc.unary_send=error:UNAVAILABLE#0+1",
    # the Train stream fails: both raise a wire error, the round stays pending
    "rpc.unary_send=error:UNAVAILABLE#1+4",
])
def test_injected_upload_fault_degrades_alike(spec, tmp_path):
    got = _announce_round(t_glue, TAnnouncer, TStorage, t_synth, t_faults, tmp_path / "port", spec)
    want = _announce_round(j_glue, JAnnouncer, JStorage, j_synth, j_faults, tmp_path / "ref", spec)
    assert got == want
    assert isinstance(t_faults.InjectedFault("rpc.x", "error"), grpc.RpcError)


def test_port_server_takes_the_announcers_large_chunks(tmp_path):
    # the announcer ships dataset files in chunks of up to 128 MiB; the
    # port's server takes what its channels send (the reference's keeps
    # gRPC's 4 MiB receive default and refuses such a chunk)
    trainer = _Trainer()
    srv, port = t_glue.serve({t_glue.TRAINER_SERVICE: trainer})
    ch = t_glue.dial(f"127.0.0.1:{port}")
    try:
        blob = bytes(range(256)) * (6 << 12)  # 6 MiB
        t_glue.ServiceClient(ch, t_glue.TRAINER_SERVICE).Train(
            iter([trp.TrainRequest(ip="1.2.3.4", hostname="h", train_mlp_binary=trp.TrainMlpBinaryRequest(dataset=blob))]))
        assert trainer.requests[0].train_mlp_binary.dataset == blob
    finally:
        ch.close()
        srv.stop(0)



def test_reference_server_refuses_the_announcers_large_chunks():
    # the same 6 MiB chunk through the reference's own glue: its server
    # keeps gRPC's 4 MiB receive default, answers RESOURCE_EXHAUSTED and
    # its trainer never sees the request — the port departs from this on
    # purpose (the test above)
    trainer = _Trainer()
    srv, port = j_glue.serve({j_glue.TRAINER_SERVICE: trainer})
    ch = j_glue.dial(f"127.0.0.1:{port}")
    try:
        blob = bytes(range(256)) * (6 << 12)  # 6 MiB
        with pytest.raises(grpc.RpcError) as err:
            j_glue.ServiceClient(ch, j_glue.TRAINER_SERVICE).Train(
                iter([trp.TrainRequest(ip="1.2.3.4", hostname="h", train_mlp_binary=trp.TrainMlpBinaryRequest(dataset=blob))]))
        assert err.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert trainer.requests == []
    finally:
        ch.close()
        srv.stop(0)
