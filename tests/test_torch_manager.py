"""The port's manager (``dragonfly2_torch.manager``) against the reference's
(``dragonfly2_tpu.manager``) on the same inputs.

- Registry and service: one scripted RPC sequence — schedulers, keepalives,
  seed peers, cluster config, models (upload, list, get, weights, the
  activation gate, deactivation, the version-0 alias), jobs (create,
  lease, result, a lost lease, sync_peers) and certificate issuance
  disabled — goes to both ``ManagerService``s, over a plain and over a
  cached database. Every response must be equal byte for byte once its
  time fields are zeroed, every abort must carry the same code, the
  stored weights blobs must be the same bytes and the tables the same
  rows.
- Keepalive expiry and the read-through cache (TTL, write invalidation by
  table, generation-stamped stores, transactions) follow
  ``tests/test_manager.py`` and ``tests/test_manager_cache.py`` case for
  case, each run on both packages with the same outcome.
- The searcher picks the same cluster for every peer of a seeded set.
- The server: ``ManagerServerConfig`` keeps the reference's keys and
  defaults; ``rest_port`` and ``kv_port`` raise ``NotImplementedError``
  naming their ROADMAP items, and so does ``ManagerService(fleet_kv=...)``;
  ``python -m dragonfly2_torch.manager`` starts, and a served manager
  answers gRPC, /metrics and /healthz with the SLO section."""

import dataclasses
import random
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from dragonfly2_torch.manager import cache as t_cache
from dragonfly2_torch.manager import database as t_database
from dragonfly2_torch.manager import models_registry as t_registry
from dragonfly2_torch.manager import objectstorage as t_objectstorage
from dragonfly2_torch.manager import searcher as t_searcher
from dragonfly2_torch.manager import server as t_server
from dragonfly2_torch.manager import service as t_service
from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.rpc import protos
from dragonfly2_tpu.manager import cache as j_cache
from dragonfly2_tpu.manager import database as j_database
from dragonfly2_tpu.manager import models_registry as j_registry
from dragonfly2_tpu.manager import objectstorage as j_objectstorage
from dragonfly2_tpu.manager import searcher as j_searcher
from dragonfly2_tpu.manager import server as j_server
from dragonfly2_tpu.manager import service as j_service

torch.set_num_threads(1)

mp = protos.load("manager_pb2")
REPO = Path(__file__).resolve().parents[1]

PORT = dict(database=t_database, cache=t_cache, registry=t_registry, storage=t_objectstorage,
            service=t_service)
REFERENCE = dict(database=j_database, cache=j_cache, registry=j_registry, storage=j_objectstorage,
                 service=j_service)


class Aborted(Exception):
    def __init__(self, code, details):
        super().__init__(f"{code}: {details}")
        self.code = code


class Ctx:
    """A servicer context whose ``abort`` raises, as gRPC's does."""

    def abort(self, code, details):
        raise Aborted(code, details)


def _stack(pkg, root: Path, ttl: float = 0.0):
    root.mkdir(parents=True, exist_ok=True)
    db = pkg["database"].Database(root / "manager.db")
    if ttl > 0:
        db = pkg["cache"].CachedDatabase(db, ttl=ttl)
    storage = pkg["storage"].FSObjectStorage(root / "objects")
    registry = pkg["registry"].ModelRegistry(db, storage)
    return pkg["service"].ManagerService(db, registry), db, storage


def _zero_times(msg):
    """The message with every ``*_at_ns`` field zeroed, at any depth."""
    for field, value in msg.ListFields():
        if field.name.endswith("_at_ns"):
            msg.ClearField(field.name)
        elif field.type == field.TYPE_MESSAGE:
            for sub in ([value] if hasattr(value, "ListFields") else value):
                _zero_times(sub)
    return msg


def _call(svc, name, request):
    """→ ("ok", the response's bytes without its time fields) or ("abort", code)."""
    try:
        resp = getattr(svc, name)(request, Ctx())
    except Aborted as e:
        return ("abort", e.code)
    return ("ok", _zero_times(resp).SerializeToString(deterministic=True))


def _ka(**kw):
    return iter([mp.KeepAliveRequest(**kw)])


def _sequence(worker="10.0.0.1_sched-1"):
    """The scripted conversation: (rpc, request factory) pairs, with
    ``worker`` ("<ip>_<hostname>") the scheduler that leases the jobs."""
    ip, host = worker.split("_")
    ev = mp.ModelEvaluation(precision=0.5, recall=0.25, f1=0.125, mse=0.0625, mae=0.03125)
    sync_result = ('{"hosts": [{"id": "h1", "hostname": "a", "ip": "10.0.0.5", "type": "super",'
                   ' "peer_count": 3, "upload_count": 2}, {"id": "h2", "hostname": "b"}, "junk"]}')
    return [
        ("UpdateScheduler", lambda: mp.UpdateSchedulerRequest(hostname=host, ip=ip, port=8002, idc="idc-a",
                                                              location="as|cn")),
        ("UpdateScheduler", lambda: mp.UpdateSchedulerRequest(hostname="sched-2", ip="10.0.0.2", port=8003)),
        ("GetScheduler", lambda: mp.GetSchedulerRequest(hostname=host, ip=ip)),
        ("GetScheduler", lambda: mp.GetSchedulerRequest(hostname="nobody", ip="10.9.9.9")),
        ("ListSchedulers", lambda: mp.ListSchedulersRequest()),
        ("KeepAlive", lambda: _ka(source_type="scheduler", hostname=host, ip=ip, cluster_id=1)),
        ("KeepAlive", lambda: _ka(source_type="seed_peer", hostname="seed-1", ip="10.0.0.9")),
        ("UpdateSeedPeer", lambda: mp.UpdateSeedPeerRequest(hostname="seed-1", ip="10.0.0.9", port=8002,
                                                            download_port=8001, seed_peer_cluster_id=1)),
        ("UpdateSeedPeer", lambda: mp.UpdateSeedPeerRequest(hostname="seed-1", ip="10.0.0.9", port=8004,
                                                            download_port=8005, type="strong", idc="x")),
        ("GetSchedulerClusterConfig", lambda: mp.GetSchedulerClusterConfigRequest()),
        ("GetSchedulerClusterConfig", lambda: mp.GetSchedulerClusterConfigRequest(scheduler_cluster_id=9)),
        ("CreateModel", lambda: mp.CreateModelRequest(model_id="m1", type="mlp", ip=ip, hostname=host,
                                                      weights=b"blob-1", evaluation=ev)),
        ("CreateModel", lambda: mp.CreateModelRequest(model_id="m1", type="mlp", weights=b"blob-2")),
        ("CreateModel", lambda: mp.CreateModelRequest(model_id="g1", type="gnn", weights=bytes(range(256)),
                                                      scheduler_cluster_id=1)),
        ("ListModels", lambda: mp.ListModelsRequest()),
        ("GetModel", lambda: mp.GetModelRequest(model_id="m1", version=0)),  # none active yet
        ("GetModel", lambda: mp.GetModelRequest(model_id="m1", version=2)),
        ("GetModelWeights", lambda: mp.GetModelRequest(model_id="m1", version=0)),
        ("GetModelWeights", lambda: mp.GetModelRequest(model_id="m1", version=1)),
        ("UpdateModel", lambda: mp.UpdateModelRequest(model_id="m1", version=1, state="active")),
        ("GetModelWeights", lambda: mp.GetModelRequest(model_id="m1", version=0)),
        ("UpdateModel", lambda: mp.UpdateModelRequest(model_id="m1", version=2, state="active")),
        ("ListModels", lambda: mp.ListModelsRequest(scheduler_cluster_id=1)),
        ("UpdateModel", lambda: mp.UpdateModelRequest(model_id="m1", version=0, state="active")),  # the alias
        ("GetModel", lambda: mp.GetModelRequest(model_id="m1", version=0)),
        ("UpdateModel", lambda: mp.UpdateModelRequest(model_id="m1", version=2, state="")),
        ("UpdateModel", lambda: mp.UpdateModelRequest(model_id="m1", version=0, state="inactive")),
        ("UpdateModel", lambda: mp.UpdateModelRequest(model_id="m1", version=0, state="inactive")),
        ("UpdateModel", lambda: mp.UpdateModelRequest(model_id="nope", version=1, state="active")),
        ("UpdateModel", lambda: mp.UpdateModelRequest(model_id="nope", version=1, state="")),
        ("ListModels", lambda: mp.ListModelsRequest()),
        ("CreateJob", lambda: mp.CreateJobRequest(type="bogus")),
        ("CreateJob", lambda: mp.CreateJobRequest(type="preheat", args_json='{"url": "http://o/a"}')),
        ("CreateJob", lambda: mp.CreateJobRequest(type="sync_peers")),
        ("CreateJob", lambda: mp.CreateJobRequest(type="recommend_seeds", scheduler_cluster_id=5)),
        ("GetJob", lambda: mp.GetJobRequest(id=1)),
        ("GetJob", lambda: mp.GetJobRequest(id=99)),
        ("ListPendingJobs", lambda: mp.ListPendingJobsRequest(hostname=host, ip=ip)),
        ("ListPendingJobs", lambda: mp.ListPendingJobsRequest(hostname=host, ip=ip)),  # nothing left
        ("UpdateJobResult", lambda: mp.UpdateJobResultRequest(id=1, state="running", hostname=host, ip=ip)),
        ("UpdateJobResult", lambda: mp.UpdateJobResultRequest(id=1, state="succeeded", result_json='{"n": 1}',
                                                              hostname="thief", ip=ip)),
        ("UpdateJobResult", lambda: mp.UpdateJobResultRequest(id=1, state="succeeded", result_json='{"n": 1}',
                                                              hostname=host, ip=ip)),
        ("UpdateJobResult", lambda: mp.UpdateJobResultRequest(id=2, state="succeeded", result_json=sync_result,
                                                              hostname=host, ip=ip)),
        ("UpdateJobResult", lambda: mp.UpdateJobResultRequest(id=77, state="failed", hostname=host, ip=ip)),
        ("ListPendingJobs", lambda: mp.ListPendingJobsRequest(hostname=host, ip=ip, scheduler_cluster_id=5)),
        ("IssueCertificate", lambda: mp.CertificateRequest(csr_pem="x")),
    ]


TABLES = {
    "schedulers": "hostname, ip, port, idc, location, state, scheduler_cluster_id",
    "seed_peers": "hostname, ip, port, download_port, type, idc, location, state, seed_peer_cluster_id",
    "models": "model_id, type, version, state, evaluation, object_key, ip, hostname, scheduler_cluster_id",
    "jobs": "type, state, args, result, scheduler_cluster_id, leased_by",
    "peers": "host_id, hostname, ip, type, state, peer_count, upload_count, scheduler_cluster_id",
    "scheduler_clusters": "name, config, client_config, scopes, is_default",
}


@pytest.mark.parametrize("ttl", [0.0, 30.0], ids=["plain", "cached"])
def test_the_rpc_sequence_answers_alike(tmp_path, ttl):
    got = {}
    for name, pkg in (("torch", PORT), ("jax", REFERENCE)):
        svc, db, storage = _stack(pkg, tmp_path / name, ttl=ttl)
        answers = []
        for rpc, make in _sequence():
            answers.append((rpc, _call(svc, rpc, make())))
        tables = {t: db.query(f"SELECT {cols} FROM {t} ORDER BY id") for t, cols in TABLES.items()}
        blobs = {k: storage.get_object("models", k) for k in storage.list_objects("models")}
        got[name] = (answers, tables, blobs)
        db.close()
    (t_answers, t_tables, t_blobs), (j_answers, j_tables, j_blobs) = got["torch"], got["jax"]
    for n, (a, b) in enumerate(zip(t_answers, j_answers)):
        assert a == b, f"step {n} {a[0]}: {a[1]} != {b[1]}"
    assert len(t_answers) == len(j_answers)
    aborted = {rpc: a[1] for rpc, a in t_answers if a[0] == "abort"}
    # the sequence reaches every abort it scripts
    assert set(aborted) == {"GetScheduler", "GetSchedulerClusterConfig", "GetModel", "GetModelWeights",
                            "UpdateModel", "CreateJob", "GetJob", "UpdateJobResult", "IssueCertificate"}
    assert t_tables == j_tables
    assert [r["host_id"] for r in t_tables["peers"]] == ["h1", "h2"]  # sync_peers materialized
    assert [(r["model_id"], r["version"], r["state"]) for r in t_tables["models"]] == [
        ("m1", 1, "inactive"), ("m1", 2, "inactive"), ("g1", 1, "inactive")]
    assert t_blobs == j_blobs and t_blobs["m1/2/model.npz"] == b"blob-2" and len(t_blobs) == 3


def test_the_gate_over_grpc_matches_the_reference(tmp_path):
    """Over real gRPC: uploads land inactive, version 0 finds nothing until
    an activation, activating another version flips the first off, and
    the abort codes a client sees are the reference's."""
    seen = {}
    for name, pkg, glue in (("torch", PORT, t_glue), ("jax", REFERENCE, None)):
        svc, db, _ = _stack(pkg, tmp_path / name)
        if glue is None:
            from dragonfly2_tpu.rpc import glue
        server, port = glue.serve({glue.MANAGER_SERVICE: svc})
        channel = t_glue.dial(f"127.0.0.1:{port}")
        client = t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE)
        log = []
        try:
            for i in range(3):
                m = client.CreateModel(mp.CreateModelRequest(model_id="m1", type="mlp", weights=b"w%d" % i))
                log.append((m.version, m.state))
            try:
                client.GetModel(mp.GetModelRequest(model_id="m1", version=0))
            except Exception as e:
                log.append(e.code().name)
            for v in (2, 3):
                log.append(client.UpdateModel(mp.UpdateModelRequest(model_id="m1", version=v,
                                                                     state="active")).state)
            lst = client.ListModels(mp.ListModelsRequest())
            log.append(sorted((m.version, m.state) for m in lst.models))
            log.append(client.GetModelWeights(mp.GetModelRequest(model_id="m1")).weights)
        finally:
            channel.close()
            server.stop(0)
            db.close()
        seen[name] = log
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][:4] == [(1, "inactive"), (2, "inactive"), (3, "inactive"), "NOT_FOUND"]
    assert seen["torch"][-2:] == [[(1, "inactive"), (2, "inactive"), (3, "active")], b"w2"]


# ---------------------------------------------------------------------------
# keepalive expiry and the read-through cache (tests/test_manager.py,
# tests/test_manager_cache.py), each on both packages
# ---------------------------------------------------------------------------


def _both(fn, tmp_path):
    """``fn(pkg, root)`` on the port and the reference → the port's result,
    which must equal the reference's."""
    for name in ("torch", "jax"):
        (tmp_path / name).mkdir()
    t = fn(PORT, tmp_path / "torch")
    j = fn(REFERENCE, tmp_path / "jax")
    assert t == j
    return t


def test_keepalive_expiry(tmp_path):
    def run(pkg, root):
        svc, db, _ = _stack(pkg, root)
        svc.UpdateScheduler(mp.UpdateSchedulerRequest(hostname="sched-1", ip="10.0.0.1", port=8002), Ctx())
        svc.UpdateSeedPeer(mp.UpdateSeedPeerRequest(hostname="seed-1", ip="10.0.0.9", port=1), Ctx())
        listed = [len(svc.ListSchedulers(mp.ListSchedulersRequest(), Ctx()).schedulers)]
        # silence: backdate past the timeout
        db.execute("UPDATE schedulers SET last_keepalive = ?", (time.time() - 3600,))
        db.execute("UPDATE seed_peers SET last_keepalive = ?", (time.time() - 3600,))
        listed.append(len(svc.ListSchedulers(mp.ListSchedulersRequest(), Ctx()).schedulers))
        states = [r["state"] for r in db.query("SELECT state FROM seed_peers")]
        # a keepalive of another cluster revives nothing; its own revives
        svc.KeepAlive(_ka(source_type="scheduler", hostname="sched-1", ip="10.0.0.1", cluster_id=7), Ctx())
        listed.append(len(svc.ListSchedulers(mp.ListSchedulersRequest(), Ctx()).schedulers))
        svc.KeepAlive(_ka(source_type="scheduler", hostname="sched-1", ip="10.0.0.1"), Ctx())
        listed.append(len(svc.ListSchedulers(mp.ListSchedulersRequest(), Ctx()).schedulers))
        db.close()
        return listed, states

    assert _both(run, tmp_path) == ([1, 0, 0, 1], ["inactive"])


def test_cache_tables_of():
    for sql in ("SELECT * FROM schedulers WHERE id = ?", "INSERT INTO jobs (a) VALUES (?)",
                "UPDATE models SET state = ?", "DELETE FROM seed_peers WHERE id = ?",
                "SELECT * FROM schedulers JOIN scheduler_clusters ON 1"):
        assert t_cache.tables_of(sql) == j_cache.tables_of(sql)
    assert t_cache.tables_of("SELECT * FROM schedulers JOIN scheduler_clusters ON 1") == {
        "schedulers", "scheduler_clusters"}


def test_cache_hits_invalidation_and_copies(tmp_path):
    def run(pkg, root):
        cdb = pkg["cache"].CachedDatabase(pkg["database"].Database(root / "m.db"), ttl=30.0)
        trace = []
        cdb.ensure_default_cluster()
        first = cdb.query("SELECT * FROM scheduler_clusters")
        cdb.query("SELECT * FROM scheduler_clusters")
        trace.append((cdb.hits, cdb.misses))
        cdb.query("SELECT * FROM jobs")
        now = time.time()
        cdb.execute("INSERT INTO jobs (type, created_at, updated_at) VALUES ('preheat', ?, ?)", (now, now))
        trace.append(len(cdb.query("SELECT * FROM jobs")))  # invalidated → the fresh row
        cdb.query("SELECT * FROM scheduler_clusters")  # untouched → still cached
        trace.append((cdb.hits, cdb.misses))
        first[0]["name"] = "mutated"  # a caller's edit never reaches the cache
        trace.append(cdb.query("SELECT * FROM scheduler_clusters")[0]["name"])
        # a 0-row UPDATE keeps the cache warm
        cdb.query("SELECT * FROM schedulers WHERE state = 'active'")
        cdb.execute("UPDATE schedulers SET state = 'inactive' WHERE last_keepalive < -1")
        cdb.query("SELECT * FROM schedulers WHERE state = 'active'")
        trace.append((cdb.hits, cdb.misses))
        with cdb.transaction():  # leasing reads never see the cache
            m0 = cdb.misses
            cdb.query("SELECT * FROM jobs")
            trace.append(cdb.misses - m0)
        cdb.invalidate("jobs")
        cdb.query("SELECT * FROM jobs")
        trace.append((cdb.hits, cdb.misses))
        cdb.close()
        return trace

    trace = _both(run, tmp_path)
    assert trace[0] == (1, 1) and trace[1] == 1 and trace[3] == "default" and trace[5] == 1


def test_cache_ttl_expiry(tmp_path):
    def run(pkg, root):
        cdb = pkg["cache"].CachedDatabase(pkg["database"].Database(root / "t.db"), ttl=0.05)
        cdb.ensure_default_cluster()
        cdb.query("SELECT * FROM scheduler_clusters")
        m0 = cdb.misses
        cdb.query("SELECT * FROM scheduler_clusters")
        warm = cdb.misses - m0
        time.sleep(0.08)
        cdb.query("SELECT * FROM scheduler_clusters")
        cdb.close()
        return warm, cdb.misses - m0

    assert _both(run, tmp_path) == (0, 1)


def test_cache_discards_a_read_that_raced_a_write(tmp_path):
    """Generation stamps: rows read before a write to their table landed are
    never stored after the write's invalidation."""

    def run(pkg, root):
        db = pkg["database"].Database(root / "m.db")
        cdb = pkg["cache"].CachedDatabase(db, ttl=30.0)
        cdb.ensure_default_cluster()
        real = db.query

        def racing(sql, params=()):
            rows = real(sql, params)
            now = time.time()
            cdb.execute("INSERT INTO jobs (type, created_at, updated_at) VALUES ('preheat', ?, ?)", (now, now))
            return rows

        db.query = racing
        stale = len(cdb.query("SELECT * FROM jobs"))
        db.query = real
        fresh = len(cdb.query("SELECT * FROM jobs"))
        cdb.close()
        return stale, fresh

    assert _both(run, tmp_path) == (0, 1)


def test_list_schedulers_polls_hit_the_cache(tmp_path):
    def run(pkg, root):
        cdb = pkg["cache"].CachedDatabase(pkg["database"].Database(root / "m.db"), ttl=30.0)
        svc = pkg["service"].ManagerService(
            cdb, pkg["registry"].ModelRegistry(cdb, pkg["storage"].FSObjectStorage(root / "o")))
        svc.UpdateScheduler(mp.UpdateSchedulerRequest(hostname="s1", ip="10.0.0.1", port=8002), Ctx())
        m0 = cdb.misses
        for _ in range(20):
            assert [s.hostname for s in svc.ListSchedulers(mp.ListSchedulersRequest(), Ctx()).schedulers] == ["s1"]
        polls = cdb.misses - m0
        cdb.execute("DELETE FROM schedulers WHERE hostname = 's1'")
        gone = len(svc.ListSchedulers(mp.ListSchedulersRequest(), Ctx()).schedulers)
        cdb.close()
        return polls, gone

    polls, gone = _both(run, tmp_path)
    assert polls <= 2 and gone == 0


# ---------------------------------------------------------------------------
# searcher
# ---------------------------------------------------------------------------


def _seeded_clusters(mod, rng):
    idcs = ["idc-a", "idc-b", "idc-c", "idc-d"]
    locs = ["as|cn|sh", "as|cn|bj", "eu|de|fra", "na|us|sfo", "as|jp"]
    nets = ["10.0.0.0/8", "172.16.0.0/12", "192.168.0.0/16", "10.1.0.0/16", "bogus/99"]
    out = [mod.Cluster(1, "default", mod.ClusterScope(), is_default=True)]
    for i in range(2, 9):
        out.append(mod.Cluster(i, f"c{i}", mod.ClusterScope(
            idc="|".join(rng.sample(idcs, rng.randint(0, 2))),
            location="|".join(rng.choice(locs).split("|")[: rng.randint(0, 3)]),
            cidrs=rng.sample(nets, rng.randint(0, 2)),
        ), is_default=rng.random() < 0.2))
    return out


def _seeded_peers(mod, rng, n=300):
    ips = [f"10.{rng.randint(0, 3)}.{rng.randint(0, 255)}.{rng.randint(1, 254)}" for _ in range(n // 3)]
    ips += [f"172.{rng.randint(14, 33)}.0.{rng.randint(1, 254)}" for _ in range(n // 3)]
    ips += ["192.168.1.1", "8.8.8.8", "bogus", ""] * (n // 12)
    return [mod.PeerInfo(ip=ip, idc=rng.choice(["", "idc-a", "IDC-B", "idc-z"]),
                         location=rng.choice(["", "as|cn|sh|pd", "eu|de", "as|jp|tyo", "NA|US"]))
            for ip in ips]


def test_searcher_picks_the_same_cluster_for_seeded_peers():
    picks = {}
    for name, mod in (("torch", t_searcher), ("jax", j_searcher)):
        rng = random.Random(15)
        clusters, peers = _seeded_clusters(mod, rng), _seeded_peers(mod, rng)
        s = mod.Searcher()
        picks[name] = [(s.find_matching_cluster(clusters, p).id, round(s.score(s.find_matching_cluster(
            clusters, p), p), 12)) for p in peers]
    assert picks["torch"] == picks["jax"]
    assert len({c for c, _ in picks["torch"]}) >= 4  # the set exercises several clusters
    assert t_searcher.Searcher().find_matching_cluster([], t_searcher.PeerInfo()) is None


def test_list_schedulers_is_scoped_by_the_searcher(tmp_path):
    def run(pkg, root):
        svc, db, _ = _stack(pkg, root)
        now = time.time()
        db.execute("INSERT INTO scheduler_clusters (name, scopes, created_at, updated_at)"
                   " VALUES ('cluster-b', '{\"idc\": \"idc-b\"}', ?, ?)", (now, now))
        cb = db.query_one("SELECT id FROM scheduler_clusters WHERE name='cluster-b'")["id"]
        for host, cluster in (("s-default", svc.default_cluster_id), ("s-b", cb)):
            svc.UpdateScheduler(mp.UpdateSchedulerRequest(hostname=host, ip="10.0.0.9", port=8002,
                                                          scheduler_cluster_id=cluster), Ctx())
        got = [[s.hostname for s in svc.ListSchedulers(req, Ctx()).schedulers] for req in (
            mp.ListSchedulersRequest(ip="10.1.1.1", idc="idc-b"), mp.ListSchedulersRequest(),
            mp.ListSchedulersRequest(ip="10.1.1.1"))]
        db.close()
        return got

    assert _both(run, tmp_path) == [["s-b"], ["s-default", "s-b"], ["s-default"]]


def test_a_plugin_searcher_takes_the_seam(monkeypatch):
    from dragonfly2_torch.utils import dfplugin

    class Last(t_searcher.Searcher):
        pass

    monkeypatch.setattr(dfplugin.registry, "searchers", [])
    assert type(t_searcher.new_searcher()) is t_searcher.Searcher
    dfplugin.registry.register_searcher(Last)
    assert type(t_searcher.new_searcher()) is Last


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def test_server_config_keeps_the_reference_keys_and_defaults():
    def fields(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING else f.default_factory())
                for f in dataclasses.fields(cls)}

    assert fields(t_server.ManagerServerConfig) == fields(j_server.ManagerServerConfig)
    assert t_server.ManagerServerConfig().issue_certs is True


@pytest.mark.parametrize("option,item", [("rest_port", "A-D3b"), ("kv_port", "5h")])
def test_out_of_slice_manager_options_raise(tmp_path, option, item):
    cfg = t_server.ManagerServerConfig(data_dir=str(tmp_path / "m"), issue_certs=False, **{option: 0})
    with pytest.raises(NotImplementedError, match=rf"{option} -1|ROADMAP queue A item {item}") as e:
        t_server.ManagerServer(cfg)
    assert f"item {item}" in str(e.value)
    assert not (tmp_path / "m").exists()  # raised before anything was made


def test_the_fleet_view_raises(tmp_path):
    db = t_database.Database(tmp_path / "m.db")
    registry = t_registry.ModelRegistry(db, t_objectstorage.FSObjectStorage(tmp_path / "o"))
    with pytest.raises(NotImplementedError, match="5h"):
        t_service.ManagerService(db, registry, fleet_kv=object())
    db.close()


def test_a_served_manager_answers_grpc_metrics_and_healthz(tmp_path):
    srv = t_server.ManagerServer(t_server.ManagerServerConfig(
        data_dir=str(tmp_path / "m"), metrics_port=0, issue_certs=False))
    addr = srv.serve()
    try:
        assert isinstance(srv.db, t_cache.CachedDatabase) and srv.service.ca is None
        assert (tmp_path / "m" / "manager.db").exists() and (tmp_path / "m" / "objects" / "models").is_dir()
        channel = t_glue.dial(addr)
        client = t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE)
        s = client.UpdateScheduler(mp.UpdateSchedulerRequest(hostname="s", ip="127.0.0.1", port=1))
        assert s.state == "active" and s.scheduler_cluster_id == 1
        with pytest.raises(Exception) as e:
            client.IssueCertificate(mp.CertificateRequest(csr_pem="x"))
        assert e.value.code().name == "UNIMPLEMENTED"
        channel.close()
        with urllib.request.urlopen(f"http://{srv.metrics_addr}/healthz", timeout=10) as r:
            import json

            body = json.loads(r.read())
        assert body["services"] == {"manager": "ok"} and "schedule_p99" in body["slo"]["slos"]
        with urllib.request.urlopen(f"http://{srv.metrics_addr}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert 'dragonfly_build_info{service="manager",version="0.1.0"} 1.0' in text
        assert "# TYPE dragonfly_manager_model_created_total counter" in text
    finally:
        srv.stop()


def test_the_binary_starts(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_torch.manager", "--set", f"data_dir={tmp_path / 'm'}",
         "--set", "issue_certs=false"],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("READY manager "), line + proc.stderr.read()
        addr = line.split()[2]
        channel = t_glue.dial(addr)
        resp = t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE).ListSchedulers(mp.ListSchedulersRequest())
        assert list(resp.schedulers) == []
        channel.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
