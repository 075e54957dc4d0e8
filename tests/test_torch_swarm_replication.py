"""The port's swarm replication plane (``scheduler/swarm_replication.py``,
with the observatory's replication surface in ``scheduler/swarm.py`` and
``FSM.force``) against the reference's.

Every case of the reference's ``tests/test_swarm_replication.py`` runs on
both packages as a case of one parametrised test: a serialize →
replicate → adopt round trip under concurrent churn, the stale-epoch and
torn refusals, a missing replica, the flush's coalescing and backlog cap,
a task gone turning into a replica delete, and a ``WRONG_SHARD`` handoff
over real gRPC whose migrated replica lets the new owner recognize the
in-flight peer. Then the packages cross: one hook sequence gives equal
``export_task`` and ``export_payload`` on both sides; a replica written
by either replicator is adopted by the other's into an equal resource
model (hosts, task, peer FSM states, finished pieces, DAG edges); and the
stale-epoch and torn refusals leave equal receipts. Each package's own
``tools/dfswarm.diff_replicas`` and ``tools/stress`` announce-drill helpers
run against that package's schedulers, and every diff is also held
against the other package's on the same payloads."""

import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.scheduler import evaluator as t_evaluator
from dragonfly2_torch.scheduler import fleet as t_fleet
from dragonfly2_torch.scheduler import resource as t_res
from dragonfly2_torch.scheduler import scheduling as t_scheduling
from dragonfly2_torch.scheduler import service as t_service
from dragonfly2_torch.scheduler import storage as t_storage
from dragonfly2_torch.scheduler import swarm as t_swarm
from dragonfly2_torch.scheduler import swarm_replication as t_repl
from dragonfly2_torch.scheduler.resource import fsm as t_fsm
from dragonfly2_torch.tools import dfswarm as t_dfswarm
from dragonfly2_torch.tools import stress as t_stress
from dragonfly2_torch.utils import flight as t_flight
from dragonfly2_torch.utils import kvstore as t_kv

from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.scheduler import evaluator as j_evaluator
from dragonfly2_tpu.scheduler import fleet as j_fleet
from dragonfly2_tpu.scheduler import resource as j_res
from dragonfly2_tpu.scheduler import scheduling as j_scheduling
from dragonfly2_tpu.scheduler import service as j_service
from dragonfly2_tpu.scheduler import storage as j_storage
from dragonfly2_tpu.scheduler import swarm as j_swarm
from dragonfly2_tpu.scheduler import swarm_replication as j_repl
from dragonfly2_tpu.scheduler.resource import fsm as j_fsm
from dragonfly2_tpu.tools import dfswarm as j_dfswarm
from dragonfly2_tpu.tools import stress as j_stress
from dragonfly2_tpu.utils import flight as j_flight
from dragonfly2_tpu.utils import kvstore as j_kv

torch.set_num_threads(1)

PIECE = 1024

PKGS = {
    "torch": SimpleNamespace(
        name="torch", glue=t_glue, evaluator=t_evaluator, fleet=t_fleet, res=t_res, scheduling=t_scheduling,
        service=t_service, storage=t_storage, swarm=t_swarm, repl=t_repl, fsm=t_fsm, flight=t_flight, kv=t_kv,
        dfswarm=t_dfswarm, stress=t_stress,
    ),
    "jax": SimpleNamespace(
        name="jax", glue=j_glue, evaluator=j_evaluator, fleet=j_fleet, res=j_res, scheduling=j_scheduling,
        service=j_service, storage=j_storage, swarm=j_swarm, repl=j_repl, fsm=j_fsm, flight=j_flight, kv=j_kv,
        dfswarm=j_dfswarm, stress=j_stress,
    ),
}
both = pytest.mark.parametrize("pkg", sorted(PKGS))
crossed = pytest.mark.parametrize("writer,adopter", [("torch", "jax"), ("jax", "torch")])


@pytest.fixture(autouse=True)
def clean_swarm():
    for m in PKGS.values():
        m.swarm.reset()
    yield
    for m in PKGS.values():
        m.swarm.reset()


@pytest.fixture
def m(pkg):
    return PKGS[pkg]


def diff_replicas(m, old: dict, new: dict) -> dict:
    """``m``'s ``diff_replicas`` on the payloads, held equal to the other
    package's on the same payloads."""
    got = m.dfswarm.diff_replicas(old, new)
    assert got == t_dfswarm.diff_replicas(old, new) == j_dfswarm.diff_replicas(old, new)
    return got


def _adoptions(m, outcome: str) -> float:
    return sum(c.value for labels, c in m.repl.REPL_ADOPTIONS_TOTAL._snapshot() if labels == (outcome,))


def _adopt_events(m, kind: str, task_id: str) -> list:
    ring = m.flight.snapshot(["scheduler"]).get("scheduler", [])
    return [e for e in ring if e["type"] == f"scheduler.swarm_adopt_{kind}" and e.get("task_id") == task_id]


class _FakeFleet:
    """Epoch/floor stub: the replicator only reads the settled epoch on
    writes and the adoption floor on reads."""

    def __init__(self, epoch: int = 0, floor: int = 0):
        self._epoch = epoch
        self._floor = floor
        self.observers: list = []

    def epoch(self) -> int:
        return self._epoch

    def epoch_floor(self) -> int:
        return self._floor

    def owner_of(self, task_id: str):
        return None

    def add_observer(self, fn) -> None:
        self.observers.append(fn)


def _victim_swarm(m, resource, task_id: str, children=("c1", "c2", "c3")):
    """One seed + N in-flight children on distinct hosts, mirrored into
    both the resource model and the observatory — the state a victim
    scheduler would hold mid-download."""
    res, swarm = m.res, m.swarm
    task = res.Task(task_id, url=f"http://origin/{task_id}.bin", piece_length=PIECE)
    task.content_length = 8 * PIECE
    task.total_piece_count = 8
    task.fsm.force("Running")
    task, _ = resource.task_manager.load_or_store(task)

    def host(hid, port):
        h = res.Host(id=hid, type=res.HostType.NORMAL, hostname=hid, ip="127.0.0.1", port=port,
                     download_port=port + 1)
        return resource.host_manager.load_or_store(h)[0]

    seed = res.Peer("p-seed", task, host("h-seed", 4000))
    seed, _ = resource.peer_manager.load_or_store(seed)
    seed.fsm.force("Succeeded")
    for n in range(8):
        seed.finished_pieces.add(n)
    swarm.on_peer(task_id, "p-seed", seed=True, total_pieces=8)
    swarm.on_state(task_id, "p-seed", "Succeeded")
    swarm.on_piece(task_id, "p-seed", 8, 8)

    for i, pid in enumerate(children):
        child = res.Peer(pid, task, host(f"h-{pid}", 5000 + 10 * i))
        child, _ = resource.peer_manager.load_or_store(child)
        child.fsm.force("Running")
        for n in range(2):
            child.finished_pieces.add(n)
        swarm.on_peer(task_id, pid)
        swarm.on_primary_parent(task_id, pid, "p-seed")
        swarm.on_state(task_id, pid, "Running")
        swarm.on_piece(task_id, pid, 2, 8)
    return task


# ---------------------------------------------------------------------------
# the reference's cases, on both packages
# ---------------------------------------------------------------------------


@both
def test_replicate_adopt_round_trip_under_concurrent_churn(m):
    """Flushes race live swarm mutation; the final replica still adopts
    clean — peers, parent edges, and finished pieces intact, the
    conservation identity holding on the successor's ledger."""
    swarm = m.swarm
    kv = m.kv.KVStore()
    resource_a = m.res.Resource()
    tid = "rt-churn"
    _victim_swarm(m, resource_a, tid)
    repl_a = m.repl.SwarmReplicator(kv, "127.0.0.1:1", resource_a, config=m.repl.ReplicationConfig(interval_s=0.01))

    stop = threading.Event()
    errors: list = []

    def churn():
        try:
            c1 = resource_a.peer_manager.load("c1")
            for n in range(2, 8):
                c1.finished_pieces.add(n)
                swarm.on_piece(tid, "c1", len(c1.finished_pieces), 8)
                # a mid-flight re-placement: c2 moves under c1
                swarm.on_primary_parent(tid, "c2", "c1" if n % 2 else "p-seed")
                time.sleep(0.005)
            swarm.on_state(tid, "c1", "Succeeded")
        except Exception as e:  # pragma: no cover - the regression
            errors.append(e)

    def flush():
        while not stop.is_set():
            try:
                repl_a.flush_once()
            except Exception as e:  # pragma: no cover - the regression
                errors.append(e)
                return
            time.sleep(0.002)

    threads = [threading.Thread(target=churn, daemon=True), threading.Thread(target=flush, daemon=True)]
    for t in threads:
        t.start()
    threads[0].join(30.0)
    stop.set()
    threads[1].join(30.0)
    assert not errors, errors
    repl_a.flush_once()  # settle: the journal carries the final state
    victim_payload = repl_a.export_payload(tid)
    victim_obs = victim_payload["obs"]
    assert victim_obs["peers"]["c1"]["pieces"] == 8

    # successor: empty observatory, empty resource model
    swarm.reset()
    resource_b = m.res.Resource()
    repl_b = m.repl.SwarmReplicator(kv, "127.0.0.1:2", resource_b)
    adopted_before = _adoptions(m, "adopted")
    assert repl_b.adopt_task(tid) is True
    assert _adoptions(m, "adopted") == adopted_before + 1
    assert repl_b.adopt_task(tid) is False  # idempotent: seeded once

    task_b = resource_b.task_manager.load(tid)
    assert task_b is not None
    assert task_b.total_piece_count == 8 and task_b.piece_length == PIECE
    for pid in ("p-seed", "c1", "c2", "c3"):
        peer_b = resource_b.peer_manager.load(pid)
        assert peer_b is not None, pid
        peer_a = resource_a.peer_manager.load(pid)
        assert peer_b.finished_pieces == peer_a.finished_pieces, pid

    obs = swarm.export_task(tid)
    assert obs is not None
    assert set(obs["peers"]) == set(victim_obs["peers"])
    for pid, view in victim_obs["peers"].items():
        assert obs["peers"][pid]["parent"] == view["parent"], pid
        assert obs["peers"][pid]["pieces"] == view["pieces"], pid
    roots = sum(1 for p in obs["peers"].values() if p["parent"] is None)
    assert obs["edges"] == len(obs["peers"]) - roots

    # the successor's own re-journal diffs clean against the victim's
    d = diff_replicas(m, victim_payload, repl_b.export_payload(tid))
    assert d["clean"], d

    receipt = json.loads(kv.get(m.kv.make_swarm_adopt_key(tid)))
    assert receipt["outcome"] == "adopted"
    assert receipt["victim"] == "127.0.0.1:1"
    assert receipt["adopted_by"] == "127.0.0.1:2"
    assert receipt["payload"]["obs"]["peers"].keys() == obs["peers"].keys()
    assert _adopt_events(m, "ok", tid)


@both
def test_stale_epoch_replica_is_refused_at_the_floor(m):
    """A replica stamped by an older fleet generation does not seed the
    successor: epoch 3 against floor 5 → refused, nothing materialized,
    a refusal receipt and flight event left behind."""
    kv = m.kv.KVStore()
    resource_a = m.res.Resource()
    tid = "rt-stale"
    _victim_swarm(m, resource_a, tid)
    repl_a = m.repl.SwarmReplicator(kv, "127.0.0.1:1", resource_a, fleet=_FakeFleet(epoch=3, floor=3))
    assert repl_a.flush_once() == 1

    m.swarm.reset()
    resource_b = m.res.Resource()
    repl_b = m.repl.SwarmReplicator(kv, "127.0.0.1:2", resource_b, fleet=_FakeFleet(epoch=5, floor=5))
    stale_before = _adoptions(m, "stale")
    assert repl_b.adopt_task(tid) is False
    assert _adoptions(m, "stale") == stale_before + 1
    assert resource_b.task_manager.load(tid) is None
    assert m.swarm.export_task(tid) is None
    receipt = json.loads(kv.get(m.kv.make_swarm_adopt_key(tid)))
    assert receipt["outcome"] == "stale"
    events = _adopt_events(m, "refused", tid)
    assert events and events[-1]["reason"] == "stale"
    assert events[-1]["floor"] == 5 and events[-1]["epoch"] == 3


@both
def test_torn_replica_fails_the_conservation_gate(m):
    """A replica whose edge count disagrees with its peer map (torn
    write, corrupted payload) is discarded — adopting wrong is worse
    than rebuilding."""
    kv = m.kv.KVStore()
    resource_a = m.res.Resource()
    tid = "rt-torn"
    _victim_swarm(m, resource_a, tid)
    repl_a = m.repl.SwarmReplicator(kv, "127.0.0.1:1", resource_a)
    assert repl_a.flush_once() == 1

    key = m.kv.make_swarm_replica_key(tid)
    payload = json.loads(kv.hmget(key, ["data"])[0])
    payload["obs"]["edges"] += 1  # identity now violated
    kv.hset(key, {"data": json.dumps(payload)})

    m.swarm.reset()
    resource_b = m.res.Resource()
    repl_b = m.repl.SwarmReplicator(kv, "127.0.0.1:2", resource_b)
    torn_before = _adoptions(m, "torn")
    assert repl_b.adopt_task(tid) is False
    assert _adoptions(m, "torn") == torn_before + 1
    assert resource_b.task_manager.load(tid) is None
    assert m.swarm.export_task(tid) is None
    assert json.loads(kv.get(m.kv.make_swarm_adopt_key(tid)))["outcome"] == "torn"
    events = _adopt_events(m, "refused", tid)
    assert events and events[-1]["reason"] == "torn"


@both
def test_missing_replica_is_counted_not_crashed(m):
    kv = m.kv.KVStore()
    repl = m.repl.SwarmReplicator(kv, "127.0.0.1:2", m.res.Resource())
    missing_before = _adoptions(m, "missing")
    assert repl.adopt_task("never-replicated") is False
    assert _adoptions(m, "missing") == missing_before + 1


@both
def test_flush_coalesces_dirty_tasks_and_caps_the_backlog(m):
    kv = m.kv.KVStore()
    repl = m.repl.SwarmReplicator(
        kv, "127.0.0.1:1", m.res.Resource(),
        config=m.repl.ReplicationConfig(backlog_cap=2, max_tasks_per_flush=1),
    )
    for tid in ("bk-1", "bk-2", "bk-3"):
        m.swarm.on_peer(tid, "p", seed=True)
    dropped_before = m.repl.REPL_DROPPED_TOTAL.value
    assert repl.flush_once() == 1  # three dirty → cap 2 → batch of 1
    assert m.repl.REPL_DROPPED_TOTAL.value == dropped_before + 1
    assert repl.stats()["backlog"] == 1
    assert repl.flush_once() == 1  # the carried-over task drains next
    assert repl.stats()["backlog"] == 0

    # re-dirtying a journaled task coalesces to one pending entry
    m.swarm.on_piece("bk-2", "p", 1, 4)
    m.swarm.on_piece("bk-2", "p", 2, 4)
    assert repl.flush_once() == 1


@both
def test_task_gone_turns_into_a_replica_delete(m):
    kv = m.kv.KVStore()
    resource = m.res.Resource()
    tid = "rt-gone"
    _victim_swarm(m, resource, tid)
    repl = m.repl.SwarmReplicator(kv, "127.0.0.1:1", resource)
    assert repl.flush_once() == 1
    assert kv.hmget(m.kv.make_swarm_replica_key(tid), ["data"])[0] is not None

    m.swarm.on_task_gone(tid)  # eviction marks dirty; export finds nothing
    assert repl.flush_once() == 0
    assert kv.hmget(m.kv.make_swarm_replica_key(tid), ["data"])[0] is None
    assert kv.hmget(m.kv.SWARM_REPLICA_INDEX_KEY, [tid])[0] is None


def _repl_scheduler(m, tmp_path, name, kv, cfg, join=True):
    resource = m.res.Resource()
    service = m.service.SchedulerService(
        resource,
        m.scheduling.Scheduling(
            m.evaluator.BaseEvaluator(),
            m.scheduling.SchedulingConfig(retry_interval=0.0, retry_back_to_source_limit=2),
        ),
        storage=m.storage.Storage(tmp_path / f"rec-{m.name}-{name}", buffer_size=1),
    )
    server, bound = m.glue.serve({m.service.SERVICE_NAME: service}, address="127.0.0.1:0")
    addr = f"127.0.0.1:{bound}"
    membership = m.fleet.FleetMembership(kv, addr, cfg)
    if join:
        membership._renew_once()
        membership.reconcile()
    replication = m.repl.SwarmReplicator(kv, addr, resource, fleet=membership)
    service.fleet = membership
    service.replication = replication
    return {
        "resource": resource, "server": server, "addr": addr,
        "fleet": membership, "service": service, "replication": replication,
    }


@both
def test_wrong_shard_handoff_preserves_in_flight_piece_progress(m, tmp_path):
    """End to end over real gRPC: a seed and an in-flight child build a
    swarm on the owner; a join remaps the task; the owner's WRONG_SHARD
    refusal migrates the replica with the refusal; the child's
    re-register at the new owner adopts it and is RECOGNIZED — scheduled
    a parent at once, finished pieces intact. Beats and reconciles run
    by hand."""
    kv = m.kv.KVStore()
    cfg = m.fleet.FleetConfig(lease_ttl=30.0, renew_interval=1.0, poll_interval=0.5, grace_s=0.0)
    s1 = _repl_scheduler(m, tmp_path, "one", kv, cfg)
    s2 = _repl_scheduler(m, tmp_path, "two", kv, cfg, join=False)
    sel = m.glue.SchedulerSelector([s1["addr"], s2["addr"]])
    handle = None
    try:
        # a task that will remap to s2 once it joins — while s1 is the
        # sole member it owns everything, so the swarm builds on s1
        ring = m.glue.ConsistentHashRing([s1["addr"], s2["addr"]])
        tid = next(t for t in (f"handoff-{i}" for i in range(200)) if ring.pick(t) == s2["addr"])
        url = f"http://origin/{tid}.bin"
        c1 = sel.client_for(s1["addr"])
        m.stress._drill_seed(c1, tid, url, "h-seed", "p-seed", PIECE, 4)
        kind, handle = m.stress._drill_child(c1, tid, url, "h-child", "p-child", PIECE, 2)
        assert kind == "normal_task"
        m.stress._drill_close(handle)
        handle = None
        assert s1["replication"].flush_once() >= 1

        s2["fleet"]._renew_once()
        s2["fleet"].reconcile()
        s1["fleet"].reconcile()
        s2["fleet"].reconcile()
        assert s1["fleet"].owner_of(tid) == s2["addr"]

        # re-announce at the old owner: typed refusal + synchronous
        # replica migration stamped with the settled post-join epoch
        with pytest.raises(Exception) as exc:
            m.stress._drill_announce(c1, tid, url, "h-child", "p-child", timeout=10.0)
        parsed = m.fleet.parse_wrong_shard(str(exc.value))
        assert parsed is not None and parsed[0] == s2["addr"]
        index_meta = json.loads(kv.hmget(m.kv.SWARM_REPLICA_INDEX_KEY, [tid])[0])
        assert index_meta["handoff_to"] == s2["addr"]

        # the child follows the owner hint: first sighting on s2 adopts
        # the migrated replica, so the very first decision is a
        # re-schedule with the seed as parent — not back-to-source
        q, responses, first = m.stress._drill_announce(sel.client_for(s2["addr"]), tid, url, "h-child", "p-child",
                                                       timeout=10.0)
        handle = (q, responses)
        assert first.WhichOneof("response") == "normal_task"
        parents = {p.peer_id for p in first.normal_task.candidate_parents}
        assert "p-seed" in parents

        child = s2["resource"].peer_manager.load("p-child")
        assert child is not None
        assert child.finished_pieces == {0, 1}
        seed = s2["resource"].peer_manager.load("p-seed")
        assert seed is not None and len(seed.finished_pieces) == 4
        receipt = json.loads(kv.get(m.kv.make_swarm_adopt_key(tid)))
        assert receipt["outcome"] == "adopted"
        assert receipt["victim"] == s1["addr"]
        assert receipt["adopted_by"] == s2["addr"]
        obs = m.swarm.export_task(tid)
        roots = sum(1 for p in obs["peers"].values() if p["parent"] is None)
        assert obs["edges"] == len(obs["peers"]) - roots
    finally:
        m.stress._drill_close(handle)
        sel.close()
        for s in (s2, s1):
            try:
                s["fleet"].abandon()
                s["server"].stop(0)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _model_view(resource, task_id: str) -> dict:
    """What a successor's resource model holds of one task: its hosts'
    addressing, the task's meta and state, each peer's FSM state, host
    and finished pieces, and the DAG's parent edges."""
    task = resource.task_manager.load(task_id)
    peers = sorted((p for p in resource.peer_manager.all() if p.task.id == task_id), key=lambda p: p.id)
    return {
        "task": None if task is None else (
            task.id, task.url, task.type.value, task.digest, task.tag, task.application, task.piece_length,
            task.content_length, task.total_piece_count, task.fsm.current),
        "hosts": sorted((h.id, h.type.value, h.hostname, h.ip, h.port, h.download_port)
                        for h in resource.host_manager.all()),
        "peers": [(p.id, p.fsm.current, p.host.id, sorted(p.finished_pieces)) for p in peers],
        "edges": sorted((q.id, p.id) for p in peers for q in task.peer_parents(p.id)) if task else [],
    }


def _hooks(m, tid: str):
    """One hook sequence, the same in both packages: the victim swarm,
    then churn (pieces, a re-placement, a reschedule, a back-to-source)."""
    resource = m.res.Resource()
    _victim_swarm(m, resource, tid)
    c1 = resource.peer_manager.load("c1")
    for n in range(2, 6):
        c1.finished_pieces.add(n)
        m.swarm.on_piece(tid, "c1", len(c1.finished_pieces), 8)
    m.swarm.on_primary_parent(tid, "c2", "c1")
    m.swarm.on_reschedule(tid, "c3")
    m.swarm.on_state(tid, "c3", "BackToSource")
    return resource


def test_one_hook_sequence_exports_alike():
    views = {}
    for name, m in PKGS.items():
        resource = _hooks(m, "xp-export")
        repl = m.repl.SwarmReplicator(m.kv.KVStore(), "127.0.0.1:1", resource)
        views[name] = (m.swarm.export_task("xp-export"), repl.export_payload("xp-export"),
                       sorted(m.swarm.task_ids()), sorted(m.swarm.drain_dirty()), sorted(m.swarm.drain_dirty()))
    assert views["torch"] == views["jax"]
    obs, payload, ids, dirty, again = views["torch"]
    assert payload["obs"] == obs and ids == dirty == ["xp-export"] and again == []
    # the reschedule took c3 off its parent
    assert obs["edges"] == 2 and obs["peers"]["c2"]["parent"] == "c1" and obs["peers"]["c3"]["parent"] is None
    assert obs["back_to_source"] == 1 and obs["reschedules"] == 1


@crossed
def test_a_replica_is_adopted_across_packages(writer, adopter):
    """A replica written by one package's replicator is adopted by the
    other's into the resource model the writer's own successor builds."""
    w, a = PKGS[writer], PKGS[adopter]
    tid = "xp-adopt"
    kv = w.kv.KVStore()
    _victim = _hooks(w, tid)
    assert w.repl.SwarmReplicator(kv, "127.0.0.1:1", _victim, fleet=_FakeFleet(4, 4)).flush_once() == 1
    victim_payload = json.loads(kv.hmget(w.kv.make_swarm_replica_key(tid), ["data"])[0])

    models, exports, receipts = {}, {}, {}
    for m in (a, w):
        m.swarm.reset()
        resource = m.res.Resource()
        repl = m.repl.SwarmReplicator(kv, f"127.0.0.1:2-{m.name}", resource, fleet=_FakeFleet(4, 4))
        assert repl.adopt_task(tid) is True
        models[m.name] = _model_view(resource, tid)
        exports[m.name] = (m.swarm.export_task(tid), repl.export_payload(tid))
        receipt = json.loads(kv.get(m.kv.make_swarm_adopt_key(tid)))
        receipts[m.name] = {k: v for k, v in receipt.items() if k not in ("adopted_by", "adopt_ms")}
    assert models[adopter] == models[writer]
    assert exports[adopter] == exports[writer]
    assert receipts[adopter] == receipts[writer]
    view = models[adopter]
    assert view["task"][-1] == "Running" and len(view["hosts"]) == 4
    assert view["edges"] == [("c1", "c2"), ("p-seed", "c1")]
    assert dict((p[0], p[1]) for p in view["peers"]) == {
        "c1": "Running", "c2": "Running", "c3": "BackToSource", "p-seed": "Succeeded"}
    assert diff_replicas(a, victim_payload, exports[adopter][1])["clean"]


@crossed
@pytest.mark.parametrize("fault", ["stale", "torn"])
def test_refusals_match_across_packages(writer, adopter, fault):
    w = PKGS[writer]
    tid = f"xp-{fault}"
    kv = w.kv.KVStore()
    resource = w.res.Resource()
    _victim_swarm(w, resource, tid)
    assert w.repl.SwarmReplicator(kv, "127.0.0.1:1", resource, fleet=_FakeFleet(3, 3)).flush_once() == 1
    if fault == "torn":
        key = w.kv.make_swarm_replica_key(tid)
        payload = json.loads(kv.hmget(key, ["data"])[0])
        payload["obs"]["edges"] += 1
        kv.hset(key, {"data": json.dumps(payload)})
    floor = 5 if fault == "stale" else 3
    got = {}
    for m in (PKGS[adopter], w):
        m.swarm.reset()
        resource = m.res.Resource()
        repl = m.repl.SwarmReplicator(kv, "127.0.0.1:2", resource, fleet=_FakeFleet(floor, floor))
        assert repl.adopt_task(tid) is False
        event = _adopt_events(m, "refused", tid)[-1]
        got[m.name] = (json.loads(kv.get(m.kv.make_swarm_adopt_key(tid))),
                       {k: event[k] for k in ("victim", "epoch", "seq", "floor", "reason")},
                       resource.task_manager.load(tid), m.swarm.export_task(tid))
    assert got["torch"] == got["jax"]
    receipt, event, task, obs = got["torch"]
    assert receipt["outcome"] == event["reason"] == fault and task is None and obs is None


def test_force_fires_only_on_a_change():
    """``FSM.force`` sets any state and fires ``on_transition`` only when
    the state moved, in both packages."""
    seen = {}
    for name, m in PKGS.items():
        fired = []
        fsm = m.fsm.FSM("Pending", [m.fsm.Transition("run", ("Pending",), "Running")])
        fsm.on_transition = fired.append
        fsm.force("Pending")
        fsm.force("Succeeded")
        fsm.force("Succeeded")
        runnable = fsm.can("run")
        fsm.force("Pending")
        fsm.event("run")
        seen[name] = (fired, fsm.current, runnable)
    assert seen["torch"] == seen["jax"] == (["Succeeded", "Pending", "Running"], "Running", False)
