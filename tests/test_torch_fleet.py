"""The port's scheduler fleet (``dragonfly2_torch/scheduler/fleet.py``)
against the reference's (``dragonfly2_tpu/scheduler/fleet.py``).

Every case of the reference's ``tests/test_fleet.py`` runs on both
packages as a case of one parametrised test: the ring and the selector's
membership hooks, leases and their expiry, the join-triggered rebalance
and the grace window, the ``WRONG_SHARD`` protocol and the drills over
real gRPC (a daemon's re-pick, an owner dying mid-download, a dead
member's task failing over, an announce stream resuming on the
successor), the fault points, the server assemblies and the manager's
fleet view. Then the packages cross: a port member and a reference
member on one store agree on the members, on the owner of 1,000 task ids
and on the epoch after a join and after a leave, and refuse with the
same ``WRONG_SHARD`` text; both managers answer ``ListSchedulers`` alike
over one lease plane; and the port's scheduler servers and daemon join
and follow the fleet through the port's manager with its embedded KV.

No test asserts after a fixed sleep: beats and reconciles run by hand
where the reference waits on its timers, and a lease that must expire is
polled for with a deadline of ``DEADLINE_S``."""

import os
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from dragonfly2_torch.client import daemon as t_daemon
from dragonfly2_torch.client import dfget as t_dfget
from dragonfly2_torch.client import metrics as t_cmetrics
from dragonfly2_torch.manager import database as t_database
from dragonfly2_torch.manager import models_registry as t_registry
from dragonfly2_torch.manager import objectstorage as t_objectstorage
from dragonfly2_torch.manager import service as t_mservice
from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.scheduler import evaluator as t_evaluator
from dragonfly2_torch.scheduler import fleet as t_fleet
from dragonfly2_torch.scheduler import resource as t_res
from dragonfly2_torch.scheduler import scheduling as t_scheduling
from dragonfly2_torch.scheduler import server as t_server
from dragonfly2_torch.scheduler import service as t_service
from dragonfly2_torch.scheduler import storage as t_storage
from dragonfly2_torch.utils import faults as t_faults
from dragonfly2_torch.utils import idgen as t_idgen
from dragonfly2_torch.utils import kvserver as t_kvserver
from dragonfly2_torch.utils import kvstore as t_kv
from dragonfly2_torch.utils import profiling as t_profiling

from dragonfly2_tpu.client import daemon as j_daemon
from dragonfly2_tpu.client import dfget as j_dfget
from dragonfly2_tpu.client import metrics as j_cmetrics
from dragonfly2_tpu.manager import database as j_database
from dragonfly2_tpu.manager import models_registry as j_registry
from dragonfly2_tpu.manager import objectstorage as j_objectstorage
from dragonfly2_tpu.manager import service as j_mservice
from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.scheduler import evaluator as j_evaluator
from dragonfly2_tpu.scheduler import fleet as j_fleet
from dragonfly2_tpu.scheduler import resource as j_res
from dragonfly2_tpu.scheduler import scheduling as j_scheduling
from dragonfly2_tpu.scheduler import server as j_server
from dragonfly2_tpu.scheduler import service as j_service
from dragonfly2_tpu.scheduler import storage as j_storage
from dragonfly2_tpu.utils import faults as j_faults
from dragonfly2_tpu.utils import idgen as j_idgen
from dragonfly2_tpu.utils import kvserver as j_kvserver
from dragonfly2_tpu.utils import kvstore as j_kv
from dragonfly2_tpu.utils import profiling as j_profiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # each package's daemons and servers start its process-wide stack sampler
    # and leave it running, as a server process would; stop both once the
    # module is done so their sweeps do not tax the files run after it in
    # this process
    yield
    t_profiling.stop()
    j_profiling.stop()


PIECE = 32 * 1024
DEADLINE_S = 10.0

PKGS = {
    "torch": SimpleNamespace(
        name="torch", daemon=t_daemon, dfget=t_dfget, cmetrics=t_cmetrics, database=t_database,
        registry=t_registry, objectstorage=t_objectstorage, mservice=t_mservice, glue=t_glue,
        evaluator=t_evaluator, fleet=t_fleet, res=t_res, scheduling=t_scheduling, server=t_server,
        service=t_service, storage=t_storage, faults=t_faults, idgen=t_idgen, kvserver=t_kvserver, kv=t_kv,
        # the port's entry points take the card unless asked for the CPU
        server_kw={"device": "cpu"},
    ),
    "jax": SimpleNamespace(
        name="jax", daemon=j_daemon, dfget=j_dfget, cmetrics=j_cmetrics, database=j_database,
        registry=j_registry, objectstorage=j_objectstorage, mservice=j_mservice, glue=j_glue,
        evaluator=j_evaluator, fleet=j_fleet, res=j_res, scheduling=j_scheduling, server=j_server,
        service=j_service, storage=j_storage, faults=j_faults, idgen=j_idgen, kvserver=j_kvserver, kv=j_kv,
        server_kw={},
    ),
}
both = pytest.mark.parametrize("pkg", sorted(PKGS))
manager_pb2 = protos.load("manager_pb2")
scheduler_pb2 = protos.load("scheduler_pb2")
common_pb2 = protos.load("common_pb2")


@pytest.fixture
def m(pkg):
    mod = PKGS[pkg]
    yield mod
    mod.faults.clear()


def _until(cond, what: str, deadline_s: float = DEADLINE_S, beat=None):
    """Poll ``cond`` until it holds or the deadline passes (then fail);
    ``beat`` runs between polls (a hand-driven heartbeat)."""
    deadline = time.monotonic() + deadline_s
    while not cond():
        assert time.monotonic() < deadline, f"{what} not within {deadline_s:.0f} s"
        if beat is not None:
            beat()
        time.sleep(0.02)


# ---------------------------------------------------------------------------
# ring: version + indexed remove + successors
# ---------------------------------------------------------------------------


@both
def test_ring_version_is_monotonic_and_remove_uses_index(m):
    ring = m.glue.ConsistentHashRing(["a:1", "b:2", "c:3"])
    assert ring.version == 3 and len(ring) == 3
    before = {f"t-{i}": ring.pick(f"t-{i}") for i in range(200)}
    ring.remove("b:2")
    assert ring.version == 4
    assert "b:2" not in ring
    # only b's keys remapped; everything else stays put
    for k, owner in before.items():
        if owner != "b:2":
            assert ring.pick(k) == owner
        else:
            assert ring.pick(k) != "b:2"
    # the internal vnode list is consistent: re-add is exact, idempotent
    ring.add("b:2")
    ring.add("b:2")
    assert ring.version == 5
    assert len(ring._ring) == 3 * m.glue.ConsistentHashRing.VNODES
    assert {k: ring.pick(k) for k in before} == before

    ring.remove("nope:0")  # unknown member: no-op, no version bump
    assert ring.version == 5


@both
def test_ring_successors_start_at_owner_and_cover_all_members(m):
    ring = m.glue.ConsistentHashRing(["a:1", "b:2", "c:3"])
    for i in range(50):
        key = f"task-{i}"
        succ = ring.successors(key)
        assert succ[0] == ring.pick(key)
        assert sorted(succ) == ["a:1", "b:2", "c:3"]
    assert ring.successors("k", limit=2) == ring.successors("k")[:2]
    assert m.glue.ConsistentHashRing().successors("k") == []


# ---------------------------------------------------------------------------
# selector: snapshot-under-lock + membership hooks
# ---------------------------------------------------------------------------


@both
def test_selector_fanout_is_consistent_under_concurrent_reconcile(m):
    """all()/primary() snapshot the address set under the lock, so a
    racing membership reconcile can never hand the fan-out a torn view.
    The race runs for a fixed number of reconciles, not for a time."""
    sel = m.glue.SchedulerSelector(["h0:1", "h1:1"])
    sel._client = lambda addr: addr  # no real dialing in a lock test
    sets = [[f"h{i}:1", f"h{i+1}:1"] for i in range(50)]
    stop = threading.Event()
    errors: list = []

    def reconcile():
        for i in range(3000):
            sel.update_addresses(sets[i % len(sets)])
        stop.set()

    def fan_out():
        while not stop.is_set():
            try:
                got = sel.all()
                # an untorn snapshot is one of the pushed sets — exactly
                # two consecutive members, never a mix of two pushes
                assert len(got) == 2, got
                a, b = sorted(int(x.split(":")[0][1:]) for x in got)
                assert b == a + 1, got
                assert sel.primary() in sum(sets, [])
            except Exception as e:  # pragma: no cover - the regression
                errors.append(e)
                return

    threads = [threading.Thread(target=reconcile, daemon=True)] + [
        threading.Thread(target=fan_out, daemon=True) for _ in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60.0)
    assert stop.is_set() and not errors, errors


@both
def test_selector_refresh_membership_reports_ring_staleness(m):
    sel = m.glue.SchedulerSelector(["a:1"])
    assert sel.refresh_membership() is False  # no source wired
    sel.set_membership_source(lambda: ["a:1", "b:2"])
    assert sel.refresh_membership() is True  # ring moved
    assert sel.refresh_membership() is False  # already converged
    assert sorted(sel.addresses) == ["a:1", "b:2"]
    v = sel.ring_version()
    sel.ensure_address("c:3")  # WRONG_SHARD owner hint adoption
    assert sel.ring_version() == v + 1 and "c:3" in sel.addresses
    sel.ensure_address("c:3")
    assert sel.ring_version() == v + 1  # idempotent


@both
def test_refresh_membership_clears_cooldown_for_leased_members(m):
    """A live lease is fresh evidence: refresh_membership and the
    client_for hint path clear a member's dial cooldown."""
    sel = m.glue.SchedulerSelector(["a:1", "b:2"])
    sel.set_membership_source(lambda: ["a:1", "b:2"])
    far = time.monotonic() + 60.0
    sel._fail_until["a:1"] = far
    sel.refresh_membership()
    assert "a:1" not in sel._fail_until

    sel._fail_until["b:2"] = far
    sel._client = lambda addr: addr  # no real dial
    assert sel.client_for("b:2") == "b:2"
    assert "b:2" not in sel._fail_until


# ---------------------------------------------------------------------------
# leases: expiry evicts
# ---------------------------------------------------------------------------


@both
def test_lease_expiry_evicts_member_within_ttl(m):
    kv = m.kv.KVStore()
    cfg = m.fleet.FleetConfig(lease_ttl=0.4, renew_interval=0.1, poll_interval=0.1)
    a = m.fleet.FleetMembership(kv, "127.0.0.1:1", cfg)
    b = m.fleet.FleetMembership(kv, "127.0.0.1:2", cfg)
    # beats and reconciles by hand: join's own first beat, then no loop
    for x in (a, b):
        x._renew_once()
    a.reconcile()
    try:
        assert a.members() == ["127.0.0.1:1", "127.0.0.1:2"]

        # SIGKILL shape: b stops heartbeating but never deletes its lease
        _until(lambda: "127.0.0.1:2" not in m.fleet.read_members(kv), "b's lease expiry", beat=a._renew_once)
        assert m.fleet.read_members(kv) == ["127.0.0.1:1"]
        assert a.reconcile() is True
        assert a.members() == ["127.0.0.1:1"]
        assert "127.0.0.1:2" not in a.ring
        # a now owns everything: no task can be refused
        for i in range(20):
            a.check_owner(f"task-{i}")
    finally:
        a.leave()
        b.leave()


@both
def test_graceful_leave_deletes_the_lease_immediately(m):
    kv = m.kv.KVStore()
    mem = m.fleet.FleetMembership(kv, "127.0.0.1:9", m.fleet.FleetConfig(lease_ttl=30.0))
    mem.join()
    assert m.fleet.read_members(kv) == ["127.0.0.1:9"]
    mem.leave()
    assert m.fleet.read_members(kv) == []  # no 30s TTL wait


# ---------------------------------------------------------------------------
# ownership: join-triggered rebalance moves only remapped tasks
# ---------------------------------------------------------------------------


@both
def test_join_rebalance_refuses_only_remapped_tasks(m):
    kv = m.kv.KVStore()
    cfg = m.fleet.FleetConfig(lease_ttl=30.0, grace_s=0.0)
    a = m.fleet.FleetMembership(kv, "127.0.0.1:1", cfg)
    a._renew_once()
    a.reconcile()
    tasks = [f"task-{i}" for i in range(300)]
    for t in tasks:
        a.check_owner(t)  # sole member owns everything

    b = m.fleet.FleetMembership(kv, "127.0.0.1:2", cfg)
    b._renew_once()
    b.reconcile()
    a.reconcile()
    moved = stayed = 0
    for t in tasks:
        owner = a.owner_of(t)
        if owner == "127.0.0.1:1":
            a.check_owner(t)  # unmoved: still served here
            stayed += 1
        else:
            with pytest.raises(m.fleet.WrongShardError) as exc:
                a.check_owner(t)
            assert exc.value.owner == "127.0.0.1:2"
            moved += 1
    # bounded hand-off: a join moves roughly half, never all
    assert 0 < moved < len(tasks) and stayed > 0
    b.leave()
    a.leave()


@both
def test_grace_window_drains_in_flight_tasks_on_the_old_owner(m):
    kv = m.kv.KVStore()
    cfg = m.fleet.FleetConfig(lease_ttl=30.0, grace_s=5.0)
    a = m.fleet.FleetMembership(kv, "127.0.0.1:1", cfg)
    b = m.fleet.FleetMembership(kv, "127.0.0.1:2", cfg)
    for x in (a, b):
        x._renew_once()
        x.reconcile()
    a.reconcile()
    remapped = next(
        t for t in (f"task-{i}" for i in range(300))
        if a.owner_of(t) == "127.0.0.1:2"
    )
    # fresh task: refused outright
    with pytest.raises(m.fleet.WrongShardError):
        a.check_owner(remapped)
    # in-flight task: drains here while the grace window is open
    a.check_owner(remapped, task_in_flight=True)
    # grace over → even in-flight registers move
    a._ring_changed_at = time.monotonic() - cfg.grace_s - 1.0
    with pytest.raises(m.fleet.WrongShardError):
        a.check_owner(remapped, task_in_flight=True)
    b.leave()
    a.leave()


@both
def test_wrong_shard_wire_protocol_round_trips(m):
    s = m.fleet.format_wrong_shard("10.0.0.3:8002", 17)
    assert m.fleet.parse_wrong_shard(s) == ("10.0.0.3:8002", 17)
    # gRPC wraps details in debug context; parse anywhere in the text
    wrapped = f'<RpcError ... details = "{s}" ...>'
    assert m.fleet.parse_wrong_shard(wrapped) == ("10.0.0.3:8002", 17)
    assert m.fleet.parse_wrong_shard("deadline exceeded") is None
    assert m.fleet.parse_wrong_shard("") is None


# ---------------------------------------------------------------------------
# real-gRPC drills
# ---------------------------------------------------------------------------


def _fleet_scheduler(m, tmp_path, name, kv, cfg=None, join=True):
    resource = m.res.Resource()
    storage = m.storage.Storage(tmp_path / f"rec-{name}", buffer_size=1)
    service = m.service.SchedulerService(
        resource,
        m.scheduling.Scheduling(
            m.evaluator.BaseEvaluator(),
            m.scheduling.SchedulingConfig(retry_interval=0.0, retry_back_to_source_limit=2),
        ),
        storage=storage,
    )
    server, bound = m.glue.serve({m.service.SERVICE_NAME: service}, address="127.0.0.1:0")
    addr = f"127.0.0.1:{bound}"
    membership = m.fleet.FleetMembership(
        kv, addr, cfg or m.fleet.FleetConfig(lease_ttl=1.0, renew_interval=0.25,
                                             poll_interval=0.2, grace_s=0.0)
    )
    if join:
        membership.join()
    service.fleet = membership
    return {
        "resource": resource, "server": server, "port": bound,
        "addr": addr, "fleet": membership, "service": service,
    }


def _daemon(m, tmp_path, name, addresses, **kw):
    d = m.daemon.Daemon(
        m.daemon.DaemonConfig(
            data_dir=str(tmp_path / f"daemon-{name}"),
            scheduler_address=addresses,
            hostname=f"host-{name}",
            piece_length=PIECE,
            announce_interval=kw.pop("announce_interval", 0.5),
            schedule_timeout=kw.pop("schedule_timeout", 8.0),
            **kw,
        )
    )
    d.start()
    return d


def _wrong_shard_count(m, side: str) -> float:
    return sum(c.value for labels, c in m.fleet.WRONG_SHARD_TOTAL._snapshot() if labels == (side,))


def _two_shard_cluster(m, tmp_path, kv, cfg):
    s1 = _fleet_scheduler(m, tmp_path, "one", kv, cfg)
    s2 = _fleet_scheduler(m, tmp_path, "two", kv, cfg)
    s1["fleet"].reconcile()
    s2["fleet"].reconcile()
    return s1, s2


def _teardown(daemons, schedulers):
    for d in daemons:
        if d is not None:
            try:
                d.stop()
            except Exception:
                pass
    for s in schedulers:
        try:
            s["fleet"].abandon()
            s["server"].stop(0)
        except Exception:
            pass


@both
def test_wrong_shard_refusal_daemon_repicks_over_grpc(m, tmp_path):
    """A daemon with a stale one-member view announces to the wrong
    scheduler; the typed WRONG_SHARD refusal sends it through refresh →
    re-pick, and the download lands on the real owner."""
    kv = m.kv.KVStore()
    s1 = _fleet_scheduler(m, tmp_path, "one", kv)
    s2 = _fleet_scheduler(m, tmp_path, "two", kv)
    s1["fleet"].reconcile()
    s2["fleet"].reconcile()
    d = None
    try:
        payload = os.urandom(3 * PIECE)
        origin = tmp_path / "o.bin"
        origin.write_bytes(payload)
        url = f"file://{origin}"
        task_id = m.idgen.task_id_v1(url, m.idgen.URLMeta())
        owner_addr = s1["fleet"].owner_of(task_id)
        owner, non_owner = (s1, s2) if owner_addr == s1["addr"] else (s2, s1)

        refused_before = _wrong_shard_count(m, "scheduler")
        repicked_before = _wrong_shard_count(m, "daemon")
        # stale daemon: static list holds ONLY the non-owner; the live
        # member feed is wired but not yet polled
        d = _daemon(m, tmp_path, "stale", non_owner["addr"])
        d._selector.set_membership_source(lambda: m.fleet.read_members(kv))

        out = tmp_path / "out.bin"
        m.dfget.download(f"127.0.0.1:{d.port}", url, str(out))
        assert out.read_bytes() == payload

        # the task landed on its ring owner, not where the daemon aimed
        assert [t.id for t in owner["resource"].task_manager.all()] == [task_id]
        assert non_owner["resource"].task_manager.all() == []
        assert _wrong_shard_count(m, "scheduler") > refused_before
        assert _wrong_shard_count(m, "daemon") > repicked_before
    finally:
        _teardown((d,), (s1, s2))


@both
def test_owner_sigkill_mid_download_is_lossless(m, tmp_path):
    """The task's owner dies abruptly (gRPC plane gone, lease left to
    expire) while a P2P download is in flight: the piece plane keeps
    pulling from the live parent and the download completes — correct
    bytes, no hang, no origin fallback. The kill lands once the owner
    holds the in-flight peer, not after a fixed sleep."""
    kv = m.kv.KVStore()
    cfg = m.fleet.FleetConfig(lease_ttl=0.8, renew_interval=0.2, poll_interval=0.15, grace_s=10.0)
    s1, s2 = _two_shard_cluster(m, tmp_path, kv, cfg)
    addrs = f"{s1['addr']},{s2['addr']}"
    a = b = None
    try:
        a = _daemon(m, tmp_path, "a", addrs, announce_interval=0.3)
        b = _daemon(m, tmp_path, "b", addrs, announce_interval=0.3)
        for d in (a, b):
            d._selector.set_membership_source(lambda: m.fleet.read_members(kv))

        payload = os.urandom(6 * PIECE)
        origin = tmp_path / "o.bin"
        origin.write_bytes(payload)
        url = f"file://{origin}"
        task_id = m.idgen.task_id_v1(url, m.idgen.URLMeta())
        owner = s1 if s1["fleet"].owner_of(task_id) == s1["addr"] else s2

        # seed on A so B's download runs P2P
        m.dfget.download(f"127.0.0.1:{a.port}", url, str(tmp_path / "a.bin"))

        # stretch B's piece fetches so the kill lands mid-download
        m.faults.configure("daemon.piece_read=delay:150")
        bts_before = m.cmetrics.BACK_TO_SOURCE_TOTAL.value
        out = tmp_path / "b.bin"
        result: dict = {}

        def work():
            try:
                m.dfget.download(f"127.0.0.1:{b.port}", url, str(out))
                result["ok"] = True
            except Exception as e:
                result["error"] = str(e)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        _until(lambda: len(owner["resource"].peer_manager.all()) >= 2 or "ok" in result,
               "B's register at the owner")
        assert "ok" not in result, "the download ended before the kill"
        # SIGKILL shape: serving plane gone, lease abandoned (expires)
        owner["server"].stop(None)
        owner["fleet"].abandon()

        t.join(30.0)
        assert not t.is_alive(), "download hung across the owner's death"
        assert result.get("ok"), result.get("error")
        assert out.read_bytes() == payload
        assert m.cmetrics.BACK_TO_SOURCE_TOTAL.value == bts_before
    finally:
        m.faults.clear()
        _teardown((b, a), (s2, s1))


@both
def test_dead_member_task_fails_over_within_bounded_blackout(m, tmp_path):
    """A task owned by a freshly-dead member (lease still live) still
    schedules: the daemon rides the retry window until expiry flips
    ownership — bounded by one lease TTL + one poll, never an error or a
    hang."""
    kv = m.kv.KVStore()
    cfg = m.fleet.FleetConfig(lease_ttl=0.8, renew_interval=0.2, poll_interval=0.15, grace_s=0.0)
    s1, s2 = _two_shard_cluster(m, tmp_path, kv, cfg)
    addrs = f"{s1['addr']},{s2['addr']}"
    d = None
    try:
        d = _daemon(m, tmp_path, "d", addrs, announce_interval=0.3)
        d._selector.set_membership_source(lambda: m.fleet.read_members(kv))

        # find a payload whose task pins to s1, then kill s1
        for i in range(50):
            origin = tmp_path / f"o-{i}.bin"
            url = f"file://{origin}"
            if s1["fleet"].owner_of(m.idgen.task_id_v1(url, m.idgen.URLMeta())) == s1["addr"]:
                break
        payload = os.urandom(2 * PIECE)
        origin.write_bytes(payload)
        task_id = m.idgen.task_id_v1(url, m.idgen.URLMeta())

        s1["server"].stop(None)
        s1["fleet"].abandon()
        t_kill = time.monotonic()

        out = tmp_path / "out.bin"
        m.dfget.download(f"127.0.0.1:{d.port}", url, str(out))
        blackout_s = time.monotonic() - t_kill
        assert out.read_bytes() == payload
        # the survivor owns the task now
        assert task_id in {t.id for t in s2["resource"].task_manager.all()}
        # bounded blackout: TTL + poll + scheduling/backoff slack
        assert blackout_s < cfg.lease_ttl + cfg.poll_interval + 8.0, blackout_s
    finally:
        _teardown((d,), (s2, s1))


@both
def test_announce_stream_resumes_on_successor_with_same_peer_id(m, tmp_path):
    """Peer P registers with the owner, the owner dies, and the SAME
    peer_id re-registers through for_task — which now resolves the ring
    successor — and gets re-dispatched."""
    import queue as _queue

    kv = m.kv.KVStore()
    cfg = m.fleet.FleetConfig(lease_ttl=0.6, renew_interval=0.2, poll_interval=0.15, grace_s=10.0)
    s1, s2 = _two_shard_cluster(m, tmp_path, kv, cfg)
    sel = m.glue.SchedulerSelector([s1["addr"], s2["addr"]])
    sel.set_membership_source(lambda: m.fleet.read_members(kv))
    try:
        url = "http://origin/fleet-resume.bin"
        task_id = m.idgen.task_id_v1(url, m.idgen.URLMeta())
        owner_addr = sel.addr_for_task(task_id)
        owner, survivor = (s1, s2) if owner_addr == s1["addr"] else (s2, s1)
        peer_id = "peer-fleet-resume-1"

        def announce_once():
            q: "_queue.Queue" = _queue.Queue()
            q.put(
                scheduler_pb2.AnnouncePeerRequest(
                    host_id="host-x", task_id=task_id, peer_id=peer_id,
                    register_peer=scheduler_pb2.RegisterPeerRequest(
                        task_id=task_id, peer_id=peer_id, url=url,
                        url_meta=common_pb2.UrlMeta(),
                    ),
                )
            )
            responses = sel.for_task(task_id).AnnouncePeer(iter(q.get, None))
            first = next(responses)
            q.put(None)
            for _ in responses:
                pass
            return first

        first = announce_once()
        assert first.WhichOneof("response")
        assert peer_id in {p.id for p in owner["resource"].peer_manager.all()}

        # owner dies; its lease drains out
        owner["server"].stop(None)
        owner["fleet"].abandon()
        _until(lambda: owner["addr"] not in m.fleet.read_members(kv), "the dead owner's lease expiry")
        survivor["fleet"].reconcile()
        assert sel.refresh_membership() is True

        # same peer_id, new stream: for_task now resolves the successor
        resumed = announce_once()
        assert resumed.WhichOneof("response")
        assert peer_id in {p.id for p in survivor["resource"].peer_manager.all()}
    finally:
        sel.close()
        _teardown((), (s2, s1))


# ---------------------------------------------------------------------------
# fault plane: fleet.lease_renew / fleet.membership_read
# ---------------------------------------------------------------------------


@both
def test_lease_renew_faults_flap_member_without_data_loss(m, tmp_path):
    """A fault schedule on ``fleet.lease_renew`` starves a member's
    heartbeat: its lease expires (flap out), later beats succeed (flap
    back in). The flapped member keeps serving what it holds, and a
    download through the flap completes. The beats run by hand."""
    kv = m.kv.KVStore()
    cfg = m.fleet.FleetConfig(lease_ttl=0.4, renew_interval=0.1, poll_interval=0.1, grace_s=0.0)
    s = _fleet_scheduler(m, tmp_path, "solo", kv, cfg, join=False)
    s["fleet"]._renew_once()  # join's beat: call #0
    s["fleet"].reconcile()
    d = None
    try:
        # the rule counts from its arming: beat 0 passes, beats 1..8 fail,
        # and the lease lapses 0.4 s after the last good one
        m.faults.configure("fleet.lease_renew=error:UNAVAILABLE#1+8")
        beats = []

        def beat():
            if len(beats) == 0:
                s["fleet"]._renew_once()
            elif len(beats) <= 8:
                with pytest.raises(Exception):
                    s["fleet"]._renew_once()
            else:
                return
            beats.append(1)

        _until(lambda: m.fleet.read_members(kv) == [], "the lease lapse under the renew faults", beat=beat)

        # during the flap: the member serves on — a download completes
        d = _daemon(m, tmp_path, "d", s["addr"])
        payload = os.urandom(2 * PIECE)
        origin = tmp_path / "o.bin"
        origin.write_bytes(payload)
        out = tmp_path / "out.bin"
        m.dfget.download(f"127.0.0.1:{d.port}", f"file://{origin}", str(out))
        assert out.read_bytes() == payload

        # beats heal → the member re-leases itself
        while len(beats) <= 8:
            beat()
        s["fleet"]._renew_once()
        assert m.fleet.read_members(kv) == [s["addr"]], "member never rejoined"
    finally:
        m.faults.clear()
        if d is not None:
            d.stop()
        s["fleet"].leave()
        s["server"].stop(0)


@both
def test_membership_read_faults_keep_the_stale_view(m):
    """An unreachable membership plane (``fleet.membership_read``
    errors) never strands a watcher: the stale member set stands until
    reads heal."""
    kv = m.kv.KVStore()
    mem = m.fleet.FleetMembership(kv, "127.0.0.1:1", m.fleet.FleetConfig(lease_ttl=30.0))
    mem._renew_once()
    seen: list = []
    w = m.fleet.FleetWatcher(kv, seen.append, poll_interval=0.05)
    assert w.poll_once() == ["127.0.0.1:1"]
    assert seen == [["127.0.0.1:1"]]

    m.faults.configure("fleet.membership_read=error:UNAVAILABLE")
    assert w.poll_once() is None  # read failed, stale view kept
    assert seen == [["127.0.0.1:1"]]
    with pytest.raises(Exception):
        m.fleet.read_members(kv)
    m.faults.clear()
    assert w.poll_once() == ["127.0.0.1:1"]


@both
def test_watcher_ignores_an_empty_member_set(m):
    kv = m.kv.KVStore()
    pushes: list = []
    w = m.fleet.FleetWatcher(kv, pushes.append, poll_interval=0.05)
    assert w.poll_once() == []
    assert pushes == []


# ---------------------------------------------------------------------------
# full assemblies: SchedulerServer fleet_enabled + Daemon kv_address
# ---------------------------------------------------------------------------


@both
def test_server_assemblies_join_and_follow_the_fleet(m, tmp_path):
    """A real SchedulerServer with ``fleet_enabled`` joins on serve (lease
    visible over the RESP server) and leaves on stop; a real Daemon with
    ``kv_address`` adopts the leased member set through its FleetWatcher
    and a download flows."""
    kv_server = m.kvserver.KVServer()
    kv_addr = f"127.0.0.1:{kv_server.serve()}"
    s = m.server.SchedulerServer(
        m.server.SchedulerServerConfig(
            data_dir=str(tmp_path / "sched"), kv_address=kv_addr, fleet_enabled=True,
            fleet_lease_ttl=1.0, fleet_renew_interval=0.3, fleet_poll_interval=0.2,
            topology_backend="off", storage_buffer_size=1, **m.server_kw,
        )
    )
    d = None
    remote = m.kv.RemoteKVStore(kv_addr)
    try:
        addr = s.serve()
        assert m.fleet.read_members(remote) == [addr]

        d = m.daemon.Daemon(
            m.daemon.DaemonConfig(
                data_dir=str(tmp_path / "daemon"), scheduler_address=addr, kv_address=kv_addr,
                fleet_poll_interval=0.2, hostname="fleet-host", piece_length=PIECE,
                announce_interval=60.0, schedule_timeout=8.0,
            )
        )
        d.start()
        assert d._fleet_watcher is not None
        assert d._selector.addresses == [addr]

        payload = os.urandom(2 * PIECE)
        origin = tmp_path / "o.bin"
        origin.write_bytes(payload)
        out = tmp_path / "out.bin"
        m.dfget.download(f"127.0.0.1:{d.port}", f"file://{origin}", str(out))
        assert out.read_bytes() == payload
    finally:
        if d is not None:
            d.stop()
        s.stop()
        # graceful stop = graceful leave: the lease is gone NOW
        assert m.fleet.read_members(remote) == []
        remote.close()
        kv_server.stop()


# ---------------------------------------------------------------------------
# manager: fleet view in dynconfig
# ---------------------------------------------------------------------------


def _manager_service(m, tmp_path, kv):
    db = m.database.Database(tmp_path / f"{m.name}.db")
    service = m.mservice.ManagerService(
        db, m.registry.ModelRegistry(db, m.objectstorage.FSObjectStorage(tmp_path / f"o-{m.name}")), fleet_kv=kv
    )
    for i in (1, 2):
        service.UpdateScheduler(
            manager_pb2.UpdateSchedulerRequest(hostname=f"s{i}", ip=f"10.0.0.{i}", port=8000 + i), None,
        )
    return db, service


@both
def test_manager_list_schedulers_scopes_to_live_leases(m, tmp_path):
    kv = m.kv.KVStore()
    db, service = _manager_service(m, tmp_path, kv)
    req = manager_pb2.ListSchedulersRequest()
    # no leases at all → keepalive registry stands alone
    assert len(service.ListSchedulers(req, None).schedulers) == 2

    # only s1 holds a live lease → dynconfig scopes to it
    m.fleet.write_lease(kv, "10.0.0.1:8001", 30.0)
    live = service.ListSchedulers(req, None).schedulers
    assert [s.hostname for s in live] == ["s1"]

    # a lease for an unknown member must not blank the list
    kv.flushall()
    m.fleet.write_lease(kv, "10.9.9.9:1", 30.0)
    assert len(service.ListSchedulers(req, None).schedulers) == 2
    db.close()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("store", sorted(PKGS))
def test_members_ring_and_epoch_agree_across_packages(store):
    """A port member and a reference member on one store read the same
    members, pick the same owner for 1,000 task ids, settle on the same
    epoch after a join and after a leave, and refuse a third member's
    tasks with the same WRONG_SHARD text."""
    kv = PKGS[store].kv.KVStore()
    cfg = dict(lease_ttl=30.0, grace_s=0.0)
    tm = t_fleet.FleetMembership(kv, "127.0.0.1:1", t_fleet.FleetConfig(**cfg))
    jm = j_fleet.FleetMembership(kv, "127.0.0.1:2", j_fleet.FleetConfig(**cfg))

    def settle():
        # one reconcile applies the change (and bumps the shared epoch);
        # a quiet one after it converges on the settled value
        for _ in range(2):
            tm.reconcile()
            jm.reconcile()

    tm._renew_once()
    jm._renew_once()
    settle()
    members = t_fleet.read_members(kv)
    assert members == j_fleet.read_members(kv) == ["127.0.0.1:1", "127.0.0.1:2"]
    assert tm.members() == jm.members() == members
    assert tm.epoch() == jm.epoch() == int(kv.get(t_fleet.FLEET_EPOCH_KEY)) > 0
    ids = [f"task-{i}" for i in range(1000)]
    owners = [tm.owner_of(t) for t in ids]
    assert owners == [jm.owner_of(t) for t in ids]
    assert set(owners) == set(members)

    # a third member joins (a bare lease): both refuse its tasks alike
    t_fleet.write_lease(kv, "127.0.0.1:3", 30.0)
    settle()
    assert tm.epoch() == jm.epoch() == int(kv.get(j_fleet.FLEET_EPOCH_KEY))
    assert tm.epoch_floor() == jm.epoch_floor()
    third = next(t for t in ids if tm.owner_of(t) == "127.0.0.1:3")
    assert jm.owner_of(third) == "127.0.0.1:3"
    with pytest.raises(t_fleet.WrongShardError) as t_exc:
        tm.check_owner(third)
    with pytest.raises(j_fleet.WrongShardError) as j_exc:
        jm.check_owner(third)
    assert str(t_exc.value) == str(j_exc.value)
    assert t_fleet.parse_wrong_shard(str(j_exc.value)) == j_fleet.parse_wrong_shard(str(t_exc.value))
    assert [tm.owner_of(t) for t in ids] == [jm.owner_of(t) for t in ids]

    # the reference member leaves: both views and the epoch follow
    jm.leave()
    assert t_fleet.read_members(kv) == j_fleet.read_members(kv) == ["127.0.0.1:1", "127.0.0.1:3"]
    epoch_before = tm.epoch()
    for _ in range(2):
        tm.reconcile()
    assert tm.epoch() > epoch_before and tm.epoch() == int(kv.get(t_fleet.FLEET_EPOCH_KEY))
    assert tm.members() == ["127.0.0.1:1", "127.0.0.1:3"]
    tm.leave()


def test_fleet_metrics_flight_and_fault_points_match_the_reference():
    """The port declares the reference's fleet series, flight events and
    fault points under the same names."""
    for name in ("MEMBERS_GAUGE", "REBALANCE_TOTAL", "WRONG_SHARD_TOTAL", "FLEET_TRANSITIONS_TOTAL",
                 "FAILOVER_RESUME_TOTAL", "BLACKOUT_MS"):
        t, j = getattr(t_fleet, name), getattr(j_fleet, name)
        assert (t.name, t.help, tuple(t.label_names)) == (j.name, j.help, tuple(j.label_names)), name
    for name in ("EV_MEMBER_JOIN", "EV_MEMBER_LEAVE", "EV_REBALANCE", "EV_WRONG_SHARD", "EV_FLEET_JOIN",
                 "EV_FLEET_LEAVE", "EV_FLEET_RECONCILE"):
        assert getattr(t_fleet, name).name == getattr(j_fleet, name).name, name
    assert t_fleet.FP_LEASE_RENEW.name == j_fleet.FP_LEASE_RENEW.name == "fleet.lease_renew"
    assert t_fleet.FP_MEMBERSHIP_READ.name == j_fleet.FP_MEMBERSHIP_READ.name == "fleet.membership_read"
    assert (t_fleet.FLEET_INDEX_KEY, t_fleet.FLEET_EPOCH_KEY) == (j_fleet.FLEET_INDEX_KEY, j_fleet.FLEET_EPOCH_KEY)
    assert t_kv.make_fleet_member_key("a:1") == j_kv.make_fleet_member_key("a:1")
    t_cfg, j_cfg = t_fleet.FleetConfig(), j_fleet.FleetConfig()
    assert vars(t_cfg) == vars(j_cfg)


def test_manager_fleet_view_answers_alike(tmp_path):
    """Both managers' ``ListSchedulers`` over one lease plane: no leases,
    a live subset, and leases that match no row."""
    kv = t_kv.KVStore()
    services = {name: _manager_service(PKGS[name], tmp_path, kv) for name in PKGS}
    req = manager_pb2.ListSchedulersRequest()

    def answers():
        got = {name: service.ListSchedulers(req, None).SerializeToString() for name, (_, service) in services.items()}
        assert got["torch"] == got["jax"]
        return [s.hostname for s in manager_pb2.ListSchedulersResponse.FromString(got["torch"]).schedulers]

    assert answers() == ["s1", "s2"]
    t_fleet.write_lease(kv, "10.0.0.2:8002", 30.0)
    assert answers() == ["s2"]
    kv.flushall()
    j_fleet.write_lease(kv, "10.9.9.9:1", 30.0)
    assert answers() == ["s1", "s2"]
    for db, _ in services.values():
        db.close()


def test_port_fleet_assembles_through_the_port_manager(tmp_path):
    """The port's ``ManagerServer(kv_port=0)`` embeds its RESP store; two
    port ``SchedulerServer(fleet_enabled=True, device="cpu")`` join the
    fleet there and register with it; a port ``Daemon`` with only the
    manager's and the KV's addresses finds both, follows the leases, and
    a download flows. ``ListSchedulers`` scopes to the live leases."""
    from dragonfly2_torch.manager.server import ManagerServer, ManagerServerConfig

    mgr = ManagerServer(ManagerServerConfig(data_dir=str(tmp_path / "m"), issue_certs=False, kv_port=0))
    mgr_addr = mgr.serve()
    scheds, d, channel = [], None, None
    try:
        assert mgr.kv_addr is not None and mgr.service.fleet_kv is mgr._kv.store
        for i in range(2):
            s = t_server.SchedulerServer(t_server.SchedulerServerConfig(
                data_dir=str(tmp_path / f"sched-{i}"), hostname=f"sched-{i}", device="cpu",
                manager_address=mgr_addr, kv_address=mgr.kv_addr, fleet_enabled=True,
                fleet_lease_ttl=1.0, fleet_renew_interval=0.3, fleet_poll_interval=0.2,
                topology_backend="off", storage_buffer_size=1, telemetry_interval=0.0,
                model_refresh_interval=3600.0, job_poll_interval=3600.0,
            ))
            scheds.append((s, s.serve()))
        addrs = sorted(a for _, a in scheds)
        assert t_fleet.read_members(mgr._kv.store) == addrs
        channel = t_glue.dial(mgr_addr)
        ops = t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE)
        listed = ops.ListSchedulers(manager_pb2.ListSchedulersRequest(ip="127.0.0.1"))
        assert sorted(f"{s.ip}:{s.port}" for s in listed.schedulers) == addrs

        d = t_daemon.Daemon(t_daemon.DaemonConfig(
            data_dir=str(tmp_path / "daemon"), scheduler_address="", manager_address=mgr_addr,
            kv_address=mgr.kv_addr, fleet_poll_interval=0.2, hostname="fleet-host", piece_length=PIECE,
            announce_interval=60.0, schedule_timeout=8.0,
        ))
        d.start()
        assert sorted(d._selector.addresses) == addrs
        payload = os.urandom(3 * PIECE)
        origin = tmp_path / "o.bin"
        origin.write_bytes(payload)
        url = f"file://{origin}"
        out = tmp_path / "out.bin"
        t_dfget.download(f"127.0.0.1:{d.port}", url, str(out))
        assert out.read_bytes() == payload
        task_id = t_idgen.task_id_v1(url, t_idgen.URLMeta())
        owner = scheds[0][0].fleet.owner_of(task_id)
        holders = [a for s, a in scheds if s.resource.task_manager.load(task_id) is not None]
        assert holders == [owner]

        # one member stops: its lease goes at once, the manager's view follows
        s0, a0 = scheds.pop(0)
        s0.stop()
        assert t_fleet.read_members(mgr._kv.store) == [scheds[0][1]]
        listed = ops.ListSchedulers(manager_pb2.ListSchedulersRequest(ip="127.0.0.1"))
        assert [f"{s.ip}:{s.port}" for s in listed.schedulers] == [scheds[0][1]]
    finally:
        if d is not None:
            d.stop()
        if channel is not None:
            channel.close()
        for s, _ in scheds:
            s.stop()
        mgr.stop()
