"""The port's dynconfig (``utils/dynconfig.py``) and the daemon's use of it,
against the reference's.

- The engine: one scripted run of fetches — values, repeats, failures —
  through both ``Dynconfig``s gives the same answers, the same observer
  calls and the same disk cache; the background loop and ``fetch_once``
  behave alike.
- ``SchedulerDynconfig`` and ``DaemonDynconfig`` of each package against
  each package's manager (the port's ``ManagerServer``, the reference's
  ``ManagerService``) give the same limits and scheduler lists, the
  latter scoped by the searcher; with the manager down, a fresh
  ``DaemonDynconfig`` boots from the disk cache.
- The port's daemon (``tests/test_daemon_dynconfig.py`` on the port):
  with ``manager_address`` and no static ``scheduler_address`` it finds
  its scheduler through the port's ``ManagerServer``, follows a second
  scheduler joining, fails loudly when the manager has none, pushes its
  telemetry to the manager's plane, and a seed peer registers with
  ``UpdateSeedPeer`` while a normal daemon does not."""

import json
import time

import pytest
import torch

from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_torch.manager import server as t_mserver
from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.rpc import resilience
from dragonfly2_torch.scheduler import resource as res
from dragonfly2_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
from dragonfly2_torch.scheduler.service import SERVICE_NAME as SCHED_SERVICE
from dragonfly2_torch.scheduler.service import SchedulerService
from dragonfly2_torch.utils import dynconfig as t_dyn
from dragonfly2_tpu.manager.database import Database
from dragonfly2_tpu.manager.models_registry import ModelRegistry
from dragonfly2_tpu.manager.objectstorage import FSObjectStorage
from dragonfly2_tpu.manager.service import ManagerService
from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.utils import dynconfig as j_dyn

torch.set_num_threads(1)

mp = protos.load("manager_pb2")


@pytest.fixture(autouse=True)
def _fresh_breakers():
    """A dead manager's target opens its circuit breaker; a later test's
    manager may be given the same ephemeral port."""
    resilience.reset()
    yield
    resilience.reset()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _engine_run(mod, cache):
    script = iter([{"a": 1}, {"a": 1}, ConnectionError("down"), {"a": 2, "b": [1, 2]}, ConnectionError("down")])

    def fetch():
        item = next(script)
        if isinstance(item, Exception):
            raise item
        return item

    seen = []
    dc = mod.Dynconfig(fetch, cache_path=cache, refresh_interval=0.0)
    dc.register(seen.append)  # nothing yet: no call
    answers = [dc.get(), dc.refresh(), dc.get(), dc.get(), json.loads(cache.read_text()), dc.get()]
    late = []
    dc.register(late.append)  # delivered at once
    # a fresh process with a dead manager boots from the disk cache; one
    # with no cache at all gets {}
    dead = mod.Dynconfig(lambda: (_ for _ in ()).throw(ConnectionError("down")), cache_path=cache,
                         refresh_interval=0.0)
    empty = mod.Dynconfig(lambda: (_ for _ in ()).throw(ConnectionError("down")),
                          cache_path=cache.with_name("none.json"), refresh_interval=0.0)
    with pytest.raises(ConnectionError):
        dead.fetch_once()
    return answers, seen, late, dead.get(), empty.get()


def test_the_engine_answers_alike(tmp_path):
    got = _engine_run(t_dyn, tmp_path / "t.json")
    assert got == _engine_run(j_dyn, tmp_path / "j.json")
    assert got[0] == [{"a": 1}, {"a": 1}, {"a": 1}, {"a": 2, "b": [1, 2]}, {"a": 2, "b": [1, 2]},
                      {"a": 2, "b": [1, 2]}]
    assert got[1] == [{"a": 1}, {"a": 2, "b": [1, 2]}] and got[3] == {"a": 2, "b": [1, 2]} and got[4] == {}


def test_the_engine_caches_within_its_interval_and_loops():
    for mod in (t_dyn, j_dyn):
        calls = []
        dc = mod.Dynconfig(lambda: calls.append(1) or {"v": len(calls)}, refresh_interval=60.0)
        assert dc.get() == dc.get() == {"v": 1} and len(calls) == 1
        calls.clear()
        dc = mod.Dynconfig(lambda: calls.append(1) or {"n": len(calls)}, refresh_interval=0.05)
        dc.start()
        try:
            deadline = time.time() + 5
            while len(calls) < 3 and time.time() < deadline:
                time.sleep(0.02)
        finally:
            dc.stop()
        assert len(calls) >= 3


# ---------------------------------------------------------------------------
# the service wrappers against each manager
# ---------------------------------------------------------------------------


@pytest.fixture
def managers(tmp_path):
    """The port's ManagerServer and the reference's ManagerService, served,
    each holding a default cluster with a config, a second cluster scoped
    to idc-b and a scheduler in each → {name: (address, database)}."""
    port_mgr = t_mserver.ManagerServer(t_mserver.ManagerServerConfig(
        data_dir=str(tmp_path / "torch"), issue_certs=False))
    t_addr = port_mgr.serve()
    jdb = Database(tmp_path / "jax.db")
    jsvc = ManagerService(jdb, ModelRegistry(jdb, FSObjectStorage(tmp_path / "jax")))
    jserver, jport = j_glue.serve({j_glue.MANAGER_SERVICE: jsvc})
    out = {"torch": (t_addr, port_mgr.db), "jax": (f"127.0.0.1:{jport}", jdb)}
    for addr, db in out.values():
        now = time.time()
        db.execute("UPDATE scheduler_clusters SET config = ? WHERE id = 1",
                   (json.dumps({"candidate_parent_limit": 9, "filter_parent_limit": 33, "extra": "x"}),))
        db.execute("INSERT INTO scheduler_clusters (name, scopes, created_at, updated_at)"
                   " VALUES ('cluster-b', '{\"idc\": \"idc-b\"}', ?, ?)", (now, now))
        channel = t_glue.dial(addr)
        client = t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE)
        client.UpdateScheduler(mp.UpdateSchedulerRequest(hostname="s1", ip="10.0.0.1", port=7001))
        client.UpdateScheduler(mp.UpdateSchedulerRequest(hostname="s2", ip="10.0.0.2", port=7002,
                                                         scheduler_cluster_id=2))
        channel.close()
    yield out
    port_mgr.stop()
    jserver.stop(0)
    jdb.close()


@pytest.mark.parametrize("client_pkg", ["torch", "jax"])
def test_the_wrappers_read_each_manager_alike(managers, tmp_path, client_pkg):
    mod = t_dyn if client_pkg == "torch" else j_dyn
    got = {}
    for name, (addr, _) in managers.items():
        channel = t_glue.dial(addr)
        client = t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE)
        sched = mod.SchedulerDynconfig(client, cluster_id=1, refresh_interval=0.0)
        views = [(sched.candidate_parent_limit, sched.filter_parent_limit, sched.engine.get())]
        for kw in ({}, {"ip": "10.1.1.1", "idc": "idc-b"}, {"ip": "10.1.1.1", "location": "eu"}):
            daemon = mod.DaemonDynconfig(client, cache_path=tmp_path / f"{name}.json", refresh_interval=0.0, **kw)
            views.append(sorted(daemon.scheduler_addresses()))
        got[name] = views
        channel.close()
    assert got["torch"] == got["jax"]
    assert got["torch"] == [(9, 33, {"candidate_parent_limit": 9, "filter_parent_limit": 33, "extra": "x"}),
                            ["10.0.0.1:7001", "10.0.0.2:7002"], ["10.0.0.2:7002"], ["10.0.0.1:7001"]]


def test_the_disk_cache_outlives_the_manager(tmp_path):
    mgr = t_mserver.ManagerServer(t_mserver.ManagerServerConfig(data_dir=str(tmp_path / "m"), issue_certs=False))
    addr = mgr.serve()
    channel = t_glue.dial(addr)
    client = t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE)
    client.UpdateScheduler(mp.UpdateSchedulerRequest(hostname="s1", ip="10.0.0.1", port=7001))
    cache = tmp_path / "dynconfig.json"
    first = t_dyn.DaemonDynconfig(client, cache_path=cache, refresh_interval=0.0)
    assert first.scheduler_addresses() == ["10.0.0.1:7001"]
    mgr.stop()
    # the same process: the last value survives; a fresh one reads the disk
    assert first.scheduler_addresses() == ["10.0.0.1:7001"]
    fresh = t_dyn.DaemonDynconfig(client, cache_path=cache, refresh_interval=0.0)
    assert fresh.scheduler_addresses() == ["10.0.0.1:7001"]
    with pytest.raises(Exception):
        fresh.fetch_once()
    assert t_dyn.DaemonDynconfig.addresses_of({"schedulers": [{"ip": "", "port": 1}, {"ip": "a", "port": 0},
                                                              {"ip": "b", "port": 2}]}) == ["b:2"]
    channel.close()


# ---------------------------------------------------------------------------
# the port's daemon on the port's manager
# ---------------------------------------------------------------------------


def _scheduler_server():
    service = SchedulerService(res.Resource(), Scheduling(BaseEvaluator(), SchedulingConfig()))
    return t_glue.serve({SCHED_SERVICE: service})


@pytest.fixture
def manager(tmp_path):
    mgr = t_mserver.ManagerServer(t_mserver.ManagerServerConfig(data_dir=str(tmp_path / "manager"),
                                                                issue_certs=False))
    addr = mgr.serve()
    channel = t_glue.dial(addr)
    yield {"mgr": mgr, "addr": addr, "client": t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE)}
    channel.close()
    mgr.stop()


def _register(client, hostname, ip, port):
    client.UpdateScheduler(mp.UpdateSchedulerRequest(hostname=hostname, ip=ip, port=port))


def _daemon(tmp_path, name, addr, **kw):
    return Daemon(DaemonConfig(data_dir=str(tmp_path / name), scheduler_address="", manager_address=addr,
                               hostname=name, ip="127.0.0.1", announce_interval=60.0, **kw))


def test_the_daemon_discovers_its_schedulers_from_the_manager(manager, tmp_path):
    sched, sched_port = _scheduler_server()
    _register(manager["client"], "s1", "127.0.0.1", sched_port)
    d = _daemon(tmp_path, "dyn-host", manager["addr"], telemetry_interval=0.05)
    d.start()
    sched2 = None
    try:
        assert d._selector.addresses == [f"127.0.0.1:{sched_port}"]
        sched2, port2 = _scheduler_server()
        _register(manager["client"], "s2", "127.0.0.2", port2)
        d._dynconfig.engine.refresh()
        assert set(d._selector.addresses) == {f"127.0.0.1:{sched_port}", f"127.0.0.2:{port2}"}
        # the daemon pushes its telemetry over the manager channel it holds
        deadline = time.time() + 10
        while time.time() < deadline:
            with manager["mgr"].telemetry._lock:
                if ("daemon", f"127.0.0.1:{d.port}") in manager["mgr"].telemetry._reporters:
                    break
            time.sleep(0.05)
        snap = manager["mgr"].telemetry.snapshot()
        assert [s["instance"] for s in snap["services"] if s["service"] == "daemon"] == [f"127.0.0.1:{d.port}"]
        assert json.loads((tmp_path / "dyn-host" / "dynconfig.json").read_text())["schedulers"]
    finally:
        d.stop()
        sched.stop(grace=None)
        if sched2 is not None:
            sched2.stop(grace=None)


def test_the_daemon_requires_some_scheduler_source(manager, tmp_path):
    d = _daemon(tmp_path, "dyn-host2", manager["addr"])
    with pytest.raises(RuntimeError, match="no schedulers"):
        d.start()
    d.stop()


def test_a_seed_peer_registers_with_the_manager(manager, tmp_path):
    sched, sched_port = _scheduler_server()
    _register(manager["client"], "s1", "127.0.0.1", sched_port)
    seed = _daemon(tmp_path, "seed-host", manager["addr"], host_type="super")
    normal = _daemon(tmp_path, "normal-host", manager["addr"])
    seed.start()
    normal.start()
    try:
        rows = manager["mgr"].db.query("SELECT hostname, type, state, port, download_port FROM seed_peers")
        assert [(r["hostname"], r["type"], r["state"]) for r in rows] == [("seed-host", "super", "active")]
        assert (rows[0]["port"], rows[0]["download_port"]) == (seed.port, seed.upload.port)
        # re-registering is the keepalive, and it revives a silenced row
        manager["mgr"].db.execute("UPDATE seed_peers SET state = 'inactive'")
        seed._register_seed_peer()
        assert manager["mgr"].db.query("SELECT state FROM seed_peers")[0]["state"] == "active"
    finally:
        seed.stop()
        normal.stop()
        sched.stop(grace=None)


def test_the_selector_reconciles_dynconfig_updates():
    sel = t_glue.SchedulerSelector(["127.0.0.1:1", "127.0.0.1:2"])
    sel.update_addresses(["127.0.0.1:2", "127.0.0.1:3"])
    assert set(sel.addresses) == {"127.0.0.1:2", "127.0.0.1:3"}
    sel.update_addresses([])  # an empty push never strands the daemon
    assert set(sel.addresses) == {"127.0.0.1:2", "127.0.0.1:3"}
    for key in ("t1", "t2", "t3", "t4"):
        assert sel.addr_for_task(key) in sel.addresses
    sel.close()
