"""A late peer after its task's owner dies, in both packages.

Each package's drill kit (``tools/stress``: ``_spawn_scheduler``,
``_drill_announce``, ``_wait_fresh_renewal``) drives that package's
scheduler binaries: 3 schedulers on one KV server under leases, with swarm
replication. On the task's ring owner a seed is sent back to source and
children take their first decision, and none of them has a piece on record
when the owner is SIGKILLed (the state a burst is in right after it
starts). Once the owner's replica holds them all at the settled epoch, the
owner dies; then the children re-register with the ring successor under
their own ids, and a late child registers there for the first time.

The packages decide alike at every step, and both outcomes are pinned. A
peer that took its decision and never reported a start (``ReceivedNormal``)
is a bad node to the candidate filter in both packages; a seed that
reported its back-to-source start is a candidate with no piece yet. So:

- the seed started: the successor adopts the swarm, the children resume
  with the seed as parent, and the late child is scheduled the seed;
- the seed not started: every peer of the adopted swarm is a bad node, and
  the children and the late child are all sent to the origin, in both
  packages. This is the gap a burst killed at its start leaves (the fleet
  leg of ``chip_smoke.py`` kills only once a peer of the replica is fed)."""

import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest
import torch

from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.rpc import protos as t_protos
from dragonfly2_torch.scheduler import fleet as t_fleet
from dragonfly2_torch.tools import stress as t_stress
from dragonfly2_torch.utils import kvstore as t_kv
from dragonfly2_torch.utils.kvserver import KVServer as TKVServer
from dragonfly2_tpu.rpc import gen  # noqa: F401
from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.scheduler import fleet as j_fleet
from dragonfly2_tpu.tools import stress as j_stress
from dragonfly2_tpu.utils import kvstore as j_kv
from dragonfly2_tpu.utils.kvserver import KVServer as JKVServer

torch.set_num_threads(1)

PKGS = {
    "torch": SimpleNamespace(name="torch", glue=t_glue, fleet=t_fleet, stress=t_stress, kv=t_kv, KVServer=TKVServer,
                             pb2=lambda: t_protos.load("scheduler_pb2"), spawn_kw={"device": "cpu"}),
    "jax": SimpleNamespace(name="jax", glue=j_glue, fleet=j_fleet, stress=j_stress, kv=j_kv, KVServer=JKVServer,
                           pb2=lambda: __import__("scheduler_pb2"), spawn_kw={}),
}
CHILDREN = 3
# a lease that a loaded host cannot let lapse by accident: a lapse bumps
# the fleet epoch past the replica's, and the adoption turns stale
LEASE_TTL, RENEW, POLL = 3.0, 0.5, 0.3


def _kind(first) -> str:
    return first.WhichOneof("response")


def _parents(first) -> "list[str]":
    return sorted(p.peer_id for p in first.normal_task.candidate_parents) if _kind(first) == "normal_task" else []


def _drill(m, seed_started: bool) -> dict:
    """One late-peer drill on package ``m``; → what each peer was decided.
    ``seed_started``: the seed reports its back-to-source start."""
    tmp = tempfile.mkdtemp(prefix=f"dflate-{m.name}-")
    kv_server = m.KVServer()
    kv_addr = f"127.0.0.1:{kv_server.serve()}"
    procs, streams, sel, kv = [], [], None, None
    try:
        for i in range(3):
            proc, addr = m.stress._spawn_scheduler(os.path.join(tmp, f"sched-{i}"), kv_addr, LEASE_TTL, RENEW, POLL,
                                                   **m.spawn_kw)
            procs.append((proc, addr))
        addrs = [a for _, a in procs]
        kv = m.kv.RemoteKVStore(kv_addr)
        deadline = time.monotonic() + 30.0
        while set(m.fleet.read_members(kv)) != set(addrs):
            assert time.monotonic() < deadline, "the fleet never formed"
            time.sleep(0.05)
        # every member reconciles the last join within a poll: wait for the
        # generation to hold still for several polls, so no member's view
        # (the adoption floor among them) moves after the replica is stamped
        epoch, still = kv.get(m.fleet.FLEET_EPOCH_KEY), time.monotonic()
        while time.monotonic() - still < 6 * POLL:
            assert time.monotonic() < deadline, "the fleet's epoch never settled"
            time.sleep(0.05)
            now = kv.get(m.fleet.FLEET_EPOCH_KEY)
            if now != epoch:
                epoch, still = now, time.monotonic()
        sel = m.glue.SchedulerSelector(addrs)
        task = next(t for t in (f"late-drill-{i}" for i in range(10_000)) if sel.addr_for_task(t) == addrs[0])
        url = f"http://origin/{task}"
        victim = next(p for p, a in procs if a == addrs[0])
        successor = m.glue.ConsistentHashRing(addrs).successors(task)[1]
        client = sel.client_for(addrs[0])
        pb2 = m.pb2()

        # the seed: sent back to source, no piece reported
        q, responses, first = m.stress._drill_announce(client, task, url, "h-seed", "p-seed",
                                                       need_back_to_source=True)
        streams.append((q, responses))
        out = {"seed": _kind(first)}
        if seed_started:
            q.put(pb2.AnnouncePeerRequest(
                host_id="h-seed", task_id=task, peer_id="p-seed",
                download_peer_back_to_source_started=pb2.DownloadPeerBackToSourceStartedRequest()))
        # the children: their first decision, nothing after it
        out["children"] = []
        for c in range(CHILDREN):
            q, responses, first = m.stress._drill_announce(client, task, url, f"h-c{c}", f"p-c{c}")
            streams.append((q, responses))
            out["children"].append((_kind(first), _parents(first)))

        # the owner's replica holds every peer at the settled epoch, still
        # so just after a lease renewal (the kill leaves a full lease)
        want = {"p-seed"} | {f"p-c{c}" for c in range(CHILDREN)}
        key = m.kv.make_swarm_replica_key(task)
        deadline = time.monotonic() + 15.0
        while True:
            assert time.monotonic() < deadline, "no replica of the swarm at the settled epoch"
            m.stress._wait_fresh_renewal(kv, addrs[0])
            epoch, data = kv.hmget(key, ["epoch", "data"])
            if data:
                peers = json.loads(data)["obs"]["peers"]
                if int(epoch or 0) >= int(kv.get(m.fleet.FLEET_EPOCH_KEY) or 0) and want <= set(peers):
                    break
            time.sleep(0.05)
        out["replica"] = {p: (v["state"], v["pieces"]) for p, v in sorted(peers.items())}
        victim.kill()
        for handle in streams:
            m.stress._drill_close(handle)
        streams = []

        def first_decision(host, peer):
            """Register through the ring until a live owner answers."""
            avoid: set = set()
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                try:
                    addr, cl = sel.resolve_for_task(task, avoid=avoid)
                    q, responses, first = m.stress._drill_announce(cl, task, url, host, peer, timeout=15.0)
                except Exception as e:
                    if m.fleet.parse_wrong_shard(str(e)) is not None:
                        sel.refresh_membership()
                    else:
                        avoid.add(addr)
                    time.sleep(0.05)
                    continue
                streams.append((q, responses))
                return addr, _kind(first), _parents(first)
            raise AssertionError(f"{peer} found no live owner")

        out["resumed"] = []
        for c in range(CHILDREN):
            addr, kind, parents = first_decision(f"h-c{c}", f"p-c{c}")
            out["resumed"].append((kind, parents))
        addr, kind, parents = first_decision("h-late", "p-late")
        out["late"] = (kind, parents)
        out["late_at_successor"] = addr == successor
        receipt = json.loads(kv.get(m.kv.make_swarm_adopt_key(task)) or "{}")
        out["adopt"] = (receipt.get("outcome"), receipt.get("victim") == addrs[0])
        return out
    finally:
        for handle in streams:
            m.stress._drill_close(handle)
        if sel is not None:
            sel.close()
        if kv is not None:
            kv.close()
        for proc, _ in procs:
            proc.kill()
            proc.wait(timeout=10)
        kv_server.stop()
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def drills():
    runs = [(name, started) for name in PKGS for started in (True, False)]
    with ThreadPoolExecutor(2) as pool:
        futures = {run: pool.submit(_drill, PKGS[run[0]], run[1]) for run in runs}
        return {run: f.result() for run, f in futures.items()}


@pytest.mark.parametrize("started", [True, False], ids=["seed_started", "seed_not_started"])
def test_both_packages_decide_the_late_peer_alike(drills, started):
    assert drills[("torch", started)] == drills[("jax", started)]


def test_the_late_peer_is_scheduled_a_seed_going_back_to_source(drills):
    got = drills[("torch", True)]
    assert got["seed"] == "need_back_to_source"
    # before the kill: each child is scheduled the seed, and nothing is on record
    assert got["children"] == [("normal_task", ["p-seed"])] * CHILDREN
    assert got["replica"] == {"p-seed": ("BackToSource", 0), **{f"p-c{c}": ("ReceivedNormal", 0)
                                                                for c in range(CHILDREN)}}
    # after it: the successor adopted the swarm; the children resume with
    # the seed and the late child is scheduled it too, not the origin
    assert got["adopt"] == ("adopted", True)
    assert got["resumed"] == [("normal_task", ["p-seed"])] * CHILDREN
    assert got["late"] == ("normal_task", ["p-seed"])
    assert got["late_at_successor"]


def test_the_late_peer_goes_to_the_origin_when_no_peer_has_started(drills):
    got = drills[("torch", False)]
    assert got["seed"] == "need_back_to_source"
    # the seed is a bad node before it starts: every child goes to the origin
    assert got["children"] == [("need_back_to_source", [])] * CHILDREN
    assert got["replica"] == {p: ("ReceivedNormal", 0) for p in ["p-c0", "p-c1", "p-c2", "p-seed"]}
    assert got["adopt"] == ("adopted", True)
    assert got["resumed"] == [("need_back_to_source", [])] * CHILDREN
    assert got["late"] == ("need_back_to_source", [])
    assert got["late_at_successor"]
