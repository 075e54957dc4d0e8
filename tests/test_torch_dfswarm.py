"""The port's ``tools/dfswarm.py`` against the reference's.

- Both packages' swarm observatories take the same event sequence (one
  scripted clock for the piece rates): ``render`` and ``render_task`` give
  the same text, the empty frame and a hand-built torn cycle included
  (the cases of ``tests/test_swarm_observatory.py:353-390``).
- ``diff_replicas`` gives equal dicts on the same pair of payloads (clean,
  missing, torn, orphaned, moved, extra, a broken conservation identity,
  empty), and ``render_diff`` the same text.
- ``run_diff`` reads a receipt and a replica from the port's ``KVServer``
  over RESP and prints what the reference's prints, with the same exit
  code; ``main --once`` reads a port scheduler's ``/debug/swarm``.
"""

import copy
import json
from types import SimpleNamespace

import pytest

from dragonfly2_torch.scheduler import swarm as t_swarm
from dragonfly2_torch.tools import dfswarm as t_dfswarm
from dragonfly2_torch.utils import kvstore as t_kv
from dragonfly2_torch.utils.kvserver import KVServer
from dragonfly2_torch.utils.metrics import MetricsServer, Registry
from dragonfly2_tpu.scheduler import swarm as j_swarm
from dragonfly2_tpu.tools import dfswarm as j_dfswarm

PKGS = {"torch": (t_swarm, t_dfswarm), "jax": (j_swarm, j_dfswarm)}


@pytest.fixture(autouse=True)
def clean_swarm():
    for swarm, _ in PKGS.values():
        swarm.reset()
    yield
    for swarm, _ in PKGS.values():
        swarm.reset()


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def monotonic(self):
        return self.t


def _tree(swarm, clock):
    """A seed, a child under it, a grandchild, a back-to-source peer, a
    rescheduled one, and a second task."""
    swarm.on_peer("t1", "seed", seed=True, total_pieces=8)
    swarm.on_piece("t1", "seed", 8, 8)
    swarm.on_state("t1", "seed", "Succeeded")
    for p in ("child", "grandchild", "b2s", "moved"):
        swarm.on_peer("t1", p)
        swarm.on_state("t1", p, "Running")
    swarm.on_primary_parent("t1", "child", "seed")
    swarm.on_primary_parent("t1", "grandchild", "child")
    swarm.on_primary_parent("t1", "moved", "seed")
    clock.t += 2.0
    swarm.on_piece("t1", "child", 4, 8)
    swarm.on_piece("t1", "grandchild", 1, 8)
    swarm.on_state("t1", "b2s", "BackToSource")
    swarm.on_reschedule("t1", "moved")
    swarm.on_peer("t2-a-much-longer-task-id-than-the-column-allows-for", "peer-with-a-long-identifier-0123456789")


def _stragglers(swarm, clock):
    """Three fast Running peers and one slow one over one rate window
    (``tests/test_swarm_observatory.py``'s ``_rated_swarm``), then a
    stuck peer."""
    swarm.configure(rate_window_s=0.05, straggler_min_peers=3, cooldown_s=0.0, stuck_after_s=30.0)
    for p in ("f1", "f2", "f3", "slow", "stuck"):
        swarm.on_peer("t1", p, total_pieces=100)
        swarm.on_state("t1", p, "Running")
    clock.t += 0.075
    for p in ("f1", "f2", "f3"):
        swarm.on_piece("t1", p, 50, 100)
    swarm.on_piece("t1", "slow", 1, 100)
    clock.t += 31.0
    for p in ("f1", "f2", "f3"):
        swarm.on_piece("t1", p, 90, 100)
    swarm.on_piece("t1", "slow", 2, 100)


SCENARIOS = {"empty": lambda swarm, clock: None, "tree": _tree, "stragglers": _stragglers}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_render_matches_the_reference(monkeypatch, scenario):
    frames = {}
    for name, (swarm, dfswarm) in PKGS.items():
        clock = _Clock()
        monkeypatch.setattr(swarm, "time", SimpleNamespace(monotonic=clock.monotonic, time=clock.monotonic))
        SCENARIOS[scenario](swarm, clock)
        snap = swarm.snapshot()
        frames[name] = (dfswarm.render(snap), {tid: dfswarm.render_task(tid, v) for tid, v in snap["tasks"].items()})
    assert frames["torch"] == frames["jax"]
    out, tasks = frames["torch"]
    if scenario == "empty":
        assert out == "dfswarm: no tasks tracked\n" and tasks == {}
    elif scenario == "tree":
        assert "└─ child" in out and "    └─ grandchild" in out and "[seed]" in out
        assert "b2s=1" in out and "resched=1" in out and "tasks=2" in out.splitlines()[-1]
    else:
        assert "[STRAGGLER]" in out and "[STRAGGLER,STUCK]" in out


def test_render_task_survives_a_torn_cycle_alike():
    view = {
        "peer_count": 2, "edges": 2, "roots": 0, "coverage": 0.0,
        "done_pieces": 0, "total_pieces": 0, "back_to_source": 0,
        "reschedules": 0, "consistent": False,
        "peers": {
            "a": {"state": "Running", "parent": "b", "pieces": 0},
            "b": {"state": "Running", "parent": "a", "pieces": 0},
        },
    }
    out = t_dfswarm.render_task("t-cycle", view)
    assert out == j_dfswarm.render_task("t-cycle", view)
    assert "!INCONSISTENT" in out and "(cycle)" in out


def _payload(peers: dict, edges=None) -> dict:
    roots = sum(1 for p in peers.values() if p.get("parent") is None)
    return {"obs": {"peers": peers, "edges": len(peers) - roots if edges is None else edges}}


OLD = _payload({
    "seed": {"state": "Succeeded", "pieces": 4, "parent": None},
    "c1": {"state": "Running", "pieces": 2, "parent": "seed"},
    "c2": {"state": "Running", "pieces": 1, "parent": "c1"},
    "c3": {"state": "Running", "pieces": 3, "parent": "seed"},
})


def _edit(fn):
    new = copy.deepcopy(OLD)
    fn(new["obs"]["peers"])
    roots = sum(1 for p in new["obs"]["peers"].values() if p.get("parent") is None)
    new["obs"]["edges"] = len(new["obs"]["peers"]) - roots
    return new


DIFFS = {
    "clean": (OLD, _edit(lambda p: p["c1"].update(pieces=3))),
    "missing": (OLD, _edit(lambda p: p.pop("c2"))),
    "torn_pieces": (OLD, _edit(lambda p: p["c3"].update(pieces=1))),
    "torn_pending": (OLD, _edit(lambda p: p["c1"].update(state="Pending"))),
    "orphaned": (OLD, _edit(lambda p: p["c2"].update(parent=None))),
    "moved": (OLD, _edit(lambda p: p["c2"].update(parent="seed"))),
    "extra": (OLD, _edit(lambda p: p.update(c4={"state": "Pending", "pieces": 0, "parent": None}))),
    "not_conserved": (OLD, dict(OLD, obs=dict(OLD["obs"], edges=7))),
    "empty": ({}, {}),
    "gone": (OLD, {}),
}


@pytest.mark.parametrize("case", sorted(DIFFS))
def test_diff_replicas_matches_the_reference(case):
    old, new = DIFFS[case]
    got = t_dfswarm.diff_replicas(old, new)
    assert got == j_dfswarm.diff_replicas(old, new)
    # an empty successor payload breaks the identity (edges -1): never clean
    assert got["clean"] == (case in ("clean", "moved", "extra"))
    receipt = {"victim": "127.0.0.1:1", "adopted_by": "127.0.0.1:2", "epoch": 3, "seq": 9,
               "adopt_ms": 1.5, "outcome": "adopted", "payload": old}
    text = t_dfswarm.render_diff("task-1", receipt, "127.0.0.1:2", got)
    assert text == j_dfswarm.render_diff("task-1", receipt, "127.0.0.1:2", got)
    assert text.rstrip().endswith("CLEAN" if got["clean"] else "TORN")


@pytest.fixture
def kv_server():
    server = KVServer()
    port = server.serve()
    kv = t_kv.RemoteKVStore(f"127.0.0.1:{port}")
    yield f"127.0.0.1:{port}", kv
    kv.close()
    server.stop()


def _journal(kv, task_id, receipt_payload, current, owner="127.0.0.1:2"):
    receipt = {"victim": "127.0.0.1:1", "adopted_by": owner, "epoch": 4, "seq": 2, "adopt_ms": 0.8,
               "outcome": "adopted", "payload": receipt_payload}
    kv.set(t_kv.make_swarm_adopt_key(task_id), json.dumps(receipt))
    kv.hset(t_kv.make_swarm_replica_key(task_id), {"owner": owner, "data": json.dumps(current), "epoch": "4"})
    kv.hset(t_kv.SWARM_REPLICA_INDEX_KEY, {task_id: json.dumps({"owner": owner})})


def test_run_diff_reads_the_port_kv_as_the_reference_does(kv_server, capsys):
    addr, kv = kv_server
    _journal(kv, "task-clean", OLD, DIFFS["moved"][1])
    got = {}
    for name, (_, dfswarm) in PKGS.items():
        rc = dfswarm.run_diff(addr, "task-clean")
        got[name] = (rc, capsys.readouterr())
    assert got["torch"] == got["jax"]
    rc, cap = got["torch"]
    assert rc == 0 and "verdict: CLEAN" in cap.out and "replica now owned by 127.0.0.1:2" in cap.out

    # every receipt in the index: one torn adoption fails the whole diff
    _journal(kv, "task-torn", OLD, DIFFS["torn_pieces"][1])
    for name, (_, dfswarm) in PKGS.items():
        got[name] = (dfswarm.main(["--diff", "--kv", addr]), capsys.readouterr())
    assert got["torch"] == got["jax"]
    rc, cap = got["torch"]
    assert rc == 1 and cap.out.count("verdict:") == 2 and "verdict: TORN" in cap.out

    # no receipt for the task asked for
    for name, (_, dfswarm) in PKGS.items():
        got[name] = (dfswarm.run_diff(addr, "task-unknown"), capsys.readouterr())
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 1 and "no adoption receipt for task-unknown" in got["torch"][1].err


def test_diff_needs_the_kv():
    with pytest.raises(SystemExit):
        t_dfswarm.main(["--diff"])
    with pytest.raises(SystemExit):
        t_dfswarm.main([])


def test_main_once_reads_a_port_scheduler_debug_swarm(capsys):
    server = MetricsServer(Registry())
    server.start()
    try:
        t_swarm.on_peer("t1", "seed", seed=True, total_pieces=4)
        t_swarm.on_peer("t1", "child")
        t_swarm.on_primary_parent("t1", "child", "seed")
        t_swarm.on_piece("t1", "child", 2, 4)
        addr = f"127.0.0.1:{server.port}"
        assert t_dfswarm.fetch(addr)["task_count"] == 1
        assert t_dfswarm.fetch(addr, task="t1")["tasks"].keys() == {"t1"}
        assert t_dfswarm.main(["--scheduler", addr, "--once"]) == 0
        out = capsys.readouterr().out
        assert out == t_dfswarm.render(t_swarm.snapshot())
        assert "└─ child" in out and "coverage=0.50" in out
    finally:
        server.stop()
    assert t_dfswarm.main(["--scheduler", addr, "--once"]) == 1
    assert "unreachable" in capsys.readouterr().err
