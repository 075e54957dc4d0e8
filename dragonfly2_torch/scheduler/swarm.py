# dfanalyze: hot — swarm accounting rides every FSM transition, piece
# report, and scheduling decision; keep each hook to one short lock
# hold with no Prometheus touch (series flush lazily at sync time).
"""Swarm observatory: live per-task swarm DAG introspection (counterpart
of the reference's ``scheduler/swarm.py``).

The scheduler's whole job is maintaining the swarm graph — which peer
feeds which, how deep the tree runs, how much of each task the swarm
collectively holds — yet none of that state was observable: it lived
in per-process ``Task``/``Peer`` objects and died with them. This
module keeps an incremental, serializable shadow of that graph, fed by
tiny hooks on the resource FSM, the piece-report path, and the
scheduling decision path:

- per-peer FSM state, PRIMARY parent and tree depth, finished-piece
  count, progress rate (rolling window), seed-ness;
- per-task piece coverage (monotone max over peers), back-to-source
  and reschedule churn counters;
- a straggler detector in the StallWatchdog spirit: a Running peer
  whose piece rate falls below ``straggler_factor ×`` the swarm median
  (given enough rated peers), or any non-terminal peer with no
  progress past ``stuck_after_s``, raises an edge-triggered,
  cooldown-limited ``scheduler.swarm_straggler`` /
  ``scheduler.swarm_stuck`` flight event.

The scheduler hands each child up to ``candidate_parent_limit``
parents; the observatory tracks only the FIRST ranked candidate — the
decision's primary parent — as the tree edge. That makes the
conservation identity ``edges == peers − roots`` real: ``edges`` is an
incrementally maintained counter while roots are counted by scanning
the peer map at snapshot time, so the identity cross-checks the two
accountings and catches torn updates (the ``stress.py --chaos`` gate).

Design mirrors utils/flows: one module lock, bounded state (task/peer
caps with drop counters), hot hooks that never touch a Prometheus
lock — the ``dragonfly_swarm_*`` series flush lazily in
``sync_series()`` via the registry's ``on_sync`` hook. The module
global survives an in-process scheduler restart (the chaos soak), and
every hook self-heals from bare ``(task_id, peer_id)`` keys, so a
rebuilt resource model re-populates the same ledger.
"""

from __future__ import annotations

import threading
import time

from dragonfly2_torch.utils import flight
from dragonfly2_torch.utils.metrics import default_registry as _r

SWARM_TASKS = _r.gauge("swarm_tasks", "Tasks tracked by the swarm observatory")
SWARM_PEERS = _r.gauge(
    "swarm_peers", "Peers tracked by the swarm observatory, by FSM state", ("state",)
)
SWARM_EDGES = _r.gauge(
    "swarm_edges", "Primary parent->child edges tracked across all swarms"
)
SWARM_STRAGGLERS = _r.gauge(
    "swarm_stragglers", "Peers currently flagged as stragglers"
)
SWARM_STUCK = _r.gauge(
    "swarm_stuck", "Peers currently flagged as stuck (no progress past deadline)"
)
SWARM_STRAGGLER_FLAGS_TOTAL = _r.counter(
    "swarm_straggler_flags_total", "Straggler flag raises (edge-triggered)"
)
SWARM_STUCK_FLAGS_TOTAL = _r.counter(
    "swarm_stuck_flags_total", "Stuck flag raises (edge-triggered)"
)
SWARM_RESCHEDULES_TOTAL = _r.counter(
    "swarm_reschedules_total", "Parent edges dropped by re-scheduling decisions"
)
SWARM_BACK_TO_SOURCE_TOTAL = _r.counter(
    "swarm_back_to_source_total", "Peer transitions into BackToSource"
)
SWARM_DROPPED_TOTAL = _r.counter(
    "swarm_dropped_total", "Observatory registrations dropped at caps", ("kind",)
)

# flight events: raised by the detector at sync/snapshot time, never on
# a hot hook — the StallWatchdog discipline (edge-triggered + cooldown)
EV_STRAGGLER = flight.event_type("scheduler.swarm_straggler")
EV_STUCK = flight.event_type("scheduler.swarm_stuck")

# peer FSM states the detector treats as finished-with (no progress
# expected, so never "stuck"); everything else is in flight
TERMINAL_STATES = frozenset(("Succeeded", "Failed", "Leave"))
RUNNING_STATE = "Running"
BACK_TO_SOURCE_STATE = "BackToSource"

_TASK_CAP = 2048
_PEER_CAP = 16384
_DEPTH_HIST_MAX = 8  # snapshot depth histogram folds deeper levels here

_DEFAULTS = {
    "straggler_factor": 0.4,  # rate < factor x swarm median -> straggler
    "straggler_min_peers": 3,  # median needs this many rated Running peers
    "rate_window_s": 2.0,  # per-peer piece-rate window
    "stuck_after_s": 30.0,  # no progress for this long -> stuck
    "cooldown_s": 10.0,  # min gap between flag events per peer
}


class _Config:
    __slots__ = tuple(_DEFAULTS)

    def __init__(self):
        for k, v in _DEFAULTS.items():
            setattr(self, k, v)


_cfg = _Config()


def configure(**kw) -> None:
    """Tune detector thresholds (tests, soaks). Unknown keys raise."""
    for k, v in kw.items():
        if k not in _DEFAULTS:
            raise ValueError(f"unknown swarm observatory option {k!r}")
        setattr(_cfg, k, type(_DEFAULTS[k])(v))


class _PeerView:
    __slots__ = (
        "state",
        "parent",
        "depth",
        "pieces",
        "seed",
        "created",
        "last_progress",
        "rate_t0",
        "rate_p0",
        "rate",
        "straggler",
        "stuck",
        "flag_cooldown_until",
    )

    def __init__(self, now: float, state: str, seed: bool):
        self.state = state
        self.parent: "str | None" = None
        self.depth = 0
        self.pieces = 0
        self.seed = seed
        self.created = now
        self.last_progress = now
        self.rate_t0 = now
        self.rate_p0 = 0
        self.rate: "float | None" = None
        self.straggler = False
        self.stuck = False
        self.flag_cooldown_until = 0.0


class _TaskView:
    __slots__ = (
        "peers",
        "total_pieces",
        "max_done",
        "edges",
        "back_to_source",
        "reschedules",
        "created",
    )

    def __init__(self, now: float, total_pieces: int):
        self.peers: dict[str, _PeerView] = {}
        self.total_pieces = total_pieces
        self.max_done = 0
        self.edges = 0  # incremental primary-edge counter (the invariant leg)
        self.back_to_source = 0
        self.reschedules = 0
        self.created = now


_lock = threading.Lock()
_tasks: dict[str, _TaskView] = {}
_peer_total = [0]  # across tasks, bounded by _PEER_CAP
# tasks mutated since the last drain_dirty() — the replication plane's
# work queue. A set, so a task churning between flushes coalesces to
# one write; adding under the already-held hook lock costs one hash.
_dirty: set[str] = set()
# monotone module totals (per-task counters die with their task view)
_totals = {"reschedules": 0, "back_to_source": 0, "straggler_flags": 0,
           "stuck_flags": 0, "dropped_tasks": 0, "dropped_peers": 0}
_synced = dict.fromkeys(_totals, 0)
_seen_states: set[str] = set()  # gauge children we must zero when empty


def _ensure(task_id: str, peer_id: "str | None", now: float, state: str = "Pending",
            seed: bool = False, total_pieces: int = 0):
    """Self-healing view lookup under the module lock: unknown keys are
    (re)created so a restarted scheduler's re-registrations repopulate
    the surviving ledger. Returns (task_view, peer_view|None) or
    (None, None) when a cap dropped the registration."""
    tv = _tasks.get(task_id)
    if tv is None:
        if len(_tasks) >= _TASK_CAP:
            _totals["dropped_tasks"] += 1
            return None, None
        tv = _tasks[task_id] = _TaskView(now, total_pieces)
    elif total_pieces and total_pieces > tv.total_pieces:
        tv.total_pieces = total_pieces
    _dirty.add(task_id)
    if peer_id is None:
        return tv, None
    pv = tv.peers.get(peer_id)
    if pv is None:
        if _peer_total[0] >= _PEER_CAP:
            _totals["dropped_peers"] += 1
            return tv, None
        pv = tv.peers[peer_id] = _PeerView(now, state, seed)
        _peer_total[0] += 1
    elif seed:
        pv.seed = True
    return tv, pv


# -- hot hooks (resource managers / FSM / scheduling) -------------------


def on_peer(task_id: str, peer_id: str, seed: bool = False,
            total_pieces: int = 0) -> None:
    """A peer registered (PeerManager.store / load_or_store)."""
    now = time.monotonic()
    with _lock:
        _ensure(task_id, peer_id, now, seed=seed, total_pieces=total_pieces)


def on_state(task_id: str, peer_id: str, state: str) -> None:
    """A peer FSM transition landed (FSM.on_transition, installed by
    ``Peer``); covers every caller — service demux, scheduling,
    AnnounceTask, LeavePeer, gc."""
    now = time.monotonic()
    with _lock:
        tv, pv = _ensure(task_id, peer_id, now, state=state)
        if pv is None:
            return
        pv.state = state
        pv.last_progress = now
        if state == BACK_TO_SOURCE_STATE:
            tv.back_to_source += 1
            _totals["back_to_source"] += 1


def on_total(task_id: str, total_pieces: int) -> None:
    """The task's true piece total was learned (a finished download's
    report, or a piece-bearing register). Back-to-source downloads
    report every piece before the scheduler learns the total, so
    without this hook such a task reads coverage 0 forever."""
    if total_pieces <= 0:
        return
    now = time.monotonic()
    with _lock:
        _ensure(task_id, None, now, total_pieces=total_pieces)


def on_piece(task_id: str, peer_id: str, done: int, total_pieces: int = 0) -> None:
    """A piece-finished report landed (Peer.finish_piece). ``done`` is
    the peer's finished-piece count; coverage is the monotone max."""
    now = time.monotonic()
    with _lock:
        tv, pv = _ensure(task_id, peer_id, now, total_pieces=total_pieces)
        if pv is None:
            return
        pv.pieces = done
        pv.last_progress = now
        if done > tv.max_done:
            tv.max_done = done
        # roll the rate window: one division per elapsed window, not
        # per piece
        dt = now - pv.rate_t0
        if dt >= _cfg.rate_window_s:
            pv.rate = (done - pv.rate_p0) / dt
            pv.rate_t0 = now
            pv.rate_p0 = done


def on_primary_parent(task_id: str, child_id: str, parent_id: str) -> None:
    """A scheduling decision chose ``parent_id`` as the child's first
    ranked candidate — the tree edge the observatory tracks."""
    now = time.monotonic()
    with _lock:
        tv, pv = _ensure(task_id, child_id, now)
        if pv is None:
            return
        if pv.parent is None:
            tv.edges += 1
        pv.parent = parent_id
        parent = tv.peers.get(parent_id)
        pv.depth = parent.depth + 1 if parent is not None else 1
        pv.last_progress = now  # a fresh placement is progress


def on_reschedule(task_id: str, peer_id: str) -> None:
    """The scheduler dropped the peer's parent edges to re-place it;
    only counted as churn when a primary parent was actually set."""
    with _lock:
        tv = _tasks.get(task_id)
        pv = tv.peers.get(peer_id) if tv is not None else None
        if pv is None or pv.parent is None:
            return
        pv.parent = None
        pv.depth = 0
        tv.edges -= 1
        tv.reschedules += 1
        _totals["reschedules"] += 1
        _dirty.add(task_id)


def on_peer_gone(task_id: str, peer_id: str) -> None:
    """A peer left the resource model (PeerManager.delete). Children
    holding it as primary parent are orphaned back to roots — the
    scheduler will re-place them, and the identity must hold meanwhile."""
    with _lock:
        tv = _tasks.get(task_id)
        if tv is None:
            return
        pv = tv.peers.pop(peer_id, None)
        if pv is None:
            return
        _peer_total[0] -= 1
        _dirty.add(task_id)
        if pv.parent is not None:
            tv.edges -= 1
        for child in tv.peers.values():
            if child.parent == peer_id:
                child.parent = None
                child.depth = 0
                tv.edges -= 1


def on_task_gone(task_id: str) -> None:
    """A task left the resource model (TaskManager.delete)."""
    with _lock:
        tv = _tasks.pop(task_id, None)
        if tv is not None:
            _peer_total[0] -= len(tv.peers)
            _dirty.add(task_id)


# -- replication surface (scheduler/swarm_replication.py) ---------------


def task_ids() -> list[str]:
    """Every task currently in the ledger. The replicator re-journals
    them all when the settled fleet epoch advances: a replica's epoch
    stamp is written at flush time, so without a re-stamp a quiet
    task's replica would freeze at the old generation and be refused
    as stale by the very successor it exists to seed."""
    with _lock:
        return list(_tasks)


def drain_dirty() -> set[str]:
    """Swap out the set of tasks mutated since the last drain. The
    replicator's flush loop is the only caller; a churning task
    coalesces to one entry per flush interval."""
    global _dirty
    with _lock:
        out, _dirty = _dirty, set()
        return out


def export_task(task_id: str) -> "dict | None":
    """The observatory's half of a replication payload: per-peer FSM
    state, primary-parent edge, depth, piece count and seed-ness, plus
    the task-level counters. ``None`` when the task left the ledger —
    the replicator turns that into a replica delete."""
    with _lock:
        tv = _tasks.get(task_id)
        if tv is None:
            return None
        return {
            "peers": {
                pid: {
                    "state": pv.state,
                    "parent": pv.parent,
                    "depth": pv.depth,
                    "pieces": pv.pieces,
                    "seed": pv.seed,
                }
                for pid, pv in tv.peers.items()
            },
            "edges": tv.edges,
            "total_pieces": tv.total_pieces,
            "max_done": tv.max_done,
            "back_to_source": tv.back_to_source,
            "reschedules": tv.reschedules,
        }


def adopt_task(task_id: str, payload: dict) -> bool:
    """Seed the ledger from an adopted replica (``export_task`` shape).
    The edge counter is recomputed from the seeded parents rather than
    trusted, so the conservation identity holds by construction even if
    the wire payload lied. Returns False when the task cap refused the
    adoption (peers past the peer cap are dropped individually)."""
    now = time.monotonic()
    with _lock:
        tv, _ = _ensure(task_id, None, now,
                        total_pieces=int(payload.get("total_pieces", 0)))
        if tv is None:
            return False
        tv.max_done = max(tv.max_done, int(payload.get("max_done", 0)))
        tv.back_to_source += int(payload.get("back_to_source", 0))
        tv.reschedules += int(payload.get("reschedules", 0))
        peers = payload.get("peers", {})
        for pid, p in peers.items():
            _, pv = _ensure(task_id, pid, now,
                            state=str(p.get("state", "Pending")),
                            seed=bool(p.get("seed", False)))
            if pv is None:
                continue
            pv.state = str(p.get("state", "Pending"))
            parent = p.get("parent")
            pv.parent = parent if parent is None else str(parent)
            pv.depth = int(p.get("depth", 0))
            pv.pieces = max(pv.pieces, int(p.get("pieces", 0)))
        # recompute: the incremental counter must agree with the map
        tv.edges = sum(1 for pv in tv.peers.values() if pv.parent is not None)
        return True


# -- straggler / stuck detection ----------------------------------------


def _peer_rate(pv: _PeerView, now: float) -> "float | None":
    """Rolling piece rate; also re-anchors stretched windows so a fully
    stalled peer's rate decays toward 0 instead of staying stale-high."""
    dt = now - pv.rate_t0
    if dt >= _cfg.rate_window_s:
        pv.rate = (pv.pieces - pv.rate_p0) / dt
        pv.rate_t0 = now
        pv.rate_p0 = pv.pieces
    return pv.rate


def _detect_locked(now: float) -> list:
    """Refresh straggler/stuck flags; returns the edge-triggered events
    to emit AFTER the lock is released."""
    events = []
    for tid, tv in _tasks.items():
        rates = []
        for pv in tv.peers.values():
            if pv.state == RUNNING_STATE:
                r = _peer_rate(pv, now)
                if r is not None:
                    rates.append(r)
        median = None
        if len(rates) >= _cfg.straggler_min_peers:
            rates.sort()
            median = rates[len(rates) // 2]
        for pid, pv in tv.peers.items():
            slow = False
            if pv.state == RUNNING_STATE and median is not None and median > 0:
                slow = pv.rate is not None and pv.rate < _cfg.straggler_factor * median
            if slow and not pv.straggler:
                pv.straggler = True
                _totals["straggler_flags"] += 1
                if now >= pv.flag_cooldown_until:
                    pv.flag_cooldown_until = now + _cfg.cooldown_s
                    events.append(
                        ("straggler", tid, pid,
                         {"rate": round(pv.rate or 0.0, 3),
                          "median": round(median, 3)})
                    )
            elif not slow and pv.straggler:
                pv.straggler = False
            idle = now - pv.last_progress
            is_stuck = pv.state not in TERMINAL_STATES and idle > _cfg.stuck_after_s
            if is_stuck and not pv.stuck:
                pv.stuck = True
                _totals["stuck_flags"] += 1
                if now >= pv.flag_cooldown_until:
                    pv.flag_cooldown_until = now + _cfg.cooldown_s
                    events.append(
                        ("stuck", tid, pid,
                         {"state": pv.state, "idle_s": round(idle, 1)})
                    )
            elif not is_stuck and pv.stuck:
                pv.stuck = False
    return events


def _emit(events: list) -> None:
    for kind, tid, pid, fields in events:
        if kind == "straggler":
            EV_STRAGGLER(task_id=tid, peer_id=pid, **fields)
        else:
            EV_STUCK(task_id=tid, peer_id=pid, **fields)


# -- reads --------------------------------------------------------------


def snapshot(task: "str | None" = None) -> dict:
    """Full observatory state (or one task's), with the conservation
    identity evaluated per task: ``consistent`` iff the incremental
    edge counter equals ``peers − roots`` from the map scan."""
    now = time.monotonic()
    with _lock:
        events = _detect_locked(now)
        tasks = {}
        for tid, tv in _tasks.items():
            if task is not None and tid != task:
                continue
            peers = {}
            states: dict[str, int] = {}
            depth_hist: dict[str, int] = {}
            roots = seeders = stragglers = stuck = 0
            for pid, pv in tv.peers.items():
                states[pv.state] = states.get(pv.state, 0) + 1
                d = min(pv.depth, _DEPTH_HIST_MAX)
                key = f"{d}+" if pv.depth >= _DEPTH_HIST_MAX else str(d)
                depth_hist[key] = depth_hist.get(key, 0) + 1
                if pv.parent is None:
                    roots += 1
                if pv.seed:
                    seeders += 1
                if pv.straggler:
                    stragglers += 1
                if pv.stuck:
                    stuck += 1
                peers[pid] = {
                    "state": pv.state,
                    "parent": pv.parent,
                    "depth": pv.depth,
                    "pieces": pv.pieces,
                    "rate": round(pv.rate, 3) if pv.rate is not None else None,
                    "seed": pv.seed,
                    "straggler": pv.straggler,
                    "stuck": pv.stuck,
                    "age_s": round(now - pv.created, 1),
                }
            total = tv.total_pieces
            coverage = min(tv.max_done / total, 1.0) if total > 0 else 0.0
            tasks[tid] = {
                "peers": peers,
                "peer_count": len(tv.peers),
                "edges": tv.edges,
                "roots": roots,
                "seeders": seeders,
                "states": states,
                "depth_hist": depth_hist,
                "total_pieces": total,
                "done_pieces": tv.max_done,
                "coverage": round(coverage, 4),
                "back_to_source": tv.back_to_source,
                "reschedules": tv.reschedules,
                "stragglers": [p for p, v in tv.peers.items() if v.straggler],
                "stuck": [p for p, v in tv.peers.items() if v.stuck],
                "consistent": tv.edges == len(tv.peers) - roots,
            }
        out = {
            "tasks": tasks,
            "task_count": len(_tasks),
            "peer_count": _peer_total[0],
            "edges": sum(t.edges for t in _tasks.values()),
            "stragglers": sum(len(t["stragglers"]) for t in tasks.values()),
            "stuck": sum(len(t["stuck"]) for t in tasks.values()),
            "reschedules": _totals["reschedules"],
            "back_to_source": _totals["back_to_source"],
            "dropped": {"tasks": _totals["dropped_tasks"],
                        "peers": _totals["dropped_peers"]},
            "consistent": all(t["consistent"] for t in tasks.values()),
        }
    _emit(events)
    return out


def summary() -> dict:
    """The flight-probe / dfdoctor form: counts only, no per-peer rows —
    small enough to ride every Diagnose snapshot."""
    roll = telemetry_rollup()
    return roll or {"tasks": 0, "peers": 0}


def telemetry_rollup() -> dict:
    """Per-shard rollup for the manager fold (the ``swarm_rollup``
    telemetry section); {} while the observatory is empty so quiet
    schedulers don't grow their payload."""
    now = time.monotonic()
    with _lock:
        if not _tasks:
            return {}
        events = _detect_locked(now)
        roots = stragglers = stuck = 0
        depth_hist: dict[str, int] = {}
        for tv in _tasks.values():
            for pv in tv.peers.values():
                if pv.parent is None:
                    roots += 1
                if pv.straggler:
                    stragglers += 1
                if pv.stuck:
                    stuck += 1
                key = f"{_DEPTH_HIST_MAX}+" if pv.depth >= _DEPTH_HIST_MAX else str(pv.depth)
                depth_hist[key] = depth_hist.get(key, 0) + 1
        out = {
            "tasks": len(_tasks),
            "peers": _peer_total[0],
            "edges": sum(t.edges for t in _tasks.values()),
            "roots": roots,
            "stragglers": stragglers,
            "stuck": stuck,
            "depth_hist": depth_hist,
            "reschedules": _totals["reschedules"],
            "back_to_source": _totals["back_to_source"],
        }
    _emit(events)
    return out


def telemetry_section(max_tasks: int = 256, max_stragglers: int = 5) -> list:
    """Per-task rows for the scheduler's ``swarms`` telemetry section
    (the shape the manager merges fleet-wide and dfstat renders)."""
    now = time.monotonic()
    rows = []
    with _lock:
        events = _detect_locked(now)
        for tid, tv in list(_tasks.items())[:max_tasks]:
            live = seeders = 0
            straggler_ids = []
            for pid, pv in tv.peers.items():
                if pv.state != "Leave":
                    live += 1
                if pv.seed or pv.state == "Succeeded":
                    seeders += 1
                if pv.straggler or pv.stuck:
                    straggler_ids.append(pid)
            rows.append(
                {
                    "task_id": tid,
                    "peers": live,
                    "seeders": seeders,
                    "done_pieces": tv.max_done,
                    "total_pieces": tv.total_pieces,
                    "stragglers": straggler_ids[:max_stragglers],
                }
            )
    _emit(events)
    return rows


# -- lazy series flush ---------------------------------------------------


def sync_series() -> None:
    """Refresh the ``dragonfly_swarm_*`` series and run the detector;
    invoked by the registry before every exposition/telemetry snapshot
    (``Registry.on_sync``) — the hot hooks never touch a metric lock."""
    now = time.monotonic()
    with _lock:
        events = _detect_locked(now)
        states: dict[str, int] = {}
        roots = stragglers = stuck = edges = 0
        for tv in _tasks.values():
            edges += tv.edges
            for pv in tv.peers.values():
                states[pv.state] = states.get(pv.state, 0) + 1
                if pv.straggler:
                    stragglers += 1
                if pv.stuck:
                    stuck += 1
        ntasks = len(_tasks)
        deltas = {k: _totals[k] - _synced[k] for k in _totals}
        _synced.update(_totals)
    # gauge sets and counter incs land outside the ledger lock (metric
    # locks never nest under ours)
    SWARM_TASKS.set(ntasks)
    SWARM_EDGES.set(edges)
    SWARM_STRAGGLERS.set(stragglers)
    SWARM_STUCK.set(stuck)
    _seen_states.update(states)
    for st in _seen_states:
        SWARM_PEERS.labels(st).set(states.get(st, 0))
    if deltas["reschedules"]:
        SWARM_RESCHEDULES_TOTAL.inc(deltas["reschedules"])
    if deltas["back_to_source"]:
        SWARM_BACK_TO_SOURCE_TOTAL.inc(deltas["back_to_source"])
    if deltas["straggler_flags"]:
        SWARM_STRAGGLER_FLAGS_TOTAL.inc(deltas["straggler_flags"])
    if deltas["stuck_flags"]:
        SWARM_STUCK_FLAGS_TOTAL.inc(deltas["stuck_flags"])
    if deltas["dropped_tasks"]:
        SWARM_DROPPED_TOTAL.labels("task").inc(deltas["dropped_tasks"])
    if deltas["dropped_peers"]:
        SWARM_DROPPED_TOTAL.labels("peer").inc(deltas["dropped_peers"])
    _emit(events)


_r.on_sync(sync_series)


def reset() -> None:
    """Zero the observatory (tests and in-process soaks only; the
    Prometheus counters keep their flushed monotonic totals)."""
    with _lock:
        _tasks.clear()
        _dirty.clear()
        _peer_total[0] = 0
        for k in _totals:
            _totals[k] = 0
            _synced[k] = 0
    for k, v in _DEFAULTS.items():
        setattr(_cfg, k, v)
