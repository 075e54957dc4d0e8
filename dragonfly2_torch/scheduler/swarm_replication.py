# dfanalyze: hot — the flush loop drains the observatory's dirty set on
# a timer; the hot swarm hooks themselves only pay one set-add. Keep
# every replicator lock hold short and NEVER call into this module from
# under the swarm ledger lock (allowed nesting is replicator → swarm,
# one way).
"""Swarm replication plane: KV-journaled swarm state + successor adoption
(counterpart of the reference's ``scheduler/swarm_replication.py``).

The fleet (scheduler/fleet.py) bounds a member-death blackout to the
lease TTL, but the dead member's swarm knowledge — which peer feeds
which, who holds which pieces — dies with its process: every in-flight
peer re-registers at the successor as a stranger and risks a
back-to-source fallback. The observatory (scheduler/swarm.py) already
maintains exactly the state a successor needs, incrementally and
serializably. This module closes the loop:

- :class:`SwarmReplicator` journals per-task snapshots through the
  shared KV, off the hot path: the observatory marks tasks dirty on its
  existing hooks, a flush thread drains the dirty set every
  ``interval_s`` and writes one hash per task
  (``swarm:replica:<task_id>``) in a single pipelined burst
  (``hset_batch``). A set is the coalescing queue — a churning task
  costs one write per interval — and a bounded backlog drops oldest
  (counted) like the topology delta queue.
- Every snapshot is stamped with the writer's settled **fleet epoch**
  (``fleet:epoch``, bumped on membership change) and a per-process
  sequence number. An adopting successor refuses replicas whose epoch
  is behind its own pre-change settled epoch (the adoption floor) —
  leftovers from an older fleet generation never seed a swarm.
- **Adoption** (:meth:`SwarmReplicator.adopt_task`): when a register
  arrives for a task this shard now owns but doesn't know, the
  successor fetches the replica, gates it — epoch floor, then the
  observatory's conservation identity ``edges == peers − roots``
  recomputed from the payload — and seeds hosts, the task, and per-peer
  FSM shadows (``FSM.force``) with parent edges and finished pieces
  intact. A re-registering victim peer is then recognized (same
  peer_id, state preserved) and resumes instead of rebuilding. A torn
  or stale replica is discarded with a ``scheduler.swarm_adopt_refused``
  flight event rather than adopted wrong.
- **Migration** (:meth:`SwarmReplicator.migrate`): a WRONG_SHARD
  refusal flushes the task's replica synchronously before the daemon's
  re-pick lands on the new owner, so the handoff happens inside the
  grace window with the swarm state already waiting.

Each adoption writes a receipt (``swarm:adopt:<task_id>``) carrying the
victim's payload verbatim — a diff of it against the successor's own
re-journaled replica shows what the adoption kept, and a failover drill
reads ``adopt_ms`` from it without scraping subprocess metrics.

Failure-mode table and protocol doc: docs/fleet.md (failover section).
"""

from __future__ import annotations

import json
import threading
import time

from dragonfly2_torch.scheduler import swarm
from dragonfly2_torch.scheduler.resource.host import Host, HostType
from dragonfly2_torch.scheduler.resource.peer import Peer
from dragonfly2_torch.scheduler.resource.task import Task, TaskType
from dragonfly2_torch.utils import dflog, flight
from dragonfly2_torch.utils.kvstore import (
    SWARM_REPLICA_INDEX_KEY,
    make_swarm_adopt_key,
    make_swarm_replica_key,
)
from dragonfly2_torch.utils.metrics import default_registry as _r

logger = dflog.get("scheduler.swarm_replication")

REPL_FLUSHES_TOTAL = _r.counter(
    "swarm_replication_flushes_total", "Replication flush cycles run"
)
REPL_TASKS_WRITTEN_TOTAL = _r.counter(
    "swarm_replication_tasks_written_total",
    "Per-task replica snapshots written to the KV",
)
REPL_BYTES_TOTAL = _r.counter(
    "swarm_replication_bytes_total", "Serialized replica payload bytes written"
)
REPL_DROPPED_TOTAL = _r.counter(
    "swarm_replication_dropped_total",
    "Dirty tasks dropped oldest-first at the backlog cap",
)
REPL_ADOPTIONS_TOTAL = _r.counter(
    "swarm_replication_adoptions_total",
    "Replica adoption attempts by outcome",
    ("outcome",),
)
REPL_BACKLOG = _r.gauge(
    "swarm_replication_backlog", "Dirty tasks awaiting a replication flush"
)
REPL_ADOPT_MS = _r.histogram(
    "swarm_replication_adopt_milliseconds",
    "Replica fetch + gate + seed latency per adoption",
    buckets=(1, 2, 5, 10, 25, 50, 100, 250, 1000),
)

# adoption narrative in the scheduler timeline: ok/refused/migrate are
# the three arcs a failover postmortem walks
EV_ADOPT_OK = flight.event_type("scheduler.swarm_adopt_ok")
EV_ADOPT_REFUSED = flight.event_type("scheduler.swarm_adopt_refused")
EV_ADOPT_MIGRATE = flight.event_type("scheduler.swarm_adopt_migrate")

PAYLOAD_VERSION = 1
_FINISHED_CAP = 8192  # finished-piece numbers replicated per peer


class ReplicationConfig:
    __slots__ = ("interval_s", "max_tasks_per_flush", "backlog_cap", "replica_ttl_s")

    def __init__(
        self,
        interval_s: float = 0.25,
        max_tasks_per_flush: int = 64,
        backlog_cap: int = 1024,
        replica_ttl_s: float = 600.0,
    ):
        self.interval_s = interval_s
        self.max_tasks_per_flush = max_tasks_per_flush
        self.backlog_cap = backlog_cap
        self.replica_ttl_s = replica_ttl_s


class SwarmReplicator:
    """One scheduler's journal of its swarms, and its adoption engine.

    ``kv`` should be this replicator's OWN connection when remote — the
    flush burst must not contend with announce-path probe traffic on a
    shared socket lock (same rationale as the fleet heartbeat's
    dedicated connection in server.py).
    """

    def __init__(self, kv, self_addr: str, resource, fleet=None, config=None):
        self.kv = kv
        self.self_addr = self_addr
        self.resource = resource
        self.fleet = fleet
        self.cfg = config or ReplicationConfig()
        self._lock = threading.Lock()
        self._pending: dict[str, None] = {}  # insertion-ordered dirty set
        self._last_epoch: "int | None" = None  # re-stamp trigger
        self._seq = 0
        self._adopted: set[str] = set()  # tasks seeded from a replica
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        if fleet is not None:
            fleet.add_observer(self.on_fleet_change)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="scheduler.swarm-replicate", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        try:
            self.flush_once()  # final journal so a graceful stop leaves
        except Exception:  # the freshest possible replica behind
            pass

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.flush_once()
            except Exception as e:
                logger.warning("swarm replication flush failed: %s", e)

    # -- journal (write side) --------------------------------------------
    def flush_once(self) -> int:
        """Drain the observatory's dirty set into the backlog, then
        write up to ``max_tasks_per_flush`` replicas in one pipelined
        burst. Returns tasks written."""
        epoch = self.fleet.epoch() if self.fleet is not None else 0
        with self._lock:
            stamp_moved = epoch != self._last_epoch
            self._last_epoch = epoch
        # a moved epoch re-journals EVERY live task: replicas carry
        # their write-time stamp, and a quiet task's frozen stamp would
        # read as stale to the successor of the NEXT membership change
        restamp = swarm.task_ids() if stamp_moved else []
        dirty = swarm.drain_dirty()
        with self._lock:
            for tid in restamp:
                self._pending.setdefault(tid, None)
            for tid in dirty:
                self._pending.pop(tid, None)  # re-dirty moves to the tail
                self._pending[tid] = None
            dropped = 0
            while len(self._pending) > self.cfg.backlog_cap:
                self._pending.pop(next(iter(self._pending)))
                dropped += 1
            batch = []
            for tid in list(self._pending):
                if len(batch) >= self.cfg.max_tasks_per_flush:
                    break
                self._pending.pop(tid)
                batch.append(tid)
            self._seq += 1
            seq = self._seq
            backlog = len(self._pending)
        REPL_BACKLOG.set(backlog)
        if dropped:
            REPL_DROPPED_TOTAL.inc(dropped)
        if not batch:
            return 0
        writes: list = []
        index: dict[str, str] = {}
        gone: list[str] = []
        nbytes = 0
        for tid in batch:
            payload = self.export_payload(tid)
            if payload is None:
                gone.append(tid)
                continue
            data = json.dumps(payload, separators=(",", ":"))
            nbytes += len(data)
            writes.append(
                (
                    make_swarm_replica_key(tid),
                    {
                        "epoch": str(epoch),
                        "seq": str(seq),
                        "owner": self.self_addr,
                        "data": data,
                        "updated_at": f"{time.time():.3f}",
                    },
                )
            )
            index[tid] = json.dumps(
                {"owner": self.self_addr, "epoch": epoch, "seq": seq},
                separators=(",", ":"),
            )
        if writes:
            self._write(writes, index)
        for tid in gone:
            try:
                self.kv.delete(make_swarm_replica_key(tid))
                self.kv.hdel(SWARM_REPLICA_INDEX_KEY, tid)
            except Exception as e:
                # the replica TTL is the backstop
                logger.debug("replica delete failed for %s: %s", tid, e)
        REPL_FLUSHES_TOTAL.inc()
        if writes:
            REPL_TASKS_WRITTEN_TOTAL.inc(len(writes))
            REPL_BYTES_TOTAL.inc(nbytes)
        return len(writes)

    def _write(self, writes: list, index: dict) -> None:
        ttl_ms = int(self.cfg.replica_ttl_s * 1000)
        if hasattr(self.kv, "hset_batch"):
            # the index hash rides the same burst; its TTL slides on
            # every flush so it outlives any one replica
            self.kv.hset_batch(
                writes + [(SWARM_REPLICA_INDEX_KEY, index)], ttl_ms=ttl_ms
            )
            return
        for key, mapping in writes:
            self.kv.hset(key, mapping)
            self.kv.expire(key, self.cfg.replica_ttl_s)
        self.kv.hset(SWARM_REPLICA_INDEX_KEY, index)
        self.kv.expire(SWARM_REPLICA_INDEX_KEY, self.cfg.replica_ttl_s)

    def export_payload(self, task_id: str) -> "dict | None":
        """Join the observatory's ledger view with the resource model
        (task meta, host addressing, finished-piece numbers) into the
        wire payload. ``None`` when the observatory dropped the task —
        the flush turns that into a replica delete."""
        obs = swarm.export_task(task_id)
        if obs is None:
            return None
        payload: dict = {"v": PAYLOAD_VERSION, "obs": obs, "task": None,
                         "hosts": {}, "peer_hosts": {}, "finished": {}}
        task = self.resource.task_manager.load(task_id)
        if task is not None:
            payload["task"] = {
                "id": task.id,
                "url": task.url,
                "type": task.type.value,
                "digest": task.digest,
                "tag": task.tag,
                "application": task.application,
                "piece_length": task.piece_length,
                "content_length": task.content_length,
                "total_piece_count": task.total_piece_count,
                "state": task.fsm.current,
            }
            for pid in obs["peers"]:
                peer = self.resource.peer_manager.load(pid)
                if peer is None:
                    continue
                h = peer.host
                payload["peer_hosts"][pid] = h.id
                if h.id not in payload["hosts"]:
                    payload["hosts"][h.id] = {
                        "type": h.type.value,
                        "hostname": h.hostname,
                        "ip": h.ip,
                        "port": h.port,
                        "download_port": h.download_port,
                    }
                finished = sorted(peer.finished_pieces)[:_FINISHED_CAP]
                if finished:
                    payload["finished"][pid] = finished
        return payload

    def migrate(self, task_id: str, new_owner: str) -> bool:
        """Synchronous single-task flush on a WRONG_SHARD refusal: the
        replica (with a handoff marker) reaches the KV before the
        daemon's re-pick reaches ``new_owner``, so the task migrates
        inside the grace window instead of rebuilding there."""
        payload = self.export_payload(task_id)
        if payload is None:
            return False
        payload["handoff_to"] = new_owner
        epoch = self.fleet.epoch() if self.fleet is not None else 0
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._pending.pop(task_id, None)  # this write supersedes it
        data = json.dumps(payload, separators=(",", ":"))
        writes = [
            (
                make_swarm_replica_key(task_id),
                {
                    "epoch": str(epoch),
                    "seq": str(seq),
                    "owner": self.self_addr,
                    "data": data,
                    "updated_at": f"{time.time():.3f}",
                },
            )
        ]
        index = {
            task_id: json.dumps(
                {"owner": self.self_addr, "epoch": epoch, "seq": seq,
                 "handoff_to": new_owner},
                separators=(",", ":"),
            )
        }
        try:
            self._write(writes, index)
        except Exception as e:
            logger.warning("swarm migrate write failed for %s: %s", task_id, e)
            return False
        REPL_TASKS_WRITTEN_TOTAL.inc()
        REPL_BYTES_TOTAL.inc(len(data))
        EV_ADOPT_MIGRATE(task_id=task_id, owner=new_owner, epoch=epoch, seq=seq)
        return True

    # -- adoption (read side) --------------------------------------------
    def adopt_task(self, task_id: str) -> bool:
        """Fetch, gate, and seed one replicated swarm. Gates in order:
        replica present → epoch at/above the adoption floor → the
        conservation identity recomputed from the payload. A refused
        replica emits ``scheduler.swarm_adopt_refused`` and seeds
        nothing — adopting wrong is worse than rebuilding."""
        t0 = time.monotonic()
        with self._lock:
            if task_id in self._adopted:
                return False
        try:
            meta = self.kv.hmget(
                make_swarm_replica_key(task_id),
                ["epoch", "seq", "owner", "data"],
            )
        except Exception as e:
            logger.warning("swarm adopt fetch failed for %s: %s", task_id, e)
            REPL_ADOPTIONS_TOTAL.labels("missing").inc()
            return False
        if not meta or meta[3] is None:
            REPL_ADOPTIONS_TOTAL.labels("missing").inc()
            return False
        try:
            epoch = int(meta[0] or 0)
            seq = int(meta[1] or 0)
        except ValueError:
            epoch = seq = 0
        owner = meta[2] or ""
        floor = self.fleet.epoch_floor() if self.fleet is not None else 0
        if epoch < floor:
            return self._refuse(task_id, owner, epoch, seq, floor, "stale")
        try:
            payload = json.loads(meta[3])
            obs = payload["obs"]
            peers = obs["peers"]
            roots = sum(1 for p in peers.values() if p.get("parent") is None)
            torn = int(obs["edges"]) != len(peers) - roots
        except (KeyError, TypeError, ValueError):
            return self._refuse(task_id, owner, epoch, seq, floor, "torn")
        if torn:
            return self._refuse(task_id, owner, epoch, seq, floor, "torn")
        self._seed(task_id, payload)
        swarm.adopt_task(task_id, obs)
        with self._lock:
            self._adopted.add(task_id)
        adopt_ms = (time.monotonic() - t0) * 1000.0
        try:
            receipt = {
                "task_id": task_id,
                "victim": owner,
                "adopted_by": self.self_addr,
                "epoch": epoch,
                "seq": seq,
                "adopt_ms": round(adopt_ms, 3),
                "outcome": "adopted",
                "payload": payload,
            }
            self.kv.set(make_swarm_adopt_key(task_id), json.dumps(receipt))
        except Exception:
            pass  # the receipt is forensics, not correctness
        REPL_ADOPTIONS_TOTAL.labels("adopted").inc()
        REPL_ADOPT_MS.observe(adopt_ms)
        EV_ADOPT_OK(
            task_id=task_id, victim=owner, epoch=epoch, seq=seq,
            peers=len(peers), edges=int(obs["edges"]),
            adopt_ms=round(adopt_ms, 1),
        )
        logger.info(
            "adopted swarm %s from %s (%d peers, %d edges, %.1fms)",
            task_id, owner, len(peers), int(obs["edges"]), adopt_ms,
        )
        return True

    def _refuse(self, task_id, owner, epoch, seq, floor, reason) -> bool:
        REPL_ADOPTIONS_TOTAL.labels(reason).inc()
        EV_ADOPT_REFUSED(
            task_id=task_id, victim=owner, epoch=epoch, seq=seq,
            floor=floor, reason=reason,
        )
        try:
            receipt = {
                "task_id": task_id, "victim": owner,
                "adopted_by": self.self_addr, "epoch": epoch, "seq": seq,
                "outcome": reason,
            }
            self.kv.set(make_swarm_adopt_key(task_id), json.dumps(receipt))
        except Exception:
            pass
        logger.warning(
            "refused replica for %s from %s: %s (epoch=%d floor=%d)",
            task_id, owner, reason, epoch, floor,
        )
        return False

    def _seed(self, task_id: str, payload: dict) -> None:
        """Materialize the adopted snapshot into the resource model:
        hosts first (addressing), then the task, then per-peer FSM
        shadows with finished pieces and DAG edges. Peers whose host
        the payload doesn't carry stay observatory-only — they resume
        via plain re-registration."""
        tmeta = payload.get("task")
        if tmeta is None:
            return
        hosts: dict[str, Host] = {}
        for hid, h in payload.get("hosts", {}).items():
            try:
                htype = HostType(h.get("type", "normal"))
            except ValueError:
                htype = HostType.NORMAL
            host = Host(
                id=hid,
                type=htype,
                hostname=h.get("hostname", ""),
                ip=h.get("ip", ""),
                port=int(h.get("port", 0)),
                download_port=int(h.get("download_port", 0)),
            )
            hosts[hid], _ = self.resource.host_manager.load_or_store(host)
        try:
            ttype = TaskType(tmeta.get("type", "standard"))
        except ValueError:
            ttype = TaskType.STANDARD
        task = Task(
            task_id,
            url=tmeta.get("url", ""),
            task_type=ttype,
            digest=tmeta.get("digest", ""),
            tag=tmeta.get("tag", ""),
            application=tmeta.get("application", ""),
            piece_length=int(tmeta.get("piece_length", 4 * 1024 * 1024)),
        )
        task.content_length = int(tmeta.get("content_length", -1))
        task.total_piece_count = int(tmeta.get("total_piece_count", -1))
        task.fsm.force(str(tmeta.get("state", "Pending")))
        task, _ = self.resource.task_manager.load_or_store(task)
        peer_hosts = payload.get("peer_hosts", {})
        finished = payload.get("finished", {})
        obs_peers = payload.get("obs", {}).get("peers", {})
        seeded: dict[str, Peer] = {}
        for pid, view in obs_peers.items():
            hid = peer_hosts.get(pid)
            host = hosts.get(hid) if hid else None
            if host is None:
                continue
            peer = Peer(pid, task, host, tag=task.tag, application=task.application)
            peer, existed = self.resource.peer_manager.load_or_store(peer)
            if existed:
                seeded[pid] = peer
                continue
            peer.fsm.force(str(view.get("state", "Pending")))
            for n in finished.get(pid, ()):
                peer.finished_pieces.add(int(n))
            if finished.get(pid):
                swarm.on_piece(
                    task_id, pid, len(peer.finished_pieces),
                    task.total_piece_count,
                )
            seeded[pid] = peer
        # DAG edges last, both endpoints present: the shadow tree the
        # evaluator and reschedule paths expect to exist
        for pid, view in obs_peers.items():
            parent_id = view.get("parent")
            child = seeded.get(pid)
            parent = seeded.get(parent_id) if parent_id else None
            if child is None or parent is None:
                continue
            try:
                if task.can_add_peer_edge(parent.id, child.id):
                    task.add_peer_edge(parent, child)
            except Exception:
                continue  # a cyclic or stale edge is not worth a crash

    # -- fleet observer / sweep ------------------------------------------
    def on_fleet_change(self, info: dict) -> None:
        """Membership-change observer (fires on the fleet poll thread,
        outside the fleet lock): when members died, sweep the replica
        index for their tasks that now hash to this member and adopt
        proactively — before the first victim peer even re-registers."""
        left = info.get("left") or []
        if not left:
            return
        try:
            self.sweep(set(left))
        except Exception as e:
            logger.warning("swarm adoption sweep failed: %s", e)

    def sweep(self, dead_owners: "set[str] | None" = None) -> int:
        """Adopt every indexed task whose recorded owner is dead (or
        any non-self owner when ``dead_owners`` is None) and whose ring
        owner is now this member. Returns adoptions performed."""
        index = self.kv.hgetall(SWARM_REPLICA_INDEX_KEY)
        adopted = 0
        for tid, raw in index.items():
            try:
                meta = json.loads(raw)
            except (TypeError, ValueError):
                continue
            owner = meta.get("owner", "")
            if owner == self.self_addr:
                continue
            if dead_owners is not None and owner not in dead_owners:
                # a live owner's task only moves via WRONG_SHARD handoff
                if meta.get("handoff_to") != self.self_addr:
                    continue
            if self.fleet is not None:
                ring_owner = self.fleet.owner_of(tid)
                if ring_owner is not None and ring_owner != self.self_addr:
                    continue
            if self.resource.task_manager.load(tid) is not None:
                continue
            if self.adopt_task(tid):
                adopted += 1
        return adopted

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        """Flight-probe payload (registered as scheduler.swarm_replication)."""
        with self._lock:
            return {
                "self": self.self_addr,
                "backlog": len(self._pending),
                "seq": self._seq,
                "adopted_tasks": sorted(self._adopted),
                "interval_s": self.cfg.interval_s,
            }
