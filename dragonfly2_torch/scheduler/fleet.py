"""Scheduler-fleet membership: leased KV registration, sharded task
ownership, and bounded-blackout failover (counterpart of the reference's
``scheduler/fleet.py``).

Role parity: upstream Dragonfly2's dynconfig-fed consistent-hash balancer
(pkg/balancer + pkg/rpc) keeps N schedulers behind one hash ring and
survives member loss. Here the shared KV store (the Redis role,
utils/kvstore — the same plane the probe graph hydrates from) is also
the membership plane:

- Each scheduler registers itself under ``fleet:member:<addr>`` with a
  heartbeat-renewed lease (:class:`FleetMembership`): join on serve,
  renew on a timer, expire on missed beats. A SIGKILL'd member vanishes
  from every ring within one lease TTL — no operator action, no
  keepalive table to reap.
- Daemons and the manager poll membership (:class:`FleetWatcher`) and
  feed ``SchedulerSelector.update_addresses``, so the daemon's ring
  reconciles at runtime instead of being frozen at start.
- Each scheduler enforces shard ownership: an announce for a task whose
  ring owner is another LIVE member is refused with a typed
  ``WRONG_SHARD(owner_addr, ring_version)`` status
  (:meth:`FleetMembership.check_owner`); the daemon re-picks from its
  refreshed ring and resumes the announce stream with the same peer_id,
  so the move is lossless. Tasks already in flight on the old owner
  drain behind a grace window instead of being cut over mid-stream.

Failure-mode table, lease/heartbeat parameters, and the WRONG_SHARD
protocol: docs/fleet.md.
"""

# dfanalyze: hot — owner_of/check_owner run per announce register

from __future__ import annotations

import json
import re
import threading
import time
from dataclasses import dataclass

from dragonfly2_torch.rpc import glue
from dragonfly2_torch.utils import dflog, faults, flight
from dragonfly2_torch.utils.kvstore import make_fleet_member_key
from dragonfly2_torch.utils.metrics import default_registry as _r

logger = dflog.get("scheduler.fleet")

# fault points: the chaos plane flaps a member (lease_renew errors →
# lease expiry → eviction → rejoin) and starves the read path without
# touching real processes
FP_LEASE_RENEW = faults.point("fleet.lease_renew")
FP_MEMBERSHIP_READ = faults.point("fleet.membership_read")

EV_MEMBER_JOIN = flight.event_type("fleet.member_join")
EV_MEMBER_LEAVE = flight.event_type("fleet.member_leave")
EV_REBALANCE = flight.event_type("fleet.rebalance")
EV_WRONG_SHARD = flight.event_type("fleet.wrong_shard")
# scheduler-ring membership transitions in the SCHEDULER timeline: the
# fleet.* ring above narrates the KV/ring mechanics, these place the
# join/leave/reconcile next to the scheduling events so a dfdoctor
# timeline shows failovers instead of inferring them from gaps
EV_FLEET_JOIN = flight.event_type("scheduler.fleet_join")
EV_FLEET_LEAVE = flight.event_type("scheduler.fleet_leave")
EV_FLEET_RECONCILE = flight.event_type("scheduler.fleet_reconcile")

MEMBERS_GAUGE = _r.gauge(
    "fleet_members", "Live scheduler-fleet members in this process's view"
)
REBALANCE_TOTAL = _r.counter(
    "fleet_rebalance_total",
    "Ring rebalances applied on membership change",
    ("role",),
)
WRONG_SHARD_TOTAL = _r.counter(
    "fleet_wrong_shard_total",
    "Announces refused (scheduler side) or re-picked (daemon side) for"
    " landing on the wrong shard",
    ("side",),
)
FLEET_TRANSITIONS_TOTAL = _r.counter(
    "scheduler_fleet_transitions_total",
    "Fleet membership transitions observed by this process",
    ("transition",),
)
FAILOVER_RESUME_TOTAL = _r.counter(
    "fleet_failover_resume_total",
    "First decision after an announce-plane outage, by kind:"
    " 'recognized' (normal/small-task decision — the successor adopted"
    " the swarm and resumed the peer) vs 'fallback'"
    " (need_back_to_source — the swarm state was lost and rebuilt)",
    ("kind",),
)
BLACKOUT_MS = _r.histogram(
    "fleet_blackout_milliseconds",
    "Announce-plane disruption per failover: from first stream error to"
    " the next successful scheduler decision",
    buckets=(50, 100, 250, 500, 1000, 2500, 5000, 10000, 30000),
)


# -- WRONG_SHARD wire protocol ------------------------------------------
# The refusal is a typed gRPC status (FAILED_PRECONDITION) whose details
# carry the owner and the refusing member's ring version; no proto
# change, so old daemons see a plain stream error and fall back to the
# announce-reconnect path they already have.

WRONG_SHARD_PREFIX = "WRONG_SHARD"
_WRONG_SHARD_RE = re.compile(
    r"WRONG_SHARD owner=(?P<owner>\S+) ring_version=(?P<version>\d+)"
)


def format_wrong_shard(owner: str, ring_version: int) -> str:
    return f"{WRONG_SHARD_PREFIX} owner={owner} ring_version={ring_version}"


def parse_wrong_shard(details: str) -> "tuple[str, int] | None":
    """(owner_addr, ring_version) when ``details`` carries a WRONG_SHARD
    refusal (anywhere in the text — gRPC error strings wrap the details
    in debug context); None otherwise."""
    m = _WRONG_SHARD_RE.search(details or "")
    if m is None:
        return None
    return m.group("owner"), int(m.group("version"))


class WrongShardError(Exception):
    """Raised by :meth:`FleetMembership.check_owner` when a task's ring
    owner is another live member; the RPC surface renders it as
    FAILED_PRECONDITION with :func:`format_wrong_shard` details."""

    def __init__(self, owner: str, ring_version: int):
        super().__init__(format_wrong_shard(owner, ring_version))
        self.owner = owner
        self.ring_version = ring_version


# every member ever seen, one hash — so reads never pattern-scan the
# whole keyspace (the fleet shares the KV with the topology plane's
# O(hosts²) edge keys; a per-second KEYS walk would stall unrelated ops
# under the store lock at swarm scale)
FLEET_INDEX_KEY = "fleet:index"

# fleet generation counter, shared through the KV: bumped (INCR) by any
# member that applies a membership change, read back on every poll so
# all members converge on the settled value within one poll interval.
# Replica snapshots are stamped with the writer's settled epoch; an
# adopting successor refuses replicas stamped before its own pre-change
# settled epoch (the "adoption floor") — leftovers from an older fleet
# generation never seed a swarm.
FLEET_EPOCH_KEY = "fleet:epoch"


def write_lease(kv, address: str, ttl_seconds: float) -> None:
    """One member heartbeat: the leased key (liveness — expiry IS the
    failure detector, server-side clock, no cross-host skew) plus the
    index entry readers enumerate."""
    kv.set_with_ttl(
        make_fleet_member_key(address),
        json.dumps({"addr": address, "renewed_at": time.time()}),
        ttl_seconds,
    )
    kv.hset(FLEET_INDEX_KEY, {address: "1"})


def read_members(kv) -> list[str]:
    """Live fleet members from the shared KV: enumerate the index hash
    (one HGETALL, O(members)), then check the corresponding leases in
    one batched read — a member is live iff its lease key is unexpired.
    Index entries whose lease is gone are lazily pruned so the hash
    stays bounded by members-ever-alive-recently, not forever. Sorted
    for stable ring construction everywhere."""
    FP_MEMBERSHIP_READ()
    index = kv.hgetall(FLEET_INDEX_KEY)
    if not index:
        return []
    addrs = sorted(index)
    keys = [make_fleet_member_key(a) for a in addrs]
    if hasattr(kv, "mget"):
        values = kv.mget(keys)
    else:  # in-process store: per-key get is lock-cheap, no wire
        values = [kv.get(k) for k in keys]
    live = [a for a, v in zip(addrs, values) if v is not None]
    dead = [a for a, v in zip(addrs, values) if v is None]
    if dead:
        try:
            kv.hdel(FLEET_INDEX_KEY, *dead)
        except Exception:
            pass  # pruning is hygiene; the next reader retries it
    return live


@dataclass
class FleetConfig:
    # a member missing this many seconds of heartbeats is dead to the
    # fleet; blackout on SIGKILL is bounded by lease_ttl + poll_interval
    lease_ttl: float = 3.0
    renew_interval: float = 1.0
    poll_interval: float = 1.0
    # after a ring change, tasks already in flight on their old owner
    # drain there this long before registers for them are refused too
    grace_s: float = 10.0


class FleetMembership:
    """One scheduler's view of (and presence in) the fleet.

    ``join()`` writes this member's lease and starts the renew +
    membership-poll loops; ``leave()`` is the graceful exit (lease
    deleted, members reconverge on the next poll); ``abandon()`` stops
    the loops WITHOUT deleting the lease — the SIGKILL shape the chaos
    soak drills, where only expiry clears the member.
    """

    def __init__(self, kv, self_addr: str, config: "FleetConfig | None" = None):
        self.kv = kv
        self.self_addr = self_addr
        self.cfg = config or FleetConfig()
        self.ring = glue.ConsistentHashRing()
        self._lock = threading.Lock()
        self._members: tuple[str, ...] = ()
        self._ring_changed_at = 0.0
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._renew_failures = 0
        self._epoch = 0  # settled fleet generation (KV-read cache)
        self._epoch_floor = 0  # pre-change settled epoch: adoption gate
        self._observers: list = []

    def add_observer(self, fn) -> None:
        """Register a membership-change observer, fired AFTER a change
        is applied, outside the fleet lock, with a dict of ``joined`` /
        ``left`` / ``members`` / ``ring_version`` / ``epoch_floor``.
        The replication plane uses this to sweep for adoptable swarms
        the moment a member dies."""
        with self._lock:
            self._observers.append(fn)

    # -- lifecycle -----------------------------------------------------
    def join(self) -> None:
        self._renew_once()  # fail loudly at serve time, not on a timer
        self.reconcile()
        EV_MEMBER_JOIN(addr=self.self_addr, members=list(self._members))
        EV_FLEET_JOIN(addr=self.self_addr, members=len(self._members))
        FLEET_TRANSITIONS_TOTAL.labels("join").inc()
        logger.info(
            "fleet join %s (ttl=%.1fs, %d members)",
            self.self_addr, self.cfg.lease_ttl, len(self._members),
        )
        for fn, name in (
            (self._renew_loop, "scheduler.fleet-renew"),
            (self._poll_loop, "scheduler.fleet-poll"),
        ):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def leave(self) -> None:
        """Graceful exit: stop the loops and delete the lease (and its
        index entry) so peers reconverge on the next poll instead of
        waiting out the TTL."""
        self.abandon()
        try:
            self.kv.delete(make_fleet_member_key(self.self_addr))
            self.kv.hdel(FLEET_INDEX_KEY, self.self_addr)
        except Exception as e:
            logger.warning("fleet leave delete failed (ttl will clear it): %s", e)
        EV_MEMBER_LEAVE(addr=self.self_addr)
        EV_FLEET_LEAVE(addr=self.self_addr)
        FLEET_TRANSITIONS_TOTAL.labels("leave").inc()

    def abandon(self) -> None:
        """Stop heartbeating WITHOUT deleting the lease — the crash/
        SIGKILL shape: the member stays visible until its lease expires,
        exactly like a dead process would."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads.clear()

    # -- lease heartbeat ------------------------------------------------
    def _renew_once(self) -> None:
        FP_LEASE_RENEW()
        write_lease(self.kv, self.self_addr, self.cfg.lease_ttl)

    def _renew_loop(self) -> None:
        while not self._stop.wait(self.cfg.renew_interval):
            try:
                self._renew_once()
                self._renew_failures = 0
            except Exception as e:
                # a failed beat is survivable until the TTL runs out; the
                # count makes a flapping store visible in Diagnose dumps
                self._renew_failures += 1
                logger.warning(
                    "fleet lease renew failed (%d consecutive): %s",
                    self._renew_failures, e,
                )

    # -- membership view -------------------------------------------------
    def _poll_loop(self) -> None:
        while not self._stop.wait(self.cfg.poll_interval):
            try:
                self.reconcile()
            except Exception as e:
                logger.warning("fleet membership poll failed: %s", e)

    def reconcile(self) -> bool:
        """Read live members and fold them into the ring; True when
        membership changed. KV I/O runs OUTSIDE the lock — a slow store
        must not stall owner checks on the announce path."""
        members = tuple(read_members(self.kv))
        with self._lock:
            peek_changed = members != self._members
        # epoch I/O stays outside the lock like the membership read: a
        # change bumps the shared generation counter, a quiet poll just
        # converges the cache on the settled value
        epoch_now = self._read_epoch()
        if peek_changed:
            try:
                epoch_now = int(self.kv.incr(FLEET_EPOCH_KEY))
            except Exception as e:
                logger.warning("fleet epoch bump failed: %s", e)
        with self._lock:
            current = self._members
            if members == current:
                self._epoch = epoch_now
                return False
            joined = sorted(set(members) - set(current))
            left = sorted(set(current) - set(members))
            for addr in joined:
                self.ring.add(addr)
            for addr in left:
                self.ring.remove(addr)
            self._members = members
            self._ring_changed_at = time.monotonic()
            version = self.ring.version
            # the floor is this member's last SETTLED view — the epoch
            # the victim was stamping replicas with before it died
            self._epoch_floor = self._epoch
            self._epoch = epoch_now
            floor = self._epoch_floor
            observers = list(self._observers)
        MEMBERS_GAUGE.set(len(members))
        REBALANCE_TOTAL.labels("scheduler").inc()
        EV_REBALANCE(
            addr=self.self_addr,
            members=list(members),
            ring_version=version,
        )
        EV_FLEET_RECONCILE(
            addr=self.self_addr,
            joined=joined,
            left=left,
            ring_version=version,
        )
        FLEET_TRANSITIONS_TOTAL.labels("reconcile").inc()
        logger.info(
            "fleet membership now %s (ring v%d, epoch %d)",
            list(members), version, epoch_now,
        )
        for fn in observers:
            try:
                fn({
                    "joined": joined,
                    "left": left,
                    "members": list(members),
                    "ring_version": version,
                    "epoch_floor": floor,
                })
            except Exception:
                logger.exception("fleet membership observer failed")
        return True

    def _read_epoch(self) -> int:
        try:
            v = self.kv.get(FLEET_EPOCH_KEY)
            return int(v) if v else 0
        except Exception:
            with self._lock:
                return self._epoch

    def epoch(self) -> int:
        """This member's settled view of the fleet generation — the
        stamp the replicator writes into every snapshot."""
        with self._lock:
            return self._epoch

    def epoch_floor(self) -> int:
        """Minimum acceptable replica epoch for adoption: the settled
        generation before this member's latest membership change."""
        with self._lock:
            return self._epoch_floor

    def members(self) -> list[str]:
        with self._lock:
            return list(self._members)

    def snapshot(self) -> dict:
        """Diagnose-probe payload: the fleet state a postmortem needs."""
        with self._lock:
            return {
                "self": self.self_addr,
                "members": list(self._members),
                "ring_version": self.ring.version,
                "epoch": self._epoch,
                "epoch_floor": self._epoch_floor,
                "renew_failures": self._renew_failures,
                "in_grace": time.monotonic()
                < self._ring_changed_at + self.cfg.grace_s,
            }

    # -- shard ownership -------------------------------------------------
    def owner_of(self, task_id: str) -> "str | None":
        with self._lock:
            if not len(self.ring):
                return None
            return self.ring.pick(task_id)

    def check_owner(self, task_id: str, task_in_flight: bool = False) -> None:
        """Enforce shard ownership for one announce: raises
        :class:`WrongShardError` when the task's ring owner is another
        live member. ``task_in_flight`` marks a task this scheduler is
        already serving peers for — those drain here through the grace
        window after a rebalance instead of being cut over mid-stream
        (bounded hand-off: only tasks whose owner changed migrate, and
        only once their streams are done or the grace runs out)."""
        with self._lock:
            if not len(self.ring):
                return  # membership unknown: never refuse blind
            owner = self.ring.pick(task_id)
            version = self.ring.version
            changed_at = self._ring_changed_at
            live = owner in self._members
        if owner == self.self_addr or not live:
            return
        if task_in_flight and time.monotonic() < changed_at + self.cfg.grace_s:
            return
        WRONG_SHARD_TOTAL.labels("scheduler").inc()
        EV_WRONG_SHARD(task_id=task_id, owner=owner, ring_version=version)
        raise WrongShardError(owner, version)


class FleetWatcher:
    """Daemon/manager-side membership follower: polls the leased member
    set and hands every change to ``on_members`` (the daemon wires
    ``SchedulerSelector.update_addresses``; the manager folds it into
    the dynconfig scheduler list). ``read_members`` doubles as the
    selector's pull-now membership source for the WRONG_SHARD retry."""

    def __init__(self, kv, on_members, poll_interval: float = 1.0):
        self.kv = kv
        self.on_members = on_members
        self.poll_interval = poll_interval
        self._members: tuple[str, ...] = ()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def read_members(self) -> list[str]:
        return read_members(self.kv)

    def poll_once(self) -> "list[str] | None":
        """One reconcile; the fresh member list, or None when the read
        failed (stale view kept — an unreachable KV must not strand the
        daemon schedulerless)."""
        try:
            members = tuple(self.read_members())
        except Exception as e:
            logger.warning("fleet watcher read failed: %s", e)
            return None
        if members and members != self._members:
            self._members = members
            MEMBERS_GAUGE.set(len(members))
            REBALANCE_TOTAL.labels("daemon").inc()
            EV_REBALANCE(members=list(members))
            EV_FLEET_RECONCILE(members=list(members), side="watcher")
            FLEET_TRANSITIONS_TOTAL.labels("watch").inc()
            try:
                self.on_members(list(members))
            except Exception:
                logger.exception("fleet watcher observer failed")
        return list(members)

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="fleet.watch", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            self.poll_once()
