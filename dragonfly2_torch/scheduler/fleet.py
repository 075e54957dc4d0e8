"""Scheduler-fleet wire protocol: the ``WRONG_SHARD`` refusal and the
daemon-side failover series (counterpart of the reference's
``scheduler/fleet.py``, its protocol half only).

A fleet member refuses an announce for a task whose ring owner is another
live member with a typed gRPC status (FAILED_PRECONDITION) whose details
carry the owner and the refusing member's ring version. The services
render :class:`WrongShardError` that way. Fleet membership itself (leased
KV registration, the owner check, swarm replication) is not ported: the
scheduler server raises on ``fleet_enabled``, the daemon on
``kv_address`` (ROADMAP queue A item 5h).
"""

from __future__ import annotations

import re

from dragonfly2_torch.utils.metrics import default_registry as _r

WRONG_SHARD_TOTAL = _r.counter(
    "fleet_wrong_shard_total",
    "Announces refused (scheduler side) or re-picked (daemon side) for"
    " landing on the wrong shard",
    ("side",),
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
    """Raised by a fleet member's owner check when a task's ring owner is
    another live member; the RPC surface renders it as
    FAILED_PRECONDITION with :func:`format_wrong_shard` details."""

    def __init__(self, owner: str, ring_version: int):
        super().__init__(format_wrong_shard(owner, ring_version))
        self.owner = owner
        self.ring_version = ring_version
