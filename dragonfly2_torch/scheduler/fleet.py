"""Scheduler-fleet wire protocol: the ``WRONG_SHARD`` refusal (counterpart
of the reference's ``scheduler/fleet.py``, its protocol half only).

A fleet member refuses an announce for a task whose ring owner is another
live member with a typed gRPC status (FAILED_PRECONDITION) whose details
carry the owner and the refusing member's ring version. The services
render :class:`WrongShardError` that way. Fleet membership itself (leased
KV registration, the owner check, swarm replication) is not ported: the
scheduler server raises on ``fleet_enabled`` (ROADMAP queue A).
"""

from __future__ import annotations

import re

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
