# dfanalyze: hot — byte-provenance accounting rides the piece write
# path, the uploader send window, and every proxy/gateway body pump;
# keep each call to one short lock hold and zero allocation beyond the
# ring tuple.
"""Byte-provenance flow ledger (counterpart of the reference's
``utils/flows.py``).

Every byte the system moves is attributed at its acquisition source to
a (traffic plane x provenance) cell:

  planes       ``file`` (dfget), ``image`` (registry-proxy layers),
               ``object`` (dfstore front)
  provenances  ``origin`` (back-to-source reads), ``parent`` (P2P piece
               downloads), ``dedup`` (content-addressed reuse: the
               transfer happened but the store already held the bytes),
               ``local_cache`` (completed-task reuse served without any
               new acquisition), ``preheat`` (origin reads done ahead
               of demand by the preheat plane)

The classes are exclusive — one piece lands in exactly one cell — so
per-plane conservation holds: bytes served at the consumer edge equal
the sum over provenance cells (``serve()`` vs ``account()``). Bytes a
daemon uploads to child peers are a separate serve-side series
(``upload()``); counting them in the acquisition cells would double
count every parent transfer.

Design mirrors the flight ring: a fixed preallocated cell matrix
guarded by one short module lock (conservation gates need exact
counts — GIL-raced ``+=`` on shared cells loses increments), plus a
bounded ring of recent entries for window-rate queries. The Prometheus
series never see the hot path at all: ``sync_series()`` flushes ledger
deltas lazily, once per exposition/telemetry snapshot, via the
registry's ``on_sync`` hook — so ``account()`` is one lock hold and a
ring append, nothing more.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from dragonfly2_torch.utils.metrics import default_registry as _r

PLANES = ("file", "image", "object")
PROVENANCES = ("origin", "parent", "dedup", "local_cache", "preheat")

# Provenance partition for the efficiency rollups: "good" bytes were
# saved from the origin (P2P parents, content-addressed reuse, local
# completed-task reuse); "bad" bytes hit the origin (demand-driven or
# spent ahead of demand by preheat seeding).
P2P_PROVENANCES = ("parent", "dedup", "local_cache")
ORIGIN_PROVENANCES = ("origin", "preheat")

FLOW_BYTES = _r.counter(
    "flow_bytes_total",
    "Bytes acquired, by traffic plane and provenance",
    ("plane", "provenance"),
)
FLOW_REQUESTS = _r.counter(
    "flow_requests_total",
    "Flow-ledger accounted requests, by plane and provenance",
    ("plane", "provenance"),
)
FLOW_LATENCY = _r.histogram(
    "flow_request_duration_seconds",
    "Per-plane request latency as seen by the flow ledger",
    ("plane",),
)
FLOW_SERVED_BYTES = _r.counter(
    "flow_served_bytes_total",
    "Bytes served to consumers at the plane edge",
    ("plane",),
)
FLOW_UPLOAD_BYTES = _r.counter(
    "flow_upload_bytes_total",
    "Bytes this daemon uploaded to child peers, by demanded plane",
    ("plane",),
)
# Distinct-name rollups for the manager fold (the telemetry bucket sums
# labels away per series NAME, so the p2p_efficiency SLO needs its
# good/bad legs as separate series).
FLOW_P2P_BYTES = _r.counter(
    "flow_p2p_bytes_total",
    "Bytes acquired without touching the origin (parent+dedup+local_cache)",
)
FLOW_ORIGIN_BYTES = _r.counter(
    "flow_origin_bytes_total",
    "Bytes read from the origin (demand back-to-source + preheat seeding)",
)

_NPROV = len(PROVENANCES)
_PLANE_IDX = {p: i for i, p in enumerate(PLANES)}
_PROV_IDX = {p: i for i, p in enumerate(PROVENANCES)}
_P2P_SET = frozenset(P2P_PROVENANCES)

# Pre-bound labeled children: .labels() takes the metric lock and walks
# a dict — resolve every cell once here so account() never does.
_BYTES_CHILD = tuple(
    tuple(FLOW_BYTES.labels(pl, pr) for pr in PROVENANCES) for pl in PLANES
)
_REQ_CHILD = tuple(
    tuple(FLOW_REQUESTS.labels(pl, pr) for pr in PROVENANCES) for pl in PLANES
)
_LAT_CHILD = tuple(FLOW_LATENCY.labels(pl) for pl in PLANES)
_SERVED_CHILD = tuple(FLOW_SERVED_BYTES.labels(pl) for pl in PLANES)
_UPLOAD_CHILD = tuple(FLOW_UPLOAD_BYTES.labels(pl) for pl in PLANES)

_RING_CAP = 4096
_TASK_MAP_CAP = 4096

_lock = threading.Lock()
# acquisition bytes / requests, flat [plane][prov]
_bytes = [[0] * _NPROV for _ in PLANES]
_requests = [[0] * _NPROV for _ in PLANES]
_served = [0] * len(PLANES)
_uploaded = [0] * len(PLANES)
# ledger values already flushed into the Prometheus series — the hot
# path never touches a counter lock; sync_series() (run by the registry
# before every exposition/snapshot) incs the deltas, flight-recorder
# style
_synced_bytes = [[0] * _NPROV for _ in PLANES]
_synced_requests = [[0] * _NPROV for _ in PLANES]
_synced_served = [0] * len(PLANES)
_synced_uploaded = [0] * len(PLANES)
_synced_rollup = [0, 0]  # flushed [p2p, origin] totals
# recent-window ring: (monotonic ts, plane idx, prov idx, nbytes)
_ring: deque = deque(maxlen=_RING_CAP)
# task id -> plane ("file" implicit when absent); bounded FIFO
_task_plane: dict = {}
# task ids whose back-to-source bytes are preheat seeding, not demand
_preheat_tasks: dict = {}


def account(plane: str, provenance: str, nbytes: int) -> None:
    """Attribute ``nbytes`` acquired via ``provenance`` on ``plane``.

    The single acquisition entry point — exclusivity (each byte lands
    in exactly one provenance cell) is the caller's contract and what
    makes per-plane conservation checkable.
    """
    pl = _PLANE_IDX[plane]
    pr = _PROV_IDX[provenance]
    # one short lock hold, no Prometheus inc — the series flush lazily
    # in sync_series() so the piece path never pays a counter lock
    with _lock:
        _bytes[pl][pr] += nbytes
        _ring.append((time.monotonic(), pl, pr, nbytes))


def request(plane: str, provenance: str, latency_s: "float | None" = None) -> None:
    """Count one plane-level request outcome (and its wall latency)."""
    pl = _PLANE_IDX[plane]
    pr = _PROV_IDX[provenance]
    with _lock:
        _requests[pl][pr] += 1
    # the latency histogram observes per REQUEST (not per piece), so a
    # direct observe is fine — buckets can't be delta-synced anyway
    if latency_s is not None:
        _LAT_CHILD[pl].observe(latency_s)


def serve(plane: str, nbytes: int) -> None:
    """Count bytes handed to a consumer at the plane edge."""
    pl = _PLANE_IDX[plane]
    with _lock:
        _served[pl] += nbytes


def upload(plane: str, nbytes: int) -> None:
    """Count bytes this daemon uploaded to a child peer."""
    pl = _PLANE_IDX[plane]
    with _lock:
        _uploaded[pl] += nbytes


def set_task_plane(task_id: str, plane: str) -> None:
    """Remember which plane a swarm task's bytes belong to.

    Set by the transport BEFORE the stream task starts so early pieces
    never race to the implicit ``file`` plane. Bounded FIFO — an
    evicted entry just demotes late pieces to ``file``.
    """
    if plane not in _PLANE_IDX:
        raise ValueError(f"unknown plane {plane!r}")
    with _lock:
        if task_id not in _task_plane and len(_task_plane) >= _TASK_MAP_CAP:
            _task_plane.pop(next(iter(_task_plane)))
        _task_plane[task_id] = plane


def task_plane(task_id: str) -> str:
    with _lock:
        return _task_plane.get(task_id, "file")


def mark_preheat(task_id: str) -> None:
    """Mark a task so its back-to-source bytes attribute to ``preheat``."""
    with _lock:
        if task_id not in _preheat_tasks and len(_preheat_tasks) >= _TASK_MAP_CAP:
            _preheat_tasks.pop(next(iter(_preheat_tasks)))
        _preheat_tasks[task_id] = True


def is_preheat(task_id: str) -> bool:
    with _lock:
        return task_id in _preheat_tasks


def snapshot() -> dict:
    """Full ledger state: per-plane provenance cells + conservation legs."""
    with _lock:
        by = [row[:] for row in _bytes]
        rq = [row[:] for row in _requests]
        sv = _served[:]
        up = _uploaded[:]
    planes = {}
    for pl, plane in enumerate(PLANES):
        planes[plane] = {
            "bytes": {pr: by[pl][i] for i, pr in enumerate(PROVENANCES)},
            "requests": {pr: rq[pl][i] for i, pr in enumerate(PROVENANCES)},
            "served_bytes": sv[pl],
            "upload_bytes": up[pl],
        }
    total = sum(sum(row) for row in by)
    p2p = sum(
        by[pl][_PROV_IDX[pr]] for pl in range(len(PLANES)) for pr in P2P_PROVENANCES
    )
    return {
        "planes": planes,
        "total_bytes": total,
        "p2p_bytes": p2p,
        "origin_bytes": total - p2p,
        "p2p_efficiency": (p2p / total) if total else None,
    }


def window_rates(window_s: float = 60.0) -> dict:
    """Recent byte rates per (plane, provenance) from the bounded ring.

    Best effort: the ring holds the last ``_RING_CAP`` accounting
    entries, so under very high churn the window is effectively
    shorter — fine for dfstat-style "what is moving right now" reads.
    """
    cut = time.monotonic() - window_s
    sums = [[0] * _NPROV for _ in PLANES]
    with _lock:
        entries = list(_ring)
    for ts, pl, pr, nbytes in entries:
        if ts >= cut:
            sums[pl][pr] += nbytes
    out = {}
    for pl, plane in enumerate(PLANES):
        row = {
            pr: sums[pl][i] / window_s
            for i, pr in enumerate(PROVENANCES)
            if sums[pl][i]
        }
        if row:
            out[plane] = row
    return out


def telemetry_section() -> dict:
    """Compact per-plane rollup for the telemetry payload; {} when the
    ledger never fired (quiet daemons don't grow their payload)."""
    snap = snapshot()
    if not snap["total_bytes"] and not any(
        p["served_bytes"] or p["upload_bytes"] for p in snap["planes"].values()
    ):
        return {}
    out = {
        "total_bytes": snap["total_bytes"],
        "p2p_bytes": snap["p2p_bytes"],
        "origin_bytes": snap["origin_bytes"],
        "planes": {},
    }
    if snap["p2p_efficiency"] is not None:
        out["p2p_efficiency"] = round(snap["p2p_efficiency"], 4)
    for plane, row in snap["planes"].items():
        if (
            not any(row["bytes"].values())
            and not row["served_bytes"]
            and not row["upload_bytes"]
        ):
            continue
        out["planes"][plane] = {
            "bytes": {k: v for k, v in row["bytes"].items() if v},
            "requests": {k: v for k, v in row["requests"].items() if v},
            "served_bytes": row["served_bytes"],
            "upload_bytes": row["upload_bytes"],
        }
    return out


def sync_series() -> None:
    """Flush ledger deltas into the Prometheus series.

    The hot path (``account``/``serve``/``upload``/``request``) only
    touches the module ledger; the registry runs this hook before
    every exposition and telemetry snapshot (``Registry.on_sync``) so
    the series stay current at read time without a counter lock per
    piece — the flight recorder's lazy-refresh discipline. Deltas are
    computed and the flushed shadows advanced under one ledger hold;
    the incs land outside it (counter locks never nest under ours).
    """
    pending = []
    with _lock:
        p2p = origin = 0
        for pl in range(len(PLANES)):
            for pr in range(_NPROV):
                cur = _bytes[pl][pr]
                d = cur - _synced_bytes[pl][pr]
                if d > 0:
                    pending.append((_BYTES_CHILD[pl][pr], d))
                _synced_bytes[pl][pr] = cur
                if PROVENANCES[pr] in _P2P_SET:
                    p2p += cur
                else:
                    origin += cur
                cur = _requests[pl][pr]
                d = cur - _synced_requests[pl][pr]
                if d > 0:
                    pending.append((_REQ_CHILD[pl][pr], d))
                _synced_requests[pl][pr] = cur
            cur = _served[pl]
            d = cur - _synced_served[pl]
            if d > 0:
                pending.append((_SERVED_CHILD[pl], d))
            _synced_served[pl] = cur
            cur = _uploaded[pl]
            d = cur - _synced_uploaded[pl]
            if d > 0:
                pending.append((_UPLOAD_CHILD[pl], d))
            _synced_uploaded[pl] = cur
        if p2p - _synced_rollup[0] > 0:
            pending.append((FLOW_P2P_BYTES, p2p - _synced_rollup[0]))
        if origin - _synced_rollup[1] > 0:
            pending.append((FLOW_ORIGIN_BYTES, origin - _synced_rollup[1]))
        _synced_rollup[0], _synced_rollup[1] = p2p, origin
    for child, d in pending:
        child.inc(d)


_r.on_sync(sync_series)


def reset() -> None:
    """Zero the module ledger (tests and in-process soaks only; the
    Prometheus series keep their already-flushed monotonic totals —
    un-flushed residue is dropped with the cells)."""
    with _lock:
        for row in _bytes:
            row[:] = [0] * _NPROV
        for row in _requests:
            row[:] = [0] * _NPROV
        _served[:] = [0] * len(PLANES)
        _uploaded[:] = [0] * len(PLANES)
        for row in _synced_bytes:
            row[:] = [0] * _NPROV
        for row in _synced_requests:
            row[:] = [0] * _NPROV
        _synced_served[:] = [0] * len(PLANES)
        _synced_uploaded[:] = [0] * len(PLANES)
        _synced_rollup[:] = [0, 0]
        _ring.clear()
        _task_plane.clear()
        _preheat_tasks.clear()
