"""Phase ledger: named wall-clock phases declared once per module
(``PH = profiling.phase_type("scheduler.wave_pack")``) and accounted
continuously — ``with PH: ...`` for timed blocks, ``PH.observe(dt)``
where the caller already measured. Counterpart of the phase-ledger half
of the reference's ``utils/profiling.py``; the sampling profiler comes
with a later slice.
"""

from __future__ import annotations

import bisect
import threading
import time

from dragonfly2_torch.utils.metrics import default_registry as _r

# synced lazily from the ledger at snapshot time, so the per-phase hot
# path never takes a metric lock
PROF_PHASE_SECONDS_TOTAL = _r.counter(
    "prof_phase_seconds_total",
    "Cumulative wall seconds accounted per phase-ledger phase",
    ("phase",),
)
PROF_PHASE_TOTAL = _r.counter(
    "prof_phase_total", "Phase-ledger entries completed", ("phase",)
)
PROF_PHASE_ACTIVE = _r.gauge(
    "prof_phase_active", "Phase-ledger entries currently open", ("phase",)
)

_PHASE_BUCKETS = (1e-5, 1e-4, 1e-3, 0.01, 0.1, 0.5, 1.0, 5.0, 30.0)


class Phase:
    """One named wall-clock phase, usable as a (re-entrant, thread-safe)
    context manager or fed pre-measured durations with ``observe``. The
    hot path is ledger-only: one bisect and one short lock per
    ``observe``."""

    __slots__ = (
        "name", "count", "total_s", "max_s", "bucket_counts", "active_n",
        "_lock", "_tls", "_synced_count", "_synced_total_s",
    )

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.bucket_counts = [0] * (len(_PHASE_BUCKETS) + 1)
        self.active_n = 0
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._synced_count = 0
        self._synced_total_s = 0.0

    def observe(self, seconds: float) -> None:
        i = bisect.bisect_left(_PHASE_BUCKETS, seconds)
        with self._lock:
            self.count += 1
            self.total_s += seconds
            if seconds > self.max_s:
                self.max_s = seconds
            self.bucket_counts[i] += 1

    def __enter__(self):
        starts = getattr(self._tls, "starts", None)
        if starts is None:
            starts = self._tls.starts = []
        self.active_n += 1  # GIL add; synced to the gauge at snapshot
        starts.append(time.perf_counter())
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._tls.starts.pop()
        self.active_n -= 1
        self.observe(dt)
        return False

    def snapshot(self) -> dict:
        with self._lock:
            count, total, mx = self.count, self.total_s, self.max_s
        return {
            "count": count,
            "total_s": round(total, 6),
            "mean_s": round(total / count, 6) if count else 0.0,
            "max_s": round(mx, 6),
            "active": self.active_n,
        }

    def _sync_metrics(self, count: int, total_s: float) -> None:
        """Bring the Prometheus series up to the given cumulative values
        (callers serialize via ``_sync_lock``)."""
        if count > self._synced_count:
            PROF_PHASE_TOTAL.labels(self.name).inc(count - self._synced_count)
            self._synced_count = count
        if total_s > self._synced_total_s:
            PROF_PHASE_SECONDS_TOTAL.labels(self.name).inc(total_s - self._synced_total_s)
            self._synced_total_s = total_s
        PROF_PHASE_ACTIVE.labels(self.name).set(self.active_n)


_phases: dict[str, Phase] = {}
_phases_lock = threading.Lock()
# serializes the lazy Prometheus sync across snapshot readers
_sync_lock = threading.Lock()


def phase_type(name: str) -> Phase:
    """Declare (or fetch) a named phase. Names are ``<service>.<what>``
    in ``[a-z0-9_.]``; re-declaring a name returns the same entry."""
    service, _, what = name.partition(".")
    if not service or not what or not all(
        c.islower() or c.isdigit() or c in "._" for c in name
    ):
        raise ValueError(f"phase name {name!r} must be <service>.<what> [a-z0-9_.]")
    ph = _phases.get(name)
    if ph is None:
        with _phases_lock:
            ph = _phases.get(name)
            if ph is None:
                ph = Phase(name)
                _phases[name] = ph
    return ph


def ledger_snapshot() -> dict:
    """{phase: {count, total_s, mean_s, max_s, active, share}} — share is
    the phase's fraction of its service group's total wall."""
    with _phases_lock:
        items = list(_phases.items())
    snaps = {name: ph.snapshot() for name, ph in items}
    with _sync_lock:
        for name, ph in items:
            ph._sync_metrics(snaps[name]["count"], snaps[name]["total_s"])
    group_totals: dict[str, float] = {}
    for name, snap in snaps.items():
        group = name.split(".", 1)[0]
        group_totals[group] = group_totals.get(group, 0.0) + snap["total_s"]
    for name, snap in snaps.items():
        total = group_totals[name.split(".", 1)[0]]
        snap["share"] = round(snap["total_s"] / total, 4) if total else 0.0
    return snaps
