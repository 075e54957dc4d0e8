"""Demand extraction: download traffic → bounded per-task time series
(counterpart of the reference's ``preheat/demand.py``).

Every finished download the scheduler records (storage.create_download)
and every registry layer pull the client proxy reports fold into a
fixed-width time-bucket series per task. The window is the forecaster's
input grid: ``series_batch()`` returns a dense ``[N, T]`` count matrix
aligned on the bucket clock, newest bucket last.

Bounded like a flight ring: at most ``max_tasks`` series are resident;
arrivals past the cap are drop-counted, never allocated — a hot-task
storm degrades forecast coverage, not scheduler memory. Buckets older
than the rolling window are pruned on every touch.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from dragonfly2_torch.scheduler import metrics as M
from dragonfly2_torch.utils import flight
from dragonfly2_torch.utils.idgen import URL_FILTER_SEPARATOR

EV_TASK_DROPPED = flight.event_type("preheat.task_dropped")

DEFAULT_BUCKET_S = 10.0
DEFAULT_WINDOW_BUCKETS = 32
DEFAULT_MAX_TASKS = 1024

# demand-signal sources (the label on preheat_demand_observed_total)
SOURCE_RECORD = "record"
SOURCE_LAYER = "layer"


class _Series:
    """One task's bucketed demand counts (sparse: bucket index → count)
    plus the trigger context — the URL and URLMeta fields (tag,
    application, filter, range, digest) the demanded task's id was
    derived from. The preheat job replays exactly this context so the
    seeded content joins the swarm demanded clients actually join."""

    __slots__ = ("url", "meta", "counts", "last_bucket")

    def __init__(self, url: str):
        self.url = url
        self.meta: dict[str, str] = {}
        self.counts: dict[int, float] = {}
        self.last_bucket = 0


class DemandWindow:
    """Rolling per-task demand series over fixed-width time buckets."""

    def __init__(
        self,
        bucket_s: float = DEFAULT_BUCKET_S,
        window_buckets: int = DEFAULT_WINDOW_BUCKETS,
        max_tasks: int = DEFAULT_MAX_TASKS,
    ):
        if bucket_s <= 0:
            raise ValueError(f"bucket_s must be positive, got {bucket_s}")
        if window_buckets < 2:
            raise ValueError(f"window_buckets must be >= 2, got {window_buckets}")
        self.bucket_s = float(bucket_s)
        self.window_buckets = int(window_buckets)
        self.max_tasks = int(max_tasks)
        self.observed = 0
        self.dropped = 0  # arrivals refused at the task cap
        self._overflowed = False  # one transition event, not one per drop
        self._series: dict[str, _Series] = {}
        self._lock = threading.Lock()

    # -- folding -----------------------------------------------------------
    def observe(
        self,
        task_id: str,
        url: str = "",
        ts: "float | None" = None,
        count: float = 1.0,
        source: str = SOURCE_RECORD,
        meta: "dict | None" = None,
    ) -> bool:
        """Fold one demand observation; False when the task cap refused
        a new series (existing tasks always fold). ``meta`` is the
        demanded task's URLMeta context (tag/application/filter/range/
        digest) — carried so a preheat of this series seeds the very
        task id demanded clients compute, not a planner-private one."""
        bucket = int((time.time() if ts is None else ts) / self.bucket_s)
        with self._lock:
            s = self._series.get(task_id)
            if s is None:
                if len(self._series) >= self.max_tasks:
                    self._prune_locked(bucket)
                if len(self._series) >= self.max_tasks:
                    self.dropped += 1
                    M.PREHEAT_DEMAND_DROPPED_TOTAL.inc()
                    if not self._overflowed:
                        self._overflowed = True
                        EV_TASK_DROPPED(tasks=len(self._series), cap=self.max_tasks)
                    return False
                s = self._series[task_id] = _Series(url)
            elif url:
                s.url = url  # keep the freshest URL for the preheat job
            if meta:
                s.meta = {k: v for k, v in meta.items() if v}
            s.counts[bucket] = s.counts.get(bucket, 0.0) + count
            if bucket > s.last_bucket:
                s.last_bucket = bucket
                floor = bucket - self.window_buckets + 1
                for b in [b for b in s.counts if b < floor]:
                    del s.counts[b]
            self.observed += 1
        M.PREHEAT_DEMAND_OBSERVED_TOTAL.labels(source).inc()
        return True

    def observe_record(self, rec, task=None) -> None:
        """Fold a scheduler ``DownloadRecord`` (the storage.on_download
        hook shape): one download of the record's task at its creation
        time, keyed by the task's REAL id. When the live resource
        ``task`` is supplied its full URLMeta context (tag, application,
        filter, range, digest) rides along, so a preheat of this series
        reproduces the demanded task id exactly; the record alone only
        carries tag/application."""
        if task is not None:
            meta = {
                "tag": task.tag,
                "application": task.application,
                "filter": URL_FILTER_SEPARATOR.join(task.filters),
                "range": task.url_range,
                "digest": task.digest,
            }
            url = task.url or rec.task.url
        else:
            meta = {"tag": rec.tag, "application": rec.application}
            url = rec.task.url
        self.observe(
            rec.task.id,
            url=url,
            ts=rec.created_at / 1e9 if rec.created_at else None,
            source=SOURCE_RECORD,
            meta=meta,
        )

    def observe_layer(
        self,
        digest: str,
        url: str,
        ts: "float | None" = None,
        task_id: str = "",
        meta: "dict | None" = None,
    ) -> None:
        """Fold a registry layer pull (the client proxy's per-layer-digest
        demand signal). When the proxy can resolve the P2P task identity
        the pull would ride (``task_id`` + its URLMeta context), that id
        keys the series so the preheat loop places content into the very
        swarm demanded clients join; otherwise the layer digest keys it
        (content-addressed fallback — same layer, one series)."""
        self.observe(task_id or digest, url=url, ts=ts, source=SOURCE_LAYER, meta=meta)

    # -- reads -------------------------------------------------------------
    def series_batch(
        self, now: "float | None" = None
    ) -> tuple[list[str], list[str], np.ndarray]:
        """(task_ids, urls, counts ``[N, T]`` float32) — every resident
        task's window on the current bucket grid, newest bucket last
        (column ``T-1`` is the bucket containing ``now``). Tasks whose
        whole window went quiet are pruned here, freeing cap slots."""
        current = int((time.time() if now is None else now) / self.bucket_s)
        floor = current - self.window_buckets + 1
        with self._lock:
            self._prune_locked(current)
            ids = sorted(self._series)
            out = np.zeros((len(ids), self.window_buckets), np.float32)
            urls = []
            for i, task_id in enumerate(ids):
                s = self._series[task_id]
                urls.append(s.url)
                for b, c in s.counts.items():
                    if b >= floor:
                        out[i, b - floor] = c
        M.PREHEAT_DEMAND_TASKS.set(len(ids))
        return ids, urls, out

    def _prune_locked(self, current_bucket: int) -> None:
        floor = current_bucket - self.window_buckets + 1
        dead = [
            tid
            for tid, s in self._series.items()
            if s.last_bucket < floor or not s.counts
        ]
        for tid in dead:
            del self._series[tid]
        if dead and len(self._series) < self.max_tasks:
            self._overflowed = False  # capacity is back; re-arm the marker

    def meta_for(self, task_id: str) -> dict:
        """The URLMeta context captured for ``task_id``'s series (empty
        when the source carried none) — the planner attaches this to the
        preheat job so the seed derives the demanded task id."""
        with self._lock:
            s = self._series.get(task_id)
            return dict(s.meta) if s is not None else {}

    def task_count(self) -> int:
        with self._lock:
            return len(self._series)

    def stats(self) -> dict:
        with self._lock:
            return {
                "tasks": len(self._series),
                "observed": self.observed,
                "dropped": self.dropped,
                "bucket_s": self.bucket_s,
                "window_buckets": self.window_buckets,
            }
