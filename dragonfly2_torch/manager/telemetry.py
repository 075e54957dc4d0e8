"""Manager-side cluster telemetry plane (counterpart of the reference's
``manager/telemetry.py``): windowed rolling aggregates of
the reports every service pushes (utils/telemetry.py), plus the SLO
burn-rate engine on top (docs/telemetry.md).

Upstream's Manager is the cluster's aggregation point (control plane
with cluster DB and console); this module is our equivalent for the
*operational* state nobody can see from per-process ``/metrics``
endpoints alone: swarm health per task, per-scheduler-shard rates,
trainer freshness — and objectives attached to them.

Aggregation model: cumulative series values land in per-reporter
baselines; the derived deltas fold into 10-second buckets kept for one
hour, so every windowed rate (1m/5m/1h) is one pass over ≤ 360 buckets
at query time. Baselining pushes (a reporter's registration, and every
FULL snapshot) store unknown series without counting them — a payload
after a manager restart can therefore never replay a reporter's whole
history as one spike — while an unknown series on an ordinary
changed-only push counts from zero, because the full baseline already
enumerated everything older (a previously clean counter's first error
must burn the SLO, not vanish). The dedup state and the aggregates
live and die together, so a retried delivery after a lost ack folds to
zero: no double counting.

SLO engine: declarative specs (ratio / latency / freshness) evaluated
with classic multi-window burn rates — breach when BOTH the fast and
slow windows burn error budget faster than ``burn_threshold``×. A
breach transition emits a ``manager.slo_burn`` flight event (so a
dfdoctor postmortem shows the breach next to its cause), flips the
``dragonfly_manager_slo_*`` series, and rides the ``/healthz`` body
through the status-section hook — degraded, not down: a burning SLO
keeps the 200.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

from dragonfly2_torch.manager import metrics as M
from dragonfly2_torch.utils import dflog, flight

# the plane's vocabulary: snapshot keys come from the TFIELDS census
# (utils/telemetry.py, linted by dfanalyze) so producer and consumers
# (dfstat, the soak's manager-view check) can never drift apart
from dragonfly2_torch.utils.telemetry import (
    F_CLUSTER_FLOW_BYTES,
    F_CLUSTER_P2P_EFFICIENCY,
    F_CLUSTER_PEERS,
    F_CLUSTER_SCHEDULE_OPS,
    F_CLUSTER_TASKS,
    F_DAEMON_BACK_TO_SOURCE,
    F_DAEMON_FLOW_BYTES,
    F_DAEMON_FLOW_ORIGIN_BYTES,
    F_DAEMON_FLOW_P2P_BYTES,
    F_DAEMON_PIECE_BYTES,
    F_SHARD_ANNOUNCE_OPS,
    F_SHARD_DECISION_P99,
    F_SHARD_PEERS,
    F_SHARD_SCHEDULE_OPS,
    F_SHARD_SWARM_DEPTHS,
    F_SHARD_SWARM_PEERS,
    F_SHARD_SWARM_STRAGGLERS,
    F_SHARD_SWARM_TASKS,
    F_SHARD_TASKS,
    F_SLO_BREACHED,
    F_SWARM_DONE_PIECES,
    F_SWARM_PEERS,
    F_SWARM_SEEDERS,
    F_SWARM_STRAGGLERS,
    F_SWARM_TOTAL_PIECES,
    F_TRAINER_DATASET_BYTES,
    F_TRAINER_FIT_FRESHNESS,
    F_TRAINER_INGEST_RECORDS,
)

logger = dflog.get("manager.telemetry")

EV_SLO_BURN = flight.event_type("manager.slo_burn")
EV_SLO_CLEAR = flight.event_type("manager.slo_clear")

BUCKET_S = 10.0
MAX_BUCKETS = 360  # one hour of 10s buckets
WINDOWS_S = {"1m": 60.0, "5m": 300.0, "1h": 3600.0}


def _series_name(key: str) -> str:
    return key.split("{", 1)[0]


def quantile_from_buckets(buckets: "dict[str, float]", q: float) -> float:
    """Linear-interpolated quantile from cumulative-count histogram
    buckets ({le_repr: count}); 0.0 on an empty histogram. The +Inf
    bucket clamps to the last finite edge (Prometheus's
    histogram_quantile behavior)."""
    edges: list[tuple[float, float]] = []
    for le, c in buckets.items():
        edges.append((float("inf") if le == "+Inf" else float(le), float(c)))
    edges.sort()
    if not edges or edges[-1][1] <= 0:
        return 0.0
    total = edges[-1][1]
    rank = q * total
    prev_edge, prev_count = 0.0, 0.0
    for edge, count in edges:
        if count >= rank:
            if edge == float("inf"):
                return prev_edge
            if count == prev_count:
                return edge
            frac = (rank - prev_count) / (count - prev_count)
            return prev_edge + (edge - prev_edge) * frac
        prev_edge, prev_count = (0.0 if edge == float("inf") else edge), count
    return prev_edge


class _Bucket:
    """Deltas are aggregated by series NAME (labels summed away at fold
    time): every windowed read wants the across-label-sets sum anyway,
    and the by-name index turns rate()/window_hist() into plain dict
    lookups instead of per-key string splitting — forced SLO
    evaluations on /healthz reads stay cheap under the plane lock."""

    __slots__ = ("ts", "counters", "hist_buckets")

    def __init__(self, ts: float):
        self.ts = ts
        self.counters: dict[str, float] = {}  # series name -> delta sum
        # series name -> {le_repr: count_delta}
        self.hist_buckets: dict[str, dict[str, float]] = {}


class _Reporter:
    """Per-(service, instance) state: baseline cumulative values, the
    delta buckets, the latest gauges and structured sections."""

    def __init__(self, service: str, instance: str, shard: str, epoch: str):
        self.service = service
        self.instance = instance
        self.shard = shard
        self.epoch = epoch
        # True until the first FULL payload lands: the ack keeps asking
        # (registered=True) so a LOST registration ack can't leave the
        # reporter changed-only forever — without the full enumeration,
        # a quiet series' later first tick would replay its cumulative
        # history as one spike (fold counts unknown series from zero
        # only once a full baseline exists)
        self.awaiting_full = True
        self.last_seq = 0
        self.first_seen = time.time()
        self.last_report = self.first_seen
        self.interval_s = 15.0
        self.counters_cum: dict[str, float] = {}
        self.hists_cum: dict[str, dict] = {}
        self.gauges: dict[str, float] = {}
        self.sections: dict = {}
        self.buckets: list[_Bucket] = []

    def _bucket(self, now: float) -> _Bucket:
        ts = now - (now % BUCKET_S)
        if self.buckets and self.buckets[-1].ts == ts:
            return self.buckets[-1]
        b = _Bucket(ts)
        self.buckets.append(b)
        if len(self.buckets) > MAX_BUCKETS:
            del self.buckets[: len(self.buckets) - MAX_BUCKETS]
        return b

    def fold(self, payload: dict, now: float, baseline_only: bool = False) -> None:
        """Fold one payload's deltas into the current bucket.

        Series-first-sight semantics guard against history replay: on a
        FULL push (registration/re-registration snapshots) or while
        ``baseline_only`` (the push that registered this reporter), an
        unknown series is baselined, never counted — its cumulative
        value may carry history from before the manager knew this
        reporter. On a changed-only push an unknown series counts from
        zero: the full baseline push already enumerated every series
        that predates it, so a later arrival is genuinely new activity
        (the first failure of a previously clean counter must burn the
        SLO, not vanish into a baseline)."""
        baselining = baseline_only or bool(payload.get("full"))
        bucket = self._bucket(now)
        for key, cum in payload.get("counters", {}).items():
            prev = self.counters_cum.get(key)
            self.counters_cum[key] = cum
            if prev is None:
                if baselining:
                    continue
                prev = 0.0
            d = cum - prev
            if d > 0:
                name = _series_name(key)
                bucket.counters[name] = bucket.counters.get(name, 0.0) + d
        for key, h in payload.get("hists", {}).items():
            prev = self.hists_cum.get(key)
            self.hists_cum[key] = h
            if prev is None:
                if baselining:
                    continue
                prev = {"buckets": {}, "count": 0}
            name = _series_name(key)
            prev_b = prev.get("buckets", {})
            # every edge rides the delta (zeros included) so a window
            # whose observations all landed past the largest finite edge
            # still carries the finite schema — quantile_from_buckets
            # then clamps to the last finite edge instead of reading an
            # +Inf-only dict as "no data" (p99 = 0 mid-incident)
            deltas = {
                le: max(c - prev_b.get(le, 0.0), 0.0)
                for le, c in h.get("buckets", {}).items()
            }
            if any(d > 0 for d in deltas.values()):
                agg = bucket.hist_buckets.setdefault(name, {})
                for le, d in deltas.items():
                    agg[le] = agg.get(le, 0.0) + d
            # the histogram count doubles as a counter series (rate of
            # observations) under <name>_count — labels already summed
            dc = h.get("count", 0) - prev.get("count", 0)
            if dc > 0:
                ck = name + "_count"
                bucket.counters[ck] = bucket.counters.get(ck, 0.0) + dc
        self.gauges.update(payload.get("gauges", {}))
        for k, v in payload.items():
            if k in ("counters", "gauges", "hists", "full"):
                continue
            self.sections[k] = v

    # -- windowed reads -------------------------------------------------
    def _effective_window(self, window_s: float, now: float) -> float:
        # a reporter younger than the window must not under-report rate
        return max(BUCKET_S, min(window_s, now - self.first_seen))

    def rate(self, name: str, window_s: float, now: float) -> float:
        """Per-second rate of metric ``name`` (label sets were summed at
        fold time) within the trailing window."""
        cutoff = now - window_s
        total = 0.0
        for b in reversed(self.buckets):
            if b.ts + BUCKET_S < cutoff:
                break
            total += b.counters.get(name, 0.0)
        return total / self._effective_window(window_s, now)

    def window_hist(self, name: str, window_s: float, now: float) -> dict:
        """Merged bucket deltas of histogram ``name`` within the
        trailing window."""
        cutoff = now - window_s
        merged: dict[str, float] = {}
        for b in reversed(self.buckets):
            if b.ts + BUCKET_S < cutoff:
                break
            deltas = b.hist_buckets.get(name)
            if deltas:
                for le, d in deltas.items():
                    merged[le] = merged.get(le, 0.0) + d
        # cumulative-ize: bucket counts on the wire are already
        # cumulative per le within one snapshot, and deltas of
        # cumulative counts stay cumulative across les — merged is
        # directly usable by quantile_from_buckets
        return merged

    def gauge_sum(self, name: str) -> "float | None":
        # NOT named .gauge(): the dfanalyze metrics census matches any
        # attribute call of that name with a literal first arg as a
        # series registration
        vals = self.gauge_values(name)
        if not vals:
            return None
        return sum(vals)

    def gauge_min(self, name: str) -> "float | None":
        """Min over the series' label children — the right reduction for
        per-model timestamp gauges (the STALEST model is the alarm; a
        sum of unix timestamps is a meaningless 3.4e9)."""
        vals = [v for v in self.gauge_values(name) if v > 0]
        if not vals:
            return None
        return min(vals)

    def gauge_values(self, name: str) -> "list[float]":
        return [v for k, v in self.gauges.items() if _series_name(k) == name]

    def stale(self, now: float) -> bool:
        return (now - self.last_report) > max(3 * self.interval_s, 5.0)


# -- SLO specs -----------------------------------------------------------


@dataclass
class SLOSpec:
    """One declarative objective. ``kind``:

    - ``ratio``: good/bad counter series; error_rate = bad/(good+bad).
    - ``latency``: a histogram series + threshold_s; error_rate =
      fraction of window observations above the threshold.
    - ``freshness``: a unix-timestamp gauge + threshold_s; error_rate is
      1.0 while (now - ts) exceeds the threshold, else 0.0.

    ``objective`` is the good-fraction target (e.g. 0.999 ⇒ 0.1% error
    budget); burn rate = error_rate / (1 - objective). Breach when BOTH
    windows burn above ``burn_threshold``."""

    name: str
    kind: str
    objective: float
    service: str = ""  # restrict to one reporting service ("" = all)
    good_series: str = ""
    bad_series: str = ""
    hist_series: str = ""
    gauge_series: str = ""
    threshold_s: float = 0.0
    fast_window: str = "5m"
    slow_window: str = "1h"
    burn_threshold: float = 1.0
    description: str = ""


def default_slos() -> "list[SLOSpec]":
    return [
        SLOSpec(
            name="download_success",
            kind="ratio",
            objective=0.99,
            service="scheduler",
            good_series="dragonfly_scheduler_download_peer_finished_total",
            bad_series="dragonfly_scheduler_download_peer_failure_total",
            description="peers finish their downloads",
        ),
        SLOSpec(
            name="announce_availability",
            kind="ratio",
            objective=0.99,
            service="scheduler",
            good_series="dragonfly_scheduler_announce_peer_total",
            bad_series="dragonfly_scheduler_announce_peer_failure_total",
            description="announce-plane RPCs succeed",
        ),
        SLOSpec(
            name="schedule_p99",
            kind="latency",
            objective=0.99,
            service="scheduler",
            hist_series="dragonfly_scheduler_schedule_duration_seconds",
            threshold_s=0.5,
            description="schedule decisions land under 500ms",
        ),
        SLOSpec(
            name="fit_freshness",
            kind="freshness",
            objective=0.9,
            service="trainer",
            gauge_series="dragonfly_trainer_last_fit_timestamp_seconds",
            threshold_s=14 * 24 * 3600.0,  # 2× the default train interval
            description="the parent-scorer fit is recent",
        ),
        SLOSpec(
            name="p2p_efficiency",
            kind="ratio",
            objective=0.5,
            service="daemon",
            # flow-ledger rollups (utils/flows): "good" bytes never
            # touched the origin (parent + dedup + local_cache), "bad"
            # bytes did (demand back-to-source + preheat seeding); the
            # ratio error_rate is the origin fraction, so burn > 1 ⇔
            # p2p efficiency below the 0.5 objective
            good_series="dragonfly_flow_p2p_bytes_total",
            bad_series="dragonfly_flow_origin_bytes_total",
            description="bytes are served from the swarm, not the origin",
        ),
    ]


@dataclass
class _SLOState:
    spec: SLOSpec
    breached: bool = False
    burn: dict = field(default_factory=dict)  # window -> burn rate
    since: float = 0.0


class TelemetryPlane:
    """The manager's aggregation point. Thread-safe: gRPC report
    handlers, REST snapshot reads, and /healthz sections all cross it."""

    # a reporter silent this long is dropped entirely: daemons bind
    # ephemeral ports, so every restart mints a new (service, instance)
    # key — without eviction a long-lived manager accumulates dead rows
    # (and their hour of buckets) forever. An hour keeps a killed member
    # visible as a kill on the dashboard, then forgets it.
    EVICT_AFTER_S = 3600.0
    # burn-rate math walks every reporter's buckets; inputs only change
    # at bucket granularity, so per-report evaluation is throttled and
    # snapshot() forces a fresh pass
    EVAL_INTERVAL_S = 5.0

    def __init__(self, slos: "list[SLOSpec] | None" = None):
        # reentrant: snapshot() evaluates SLOs under the same lock it
        # holds for the aggregate walk
        self._lock = threading.RLock()
        self._reporters: dict[tuple[str, str], _Reporter] = {}
        self._seen_services: set[str] = set()
        self._last_eval = 0.0
        self._slos = {
            s.name: _SLOState(spec=s)
            for s in (default_slos() if slos is None else slos)
        }

    # -- ingest ---------------------------------------------------------
    def apply(
        self,
        service: str,
        instance: str,
        shard: str,
        epoch: str,
        seq: int,
        interval_s: float,
        payload: dict,
        now: "float | None" = None,
    ) -> tuple[bool, int]:
        """Fold one report; → (registered, last_seq) for the ack."""
        now = time.time() if now is None else now
        key = (service, instance)
        with self._lock:
            rep = self._reporters.get(key)
            registered = rep is None or rep.epoch != epoch
            if registered:
                # fresh reporter / reporter restart / manager restart:
                # baseline only — fold() counts nothing on first sight
                rep = _Reporter(service, instance, shard, epoch)
                self._reporters[key] = rep
            elif seq <= rep.last_seq:
                # duplicate delivery (retry after a lost ack): cumulative
                # values make re-folding harmless, but skipping is free
                M.TELEMETRY_REPORTS_TOTAL.labels(service, "duplicate").inc()
                return rep.awaiting_full, rep.last_seq
            rep.last_seq = seq
            rep.last_report = now
            rep.shard = shard or rep.shard
            if interval_s > 0:
                rep.interval_s = interval_s
            # until a FULL payload lands, every push may be a
            # changed-only subset carrying history — unknown series are
            # baselined, never counted (known series still delta)
            rep.fold(payload, now, baseline_only=rep.awaiting_full)
            if payload.get("full"):
                rep.awaiting_full = False
            # keep answering registered=True until the full snapshot
            # arrives: a lost registration ack must not strand the
            # reporter changed-only forever
            registered = registered or rep.awaiting_full
            for key_, r in list(self._reporters.items()):
                if (now - r.last_report) > self.EVICT_AFTER_S:
                    del self._reporters[key_]
            self._seen_services.add(service)
            by_service = {svc: 0 for svc in self._seen_services}
            for (svc, _), r in self._reporters.items():
                by_service[svc] = by_service.get(svc, 0) + 1
        for svc, n in by_service.items():
            M.TELEMETRY_REPORTERS.labels(svc).set(n)
        M.TELEMETRY_REPORTS_TOTAL.labels(
            service, "registered" if registered else "applied"
        ).inc()
        # throttled: N reporters pushing must not re-walk every bucket
        # per report; snapshot() forces a fresh pass when queried
        self.evaluate_slos(now, force=False)
        return registered, seq

    # -- SLO engine -----------------------------------------------------
    def _error_rate(self, spec: SLOSpec, window_s: float, now: float) -> float:
        with self._lock:
            reps = [
                r
                for r in self._reporters.values()
                if not spec.service or r.service == spec.service
            ]
        if spec.kind == "ratio":
            good = sum(r.rate(spec.good_series, window_s, now) for r in reps)
            bad = sum(r.rate(spec.bad_series, window_s, now) for r in reps)
            total = good + bad
            return bad / total if total > 0 else 0.0
        if spec.kind == "latency":
            merged: dict[str, float] = {}
            for r in reps:
                for le, d in r.window_hist(spec.hist_series, window_s, now).items():
                    merged[le] = merged.get(le, 0.0) + d
            if not merged:
                return 0.0
            total = max(merged.values())
            below = 0.0
            for le, c in sorted(
                ((float("inf") if k == "+Inf" else float(k), v) for k, v in merged.items())
            ):
                if le <= spec.threshold_s:
                    below = max(below, c)
            return (total - below) / total if total > 0 else 0.0
        if spec.kind == "freshness":
            rates = []
            for r in reps:
                # min over label children: with per-model timestamps the
                # STALEST model is what burns the budget
                ts = r.gauge_min(spec.gauge_series)
                if ts is None:
                    continue  # never fit yet: no budget burned pre-launch
                rates.append(1.0 if (now - ts) > spec.threshold_s else 0.0)
            return max(rates) if rates else 0.0
        return 0.0

    def evaluate_slos(self, now: "float | None" = None, force: bool = True) -> None:
        now = time.time() if now is None else now
        transitions = []
        # the whole evaluation holds the plane lock (reentrant): burn
        # math walks reporter buckets that a concurrent apply() mutates
        with self._lock:
            if not force and (now - self._last_eval) < self.EVAL_INTERVAL_S:
                return
            self._last_eval = now
            states = list(self._slos.values())
            for st in states:
                spec = st.spec
                budget = max(1e-9, 1.0 - spec.objective)
                burns = {}
                for wname in (spec.fast_window, spec.slow_window):
                    err = self._error_rate(spec, WINDOWS_S[wname], now)
                    burns[wname] = err / budget
                    M.SLO_BURN_RATE.labels(spec.name, wname).set(
                        round(burns[wname], 4)
                    )
                breached = all(b > spec.burn_threshold for b in burns.values())
                M.SLO_BREACHED.labels(spec.name).set(1.0 if breached else 0.0)
                was = st.breached
                st.breached = breached
                st.burn = burns
                if breached and not was:
                    st.since = now
                transitions.append((spec, burns, was, breached))
        for spec, burns, was, breached in transitions:
            if breached and not was:
                EV_SLO_BURN(
                    slo=spec.name,
                    burn_fast=round(burns[spec.fast_window], 3),
                    burn_slow=round(burns[spec.slow_window], 3),
                    objective=spec.objective,
                    kind=spec.kind,
                )
                logger.warning(
                    "SLO %s breached: burn %s=%0.2fx %s=%0.2fx (objective %s)",
                    spec.name, spec.fast_window, burns[spec.fast_window],
                    spec.slow_window, burns[spec.slow_window], spec.objective,
                )
            elif was and not breached:
                EV_SLO_CLEAR(slo=spec.name)
                logger.info("SLO %s recovered", spec.name)

    # -- query surfaces -------------------------------------------------
    def health_section(self) -> dict:
        """The /healthz body's ``slo`` section (status-section hook in
        utils.metrics.MetricsServer). A burning SLO is degraded, not
        down — this never flips the 503."""
        # forced refresh, like snapshot(): liveness probes are the
        # cadence of a deploy (seconds apart), and the operator reading
        # /healthz mid-incident must see the current burn, not the last
        # throttled pass
        self.evaluate_slos()
        with self._lock:
            states = list(self._slos.values())
        return {
            "breached": sorted(s.spec.name for s in states if s.breached),
            "slos": {
                s.spec.name: {
                    "breached": s.breached,
                    "burn": {w: round(b, 3) for w, b in s.burn.items()},
                    "objective": s.spec.objective,
                }
                for s in states
            },
        }

    def snapshot(self, now: "float | None" = None) -> dict:
        """The /api/v1/telemetry body: per-service inventory, merged
        swarm table, per-shard and per-trainer/per-daemon windowed
        aggregates, the cluster rollup, and SLO state."""
        now = time.time() if now is None else now
        self.evaluate_slos(now)
        # the whole walk holds the (reentrant) lock: windowed reads
        # iterate reporter buckets that a concurrent apply() mutates
        with self._lock:
            return self._snapshot_locked(now)

    def _snapshot_locked(self, now: float) -> dict:
        reps = list(self._reporters.values())

        def rates(r: _Reporter, name: str) -> dict:
            return {
                w: round(r.rate(name, s, now), 2) for w, s in WINDOWS_S.items()
            }

        services = []
        swarms: dict[str, dict] = {}
        shards = []
        trainers = []
        daemons = []
        cluster_ops = {w: 0.0 for w in WINDOWS_S}
        cluster_peers = cluster_tasks = 0.0
        cluster_flow = {w: 0.0 for w in WINDOWS_S}
        cluster_flow_p2p = {w: 0.0 for w in WINDOWS_S}
        cluster_flow_origin = {w: 0.0 for w in WINDOWS_S}
        for r in reps:
            stale = r.stale(now)
            services.append(
                {
                    "service": r.service,
                    "instance": r.instance,
                    "shard": r.shard,
                    "stale": stale,
                    "age_s": round(now - r.last_report, 1),
                    "interval_s": r.interval_s,
                    "build": r.sections.get("build", {}),
                    "endpoints": r.sections.get("endpoints", {}),
                }
            )
            if r.service == "scheduler":
                ops = rates(r, "dragonfly_scheduler_schedule_total")
                if not stale:
                    for w in cluster_ops:
                        cluster_ops[w] += ops[w]
                peers = r.gauge_sum("dragonfly_scheduler_peers") or 0.0
                tasks = r.gauge_sum("dragonfly_scheduler_tasks") or 0.0
                if not stale:
                    cluster_peers += peers
                    cluster_tasks += tasks
                p99 = quantile_from_buckets(
                    r.window_hist(
                        "dragonfly_scheduler_schedule_duration_seconds",
                        WINDOWS_S["5m"],
                        now,
                    ),
                    0.99,
                )
                shard_row = {
                    "shard": r.shard or r.instance,
                    "instance": r.instance,
                    "stale": stale,
                    F_SHARD_SCHEDULE_OPS: ops,
                    F_SHARD_DECISION_P99: round(p99 * 1e3, 2),
                    F_SHARD_ANNOUNCE_OPS: rates(
                        r, "dragonfly_scheduler_announce_peer_total"
                    ),
                    F_SHARD_PEERS: peers,
                    F_SHARD_TASKS: tasks,
                }
                # swarm-observatory rollup: folded per shard so one
                # dfstat call shows swarm shape across the fleet
                rollup = r.sections.get("swarm_rollup") or {}
                if rollup:
                    shard_row[F_SHARD_SWARM_TASKS] = int(rollup.get("tasks", 0))
                    shard_row[F_SHARD_SWARM_PEERS] = int(rollup.get("peers", 0))
                    shard_row[F_SHARD_SWARM_DEPTHS] = dict(
                        rollup.get("depth_hist", {})
                    )
                    shard_row[F_SHARD_SWARM_STRAGGLERS] = int(
                        rollup.get("stragglers", 0)
                    ) + int(rollup.get("stuck", 0))
                shards.append(shard_row)
                if stale:
                    continue  # a dead shard's last swarm view is history
                for swarm in r.sections.get("swarms", []) or []:
                    tid = swarm.get("task_id", "")
                    if not tid:
                        continue
                    merged = swarms.setdefault(
                        tid,
                        {
                            "task_id": tid,
                            F_SWARM_PEERS: 0,
                            F_SWARM_SEEDERS: 0,
                            F_SWARM_DONE_PIECES: 0,
                            F_SWARM_TOTAL_PIECES: 0,
                            F_SWARM_STRAGGLERS: [],
                            "shards": [],
                        },
                    )
                    merged[F_SWARM_PEERS] += int(swarm.get("peers", 0))
                    merged[F_SWARM_SEEDERS] += int(swarm.get("seeders", 0))
                    merged[F_SWARM_DONE_PIECES] += int(swarm.get("done_pieces", 0))
                    merged[F_SWARM_TOTAL_PIECES] = max(
                        merged[F_SWARM_TOTAL_PIECES], int(swarm.get("total_pieces", 0))
                    )
                    merged[F_SWARM_STRAGGLERS] = (
                        merged[F_SWARM_STRAGGLERS] + list(swarm.get("stragglers", []))
                    )[:8]
                    merged["shards"].append(r.shard or r.instance)
            elif r.service == "trainer":
                fit_ts = r.gauge_min("dragonfly_trainer_last_fit_timestamp_seconds")
                trainers.append(
                    {
                        "instance": r.instance,
                        "stale": stale,
                        F_TRAINER_INGEST_RECORDS: rates(
                            r, "dragonfly_trainer_ingest_records_total"
                        ),
                        F_TRAINER_DATASET_BYTES: rates(
                            r, "dragonfly_trainer_dataset_bytes_total"
                        ),
                        F_TRAINER_FIT_FRESHNESS: (
                            round(now - fit_ts, 1) if fit_ts else None
                        ),
                    }
                )
            elif r.service == "daemon":
                flow = rates(r, "dragonfly_flow_bytes_total")
                flow_p2p = rates(r, "dragonfly_flow_p2p_bytes_total")
                flow_origin = rates(r, "dragonfly_flow_origin_bytes_total")
                if not stale:
                    for w in cluster_flow:
                        cluster_flow[w] += flow[w]
                        cluster_flow_p2p[w] += flow_p2p[w]
                        cluster_flow_origin[w] += flow_origin[w]
                daemons.append(
                    {
                        "instance": r.instance,
                        "stale": stale,
                        F_DAEMON_PIECE_BYTES: rates(
                            r, "dragonfly_daemon_piece_traffic_bytes_total"
                        ),
                        F_DAEMON_BACK_TO_SOURCE: rates(
                            r, "dragonfly_daemon_back_to_source_total"
                        ),
                        F_DAEMON_FLOW_BYTES: flow,
                        F_DAEMON_FLOW_P2P_BYTES: flow_p2p,
                        F_DAEMON_FLOW_ORIGIN_BYTES: flow_origin,
                        # per-plane provenance rollup as reported by the
                        # daemon's own ledger (utils/flows section)
                        "flows": r.sections.get("flows", {}),
                    }
                )
        return {
            "ts": now,
            "windows": sorted(WINDOWS_S, key=WINDOWS_S.get),
            "services": sorted(
                services, key=lambda s: (s["service"], s["instance"])
            ),
            "swarms": sorted(swarms.values(), key=lambda s: s["task_id"]),
            "shards": sorted(shards, key=lambda s: s["shard"]),
            "trainers": sorted(trainers, key=lambda t: t["instance"]),
            "daemons": sorted(daemons, key=lambda d: d["instance"]),
            "cluster": {
                F_CLUSTER_SCHEDULE_OPS: {
                    w: round(v, 2) for w, v in cluster_ops.items()
                },
                F_CLUSTER_PEERS: cluster_peers,
                F_CLUSTER_TASKS: cluster_tasks,
                F_CLUSTER_FLOW_BYTES: {
                    w: round(v, 2) for w, v in cluster_flow.items()
                },
                # good-byte fraction per window; None while the ledger
                # has moved nothing in that window
                F_CLUSTER_P2P_EFFICIENCY: {
                    w: (
                        round(
                            cluster_flow_p2p[w]
                            / (cluster_flow_p2p[w] + cluster_flow_origin[w]),
                            4,
                        )
                        if (cluster_flow_p2p[w] + cluster_flow_origin[w]) > 0
                        else None
                    )
                    for w in WINDOWS_S
                },
            },
            "slos": [
                {
                    "name": s.spec.name,
                    "kind": s.spec.kind,
                    "objective": s.spec.objective,
                    "description": s.spec.description,
                    F_SLO_BREACHED: s.breached,
                    "burn": {w: round(b, 3) for w, b in s.burn.items()},
                }
                for s in sorted(self._slos.values(), key=lambda s: s.spec.name)
            ],
        }


class TelemetryService:
    """The ReportTelemetry gRPC surface, bound on the manager's server
    next to the Manager/Diagnose services (one channel serves all)."""

    def __init__(self, plane: TelemetryPlane):
        self.plane = plane

    def ReportTelemetry(self, request, context):
        from dragonfly2_torch.rpc import protos

        telemetry_pb2 = protos.load("telemetry_pb2")

        try:
            payload = json.loads(request.payload_json or "{}")
            if not isinstance(payload, dict):
                raise TypeError("payload is not an object")
        except (ValueError, TypeError) as e:
            import grpc

            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad payload: {e}")
        registered, last_seq = self.plane.apply(
            service=request.service,
            instance=request.instance,
            shard=request.shard,
            epoch=request.epoch,
            seq=int(request.seq),
            interval_s=request.interval_s,
            payload=payload,
        )
        return telemetry_pb2.TelemetryAck(registered=registered, last_seq=last_seq)
