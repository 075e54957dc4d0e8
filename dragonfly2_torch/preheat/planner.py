"""Preheat planner: forecast-hot tasks → RTT-central seed placement
(counterpart of the reference's ``preheat/planner.py``).

A sweep: demand window snapshot → GRU forecast on the card → rank
against what seed peers already hold → pick RTT-central seeds
(``recommend_seeds_by_rtt``) → one budget-capped ``preheat`` job. With a
manager attached the job rides the queue of record (``CreateJob``, its
request built by a request factory: ``ProtoRequests`` by default,
``PlainRequests`` for a stand-in) so any scheduler in the cluster may run
it; without one the planner executes it inline through ``job_worker``,
any object with the scheduler JobWorker's ``execute_now(job_type, args)
→ (state, result)``.

One sweep is ONE trace — ``preheat.sweep`` parenting the forecast, plan
and job spans (and, inline, the seed-trigger span the JobWorker opens)
— so the whole forecast→place decision renders as a single timeline.

Lock shape: the planner's own lock guards only its recently-planned
bookkeeping and is never held across calls into the demand window, the
forecaster, or the resource model (each has its own lock).
"""

from __future__ import annotations

import json
import re
import threading
import time

from dragonfly2_torch.scheduler import metrics as M
from dragonfly2_torch.scheduler.model_refresher import ProtoRequests
from dragonfly2_torch.scheduler.seed_placement import recommend_seeds_by_rtt
from dragonfly2_torch.utils import dflog, faults, flight, profiling, tracing
from dragonfly2_torch.utils.idgen import URLMeta, task_id_v1

logger = dflog.get("preheat.planner")

PT_PLAN = faults.point("preheat.plan")

EV_SWEEP = flight.event_type("preheat.sweep")
EV_JOB = flight.event_type("preheat.job")
EV_SKIP = flight.event_type("preheat.skip")

PH_SWEEP = profiling.phase_type("preheat.sweep")
PH_FORECAST = profiling.phase_type("preheat.forecast")
PH_PLAN = profiling.phase_type("preheat.plan")
PH_RANK = profiling.phase_type("preheat.rank")
PH_PLACE = profiling.phase_type("preheat.place")
PH_FIT = profiling.phase_type("preheat.fit")

# a demand-series key that IS a v1 task id (sha256 hex) — record-sourced
# and p2p-layer-sourced series are keyed on the demanded task's real id;
# anything else (e.g. a bare layer digest) needs the id derived from the
# series' url + meta, exactly as the seed daemon will derive it
_TASK_ID_RX = re.compile(r"^[0-9a-f]{64}$")

DEFAULT_INTERVAL_S = 30.0
DEFAULT_BUDGET = 4
DEFAULT_MIN_SCORE = 1.0
DEFAULT_REFIT_EVERY = 8
DEFAULT_COOLDOWN_S = 120.0


class PreheatPlanner:
    """Recurring forecast→place sweep over a demand window."""

    def __init__(
        self,
        demand,  # preheat.demand.DemandWindow
        forecaster,  # preheat.forecast.DemandForecaster
        resource=None,  # scheduler resource (task_manager consulted)
        job_worker=None,  # anything with execute_now (inline execution)
        manager_client=None,  # the manager's client (queue of record)
        topology=None,  # networktopology (engine ranks seeds)
        seed_client=None,  # resource seed-peer client (inflight dedupe)
        cluster_id: int = 0,
        interval_s: float = DEFAULT_INTERVAL_S,
        budget_per_sweep: int = DEFAULT_BUDGET,
        min_score: float = DEFAULT_MIN_SCORE,
        refit_every: int = DEFAULT_REFIT_EVERY,
        cooldown_s: float = DEFAULT_COOLDOWN_S,
        seed_k: int = 3,
        requests=None,  # ProtoRequests (default) or PlainRequests
    ):
        self.demand = demand
        self.forecaster = forecaster
        self.resource = resource
        self.job_worker = job_worker
        self.manager = manager_client
        self.topology = topology
        self.seed_client = seed_client
        self.cluster_id = cluster_id
        self.interval_s = float(interval_s)
        self.budget_per_sweep = int(budget_per_sweep)
        self.min_score = float(min_score)
        self.refit_every = max(1, int(refit_every))
        self.cooldown_s = float(cooldown_s)
        self.seed_k = int(seed_k)
        self.requests = requests if requests is not None else ProtoRequests()
        self.sweeps = 0
        self.jobs = 0
        self.tasks_planned = 0
        self.refits_async = 0
        self.refits_skipped = 0
        self._planned_at: dict[str, float] = {}  # task -> last plan time
        self._lock = threading.Lock()
        # single-flight guard for the off-thread refit: at most one fit
        # in flight; a sweep that finds it busy skips (the next refit
        # boundary retrains on fresher data anyway)
        self._refit_flight = threading.Lock()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="preheat.planner", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sweep_once()
            except Exception as e:
                logger.warning("preheat sweep failed: %s", e)

    # -- the sweep ---------------------------------------------------------
    def sweep_once(self, now: "float | None" = None) -> dict:
        """One forecast→plan→job pass; returns the sweep's accounting
        (also the test/soak entrypoint). Never raises: an armed
        ``preheat.plan`` fault or a dead manager lands in the ``error``
        outcome, not in the caller."""
        t0 = time.perf_counter()
        now = time.time() if now is None else now
        tracer = tracing.get("preheat")
        out = {"forecast": 0, "planned": 0, "jobs": 0, "triggered": 0, "skipped": 0}
        with PH_SWEEP, tracer.span("preheat.sweep", interval_s=self.interval_s) as sweep:
            try:
                scored = self._forecast(tracer, now, out)
                plan = self._plan(tracer, scored, now, out)
                if plan:
                    self._submit(tracer, plan, out)
                outcome = "planned" if plan else "empty"
            except Exception as e:
                logger.warning("preheat sweep error: %s", e)
                sweep.set(error=str(e))
                outcome = "error"
            self.sweeps += 1
            sweep.set(outcome=outcome, **{k: out[k] for k in ("forecast", "planned")})
        M.PREHEAT_SWEEPS_TOTAL.labels(outcome).inc()
        dt = time.perf_counter() - t0
        M.PREHEAT_SWEEP_SECONDS.observe(dt)
        EV_SWEEP(outcome=outcome, seconds=round(dt, 6), **out)
        out["outcome"] = outcome
        out["seconds"] = dt
        return out

    def _forecast(self, tracer, now: float, out: dict) -> list:
        """Demand snapshot → [(score, task_id, url)], hottest first."""
        with PH_FORECAST, tracer.span("preheat.forecast") as span:
            ids, urls, series = self.demand.series_batch(now=now)
            if len(ids) >= self.forecaster.min_examples:
                if not self.forecaster.ready:
                    # the FIRST fit stays inline: the forecast below
                    # needs a model, and a cold planner has no forecast
                    # quality to protect from the fit's latency
                    with PH_FIT:
                        self.forecaster.fit(series)
                elif self.sweeps % self.refit_every == 0:
                    # periodic refits move off the sweep thread: a slow
                    # fit must not delay a sweep tick (the forecaster
                    # swaps params atomically under its own lock)
                    self._refit_async(series)
            scores = self.forecaster.forecast_demand(series)
            out["forecast"] = len(ids)
            span.set(tasks=len(ids), ready=self.forecaster.ready)
        ranked = sorted(zip(scores, ids, urls), key=lambda r: -float(r[0]))
        return [(float(s), tid, url) for s, tid, url in ranked]

    def _refit_async(self, series) -> None:
        """Single-flight off-thread refit; a sweep finding one already
        in flight skips rather than queueing (bounded work, and the
        next boundary's snapshot is fresher)."""
        if not self._refit_flight.acquire(blocking=False):
            self.refits_skipped += 1
            return

        def run() -> None:
            try:
                with PH_FIT:
                    self.forecaster.fit(series)
            except Exception as e:
                logger.warning("preheat refit failed: %s", e)
            finally:
                self._refit_flight.release()

        self.refits_async += 1
        threading.Thread(target=run, name="preheat.refit", daemon=True).start()

    def _plan(self, tracer, scored: list, now: float, out: dict) -> list:
        """Budget-capped pick of forecast-hot tasks no seed already
        holds; resolves the RTT-central seed ranking alongside so the
        job (and the trace) carries the placement decision."""
        with PH_PLAN, tracer.span("preheat.plan", budget=self.budget_per_sweep) as span:
            PT_PLAN()  # fault point: a failing plan must not kill the loop
            picked: list = []
            for score, task_id, url in scored:
                if len(picked) >= self.budget_per_sweep:
                    self._skip(out, "budget")
                    break
                if score < self.min_score:
                    break  # ranked: everything after is colder still
                if not url:
                    self._skip(out, "no_url")
                    continue
                spec = self._trigger_spec(task_id, url)
                reason = self._already_covered(task_id, spec["task_id"], now)
                if reason:
                    self._skip(out, reason)
                    continue
                picked.append((score, task_id, spec))
            seeds = self._rank_seeds() if picked else []
            out["planned"] = len(picked)
            span.set(planned=len(picked), seeds=len(seeds))
            if picked:
                with self._lock:
                    for _, task_id, _ in picked:
                        self._planned_at[task_id] = now
                    # cooldown map stays bounded by its own horizon
                    floor = now - 2 * self.cooldown_s
                    for tid in [
                        t for t, at in self._planned_at.items() if at < floor
                    ]:
                        del self._planned_at[tid]
                self.tasks_planned += len(picked)
                M.PREHEAT_TASKS_PLANNED_TOTAL.inc(len(picked))
        return [{"picked": picked, "seeds": seeds}] if picked else []

    def _trigger_spec(self, series_key: str, url: str) -> dict:
        """The exact trigger the preheat job must replay for this series:
        the demanded task's id plus the URLMeta context it was derived
        from. Record- and p2p-layer-sourced series are keyed on the real
        task id already; anything else (bare layer digest) derives it
        from url + meta exactly as the seed daemon will — a preheat that
        recomputed the id under planner-private tag/application would
        seed a swarm no demanded client ever joins."""
        meta = self.demand.meta_for(series_key)
        if _TASK_ID_RX.fullmatch(series_key):
            task_id = series_key
        else:
            task_id = task_id_v1(
                url,
                URLMeta(
                    tag=meta.get("tag", ""),
                    application=meta.get("application", ""),
                    filter=meta.get("filter", ""),
                    range=meta.get("range", ""),
                    digest=meta.get("digest", ""),
                ),
            )
        return {"task_id": task_id, "url": url, **meta}

    def _already_covered(self, series_key: str, task_id: str, now: float) -> str:
        """Non-empty reason when preheating this series would waste the
        budget: a seed peer already holds it, a seed download is in
        flight, or this planner placed it within the cooldown. The
        inflight/held lookups use ``task_id`` — the id the preheat job
        actually triggers (and the seed registers) under — while the
        cooldown keys on the demand series."""
        with self._lock:
            at = self._planned_at.get(series_key)
        if at is not None and now - at < self.cooldown_s:
            return "cooldown"
        if self.seed_client is not None and self.seed_client.is_inflight(task_id):
            return "inflight"
        if self.resource is not None:
            task = self.resource.task_manager.load(task_id)
            if task is not None and task.load_seed_peer() is not None:
                return "held"
        return ""

    def _rank_seeds(self) -> list:
        """RTT-central seed ranking from the topology engine's landmark
        centrality — advisory placement context on the job (the seed
        client still spreads by task-id hash among seed hosts)."""
        engine = getattr(self.topology, "engine", None) if self.topology else None
        if engine is None:
            return []
        with PH_RANK:
            try:
                return recommend_seeds_by_rtt(engine, k=self.seed_k)
            except Exception as e:
                logger.debug("seed ranking unavailable: %s", e)
                return []

    def _submit(self, tracer, plan: list, out: dict) -> None:
        """One ``preheat`` job per sweep carrying the whole pick, through
        the queue of record when a manager is attached, else inline
        through the JobWorker."""
        picked = plan[0]["picked"]
        seeds = plan[0]["seeds"]
        # per-task trigger specs carry the DEMANDED task's id + URLMeta
        # context — tag/application participate in task_id_v1, so a
        # planner-stamped tag would seed a swarm no demanded client joins
        args = {
            "tasks": [spec for _, _, spec in picked],
            "urls": [spec["url"] for _, _, spec in picked],
            "seed_ranking": seeds,
            "scores": {tid: round(s, 4) for s, tid, _ in picked},
        }
        with PH_PLACE, tracer.span("preheat.job", urls=len(args["urls"])) as span:
            if self.manager is not None:
                outcome = self._submit_manager(args, span)
            elif self.job_worker is not None:
                outcome = self._submit_inline(args, span)
            else:
                outcome = "failed"
                span.set(error="no job path (manager or job_worker required)")
            self.jobs += 1
            out["jobs"] += 1
        M.PREHEAT_JOBS_TOTAL.labels(outcome).inc()
        EV_JOB(outcome=outcome, urls=len(args["urls"]), seeds=len(seeds))
        if outcome != "succeeded":
            # a refused job must not burn the cooldown for its tasks —
            # the next sweep should retry them against live seeds
            with self._lock:
                for _, task_id, _ in picked:
                    self._planned_at.pop(task_id, None)
        else:
            out["triggered"] += len(args["urls"])

    def _submit_manager(self, args: dict, span) -> str:
        try:
            job = self.manager.CreateJob(
                self.requests.create_job("preheat", json.dumps(args), self.cluster_id)
            )
            span.set(path="manager", job_id=job.id)
            return "succeeded"
        except Exception as e:
            logger.warning("preheat CreateJob failed: %s", e)
            span.set(path="manager", error=str(e))
            return "failed"

    def _submit_inline(self, args: dict, span) -> str:
        state, result = self.job_worker.execute_now("preheat", args)
        span.set(path="inline", state=state, count=result.get("count", 0))
        return "succeeded" if state == "succeeded" else "failed"

    @staticmethod
    def _skip(out: dict, reason: str) -> None:
        out["skipped"] += 1
        M.PREHEAT_SKIPPED_TOTAL.labels(reason).inc()
        EV_SKIP(reason=reason)

    # -- observability -----------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            cooling = len(self._planned_at)
        return {
            "sweeps": self.sweeps,
            "jobs": self.jobs,
            "tasks_planned": self.tasks_planned,
            "refits_async": self.refits_async,
            "refits_skipped": self.refits_skipped,
            "cooling": cooling,
            "interval_s": self.interval_s,
            "budget_per_sweep": self.budget_per_sweep,
            "demand": self.demand.stats(),
            "forecaster": self.forecaster.stats(),
        }
