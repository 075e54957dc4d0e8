"""Batched scheduler inference: the scoring service (counterpart of the
reference's ``scheduler/serving.py``).

Concurrent schedule ops submit their candidate feature matrices to a
bounded queue; a dedicated ``scheduler.serving`` thread packs them into
micro-batches, scores each batch with ONE forward of the served model
(``MLPServed`` around ``trainer.serving.MLPScorer``, whose parameters stay
on the device and whose forwards pad to ``BUCKET_LADDER`` rungs), and
hands each waiting op its scores — within its deadline budget: an op whose
budget would expire in-queue is scored at once on the single-call path.

Hot-swap: ``install``/``clear`` replace the served model without dropping
in-flight work — the serving thread snapshots the model once per batch.

Degradation: any serving failure raises :class:`ServingError` to the
caller, and ``MLEvaluator`` drops one rung (serving → per-call MLP →
base) with edge-triggered visible state (resilience registry, flight
events, ``scheduler_serving_fallback_total``). The served-model protocol
is duck-typed on ``kind``: the GNN rung (``GNNServed``, a per-request
``supports`` check) comes with the GNN slice.

The service thread runs the model's forward itself, so every tensor the
scorer builds names its device explicitly (``torch.cuda.set_device`` is
per thread).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

from dragonfly2_torch.scheduler import metrics as M
from dragonfly2_torch.scheduler import wave as wavelib
from dragonfly2_torch.utils import dflog, faults, flight, profiling

logger = dflog.get("scheduler.serving")

# phases: per-request time from submission to scores-in-hand
# (queue wait + batch service), and per-batch pack+forward wall
PH_SERVING_WAIT = profiling.phase_type("scheduler.serving_wait")
PH_SERVING_BATCH = profiling.phase_type("scheduler.serving_batch")

# flight events: model hot-swaps and serving-path score failures (the
# per-decision explain/schedule events stay in evaluator/scheduling)
EV_SWAP = flight.event_type("scheduler.serving_swap")
EV_ERROR = flight.event_type("scheduler.serving_error")

# fault point: one serving-path score (batched or immediate) — chaos
# schedules inject errors/latency here to drive the evaluator down the
# serving → MLP → base ladder; single predicate when disarmed
FP_SCORE = faults.point("scheduler.serving_score")


class ServingError(Exception):
    """A serving-path failure the caller must absorb by dropping one
    rung on the degradation ladder — never by failing the schedule."""


class ServingUnsupported(ServingError):
    """THIS request can't take the served model (e.g. a GNN that never
    embedded one of the candidate hosts) — a per-request condition, not
    a service failure: the caller scores this decision one rung down
    WITHOUT flipping the service-level ladder state (a brand-new host
    would otherwise flap the edge-triggered rung at decision rate until
    the next swap embeds it)."""


@dataclass
class ServingConfig:
    # max time a submission waits for co-batching, measured from submit;
    # the deadline-aware cap below keeps it inside any smaller budget
    window_s: float = 0.002
    # pack target: stop gathering once a batch reaches this many rows
    # (the top bucket rung — bigger batches still score correctly, the
    # ladder rounds up in top-rung multiples)
    max_rows: int = 64
    # bounded submission queue: overflow degrades to the immediate path
    # rather than blocking a schedule op behind an unbounded backlog
    queue_depth: int = 256
    # budget floor: an op with less than (window + this) of deadline
    # left is scored immediately — waiting could expire it in-queue
    immediate_floor_s: float = 0.020
    # how long past the window a waiter allows for batch service before
    # declaring the serving path wedged and falling back a rung
    service_grace_s: float = 1.0


class MLPServed:
    """Feature-matrix rung: wraps an ``MLPScorer`` (it bucket-pads
    internally, so the packed batch dispatches at ladder shapes)."""

    def __init__(self, scorer, kind: str = "mlp"):
        self.kind = kind
        self._scorer = scorer

    @property
    def feature_dim(self):
        return getattr(self._scorer, "feature_dim", None)

    def supports(self, pairs) -> bool:
        return True

    def score(self, features: np.ndarray, pairs) -> np.ndarray:
        return np.asarray(self._scorer.predict(features))

    def score_ranked(self, features: np.ndarray, pairs, seg_ids):
        """(scores, segment-grouped rank permutation) for a packed wave
        batch. Fused on the device when the scorer has ``predict_ranked``
        (``MLPScorer``); otherwise one forward plus one host lexsort —
        same contract, same orders."""
        pr = getattr(self._scorer, "predict_ranked", None)
        if pr is not None:
            return pr(features, seg_ids)
        scores = self.score(features, pairs)
        return scores, wavelib.rank_order(scores, seg_ids)


class _Request:
    __slots__ = (
        "features", "pairs", "rows", "done", "scores", "error",
        "t_submit", "abandoned", "counts", "rankings",
    )

    def __init__(self, features: np.ndarray, pairs, counts=None):
        self.features = features
        self.pairs = pairs
        self.rows = features.shape[0]
        self.done = threading.Event()
        self.scores = None
        self.error: "Exception | None" = None
        self.t_submit = time.perf_counter()
        # wave request: per-decision candidate counts (Σ counts == rows)
        # — the batch loop ranks each decision's segment and hands back
        # per-decision index orders alongside the flat scores
        self.counts: "list[int] | None" = counts
        self.rankings: "list[np.ndarray] | None" = None
        # set by a caller whose wait timed out: the serving thread skips
        # abandoned requests at pack time — the caller already re-scored
        # those rows a rung down, and burning batch capacity on results
        # nobody reads would starve still-live requests exactly when the
        # serving thread is the bottleneck (plain GIL bool; the narrow
        # packed-just-before-abandon race only wastes one request's rows)
        self.abandoned = False


class ScoringService:
    """The persistent batched scorer. One per scheduler process,
    started/stopped with the server; ``score`` is called from every
    concurrent schedule op's thread."""

    def __init__(self, config: "ServingConfig | None" = None):
        self.cfg = config or ServingConfig()
        # (model, version) swapped with one reference assignment — the
        # loop snapshots it once per batch, so a swap never mixes models
        # inside a batch and never drops queued work
        self._served: "tuple | None" = None
        self._queue: "queue.Queue[_Request]" = queue.Queue(self.cfg.queue_depth)
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        # plain GIL ints (flight-dropbox discipline): occupancy math for
        # bench/stress without walking the Prometheus registry
        self.batches = 0
        self.rows_scored = 0
        self.waves = 0
        self.wave_rows = 0
        # recent per-wave unpack walls (µs) for bench percentiles;
        # bounded so a long soak never grows it past two pages
        self.wave_unpack_us: "list[float]" = []

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="scheduler.serving", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        # fail anything still queued: a stopping service must release
        # every waiter (they fall back a rung), never strand one
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = ServingError("scoring service stopped")
            req.done.set()

    def running(self) -> bool:
        return self._thread is not None and not self._stop.is_set()

    # -- model slot ----------------------------------------------------
    def install(self, model, version: str = "") -> None:
        """Hot-swap the served model. In-flight batches finish on the
        model they snapshotted; queued submissions score on this one."""
        prev = self._served
        self._served = (model, version)
        M.SERVING_SWAPS_TOTAL.labels(model.kind).inc()
        EV_SWAP(
            kind=model.kind,
            version=version,
            previous=(prev[0].kind if prev else ""),
        )
        logger.info(
            "serving model swapped to kind=%s version=%s", model.kind, version
        )

    def clear(self) -> None:
        if self._served is not None:
            self._served = None
            EV_SWAP(kind="", version="", previous="")
            logger.info("serving model withdrawn")

    def available(self) -> bool:
        return self._served is not None and self.running()

    def model_kind(self) -> str:
        served = self._served
        return served[0].kind if served else ""

    # -- the hot path --------------------------------------------------
    def score(
        self,
        features: np.ndarray,
        pairs=None,
        budget_s: "float | None" = None,
    ) -> np.ndarray:
        """[P, F] candidate features (+ (child, parent) host-id pairs)
        → [P] predicted costs, lower ranks first. Raises
        :class:`ServingError` on any serving-path failure — the caller
        drops one rung, the schedule never fails here."""
        served = self._served
        if served is None or not self.running():
            raise ServingError("scoring service has no model installed")
        model = served[0]
        if model.kind == "gnn" and not model.supports(pairs):
            # per-request support check BEFORE queueing: an unknown host
            # can't be embedded, so this decision takes the MLP rung
            # without burning a batch slot
            raise ServingUnsupported("gnn cannot embed this candidate set")
        cfg = self.cfg
        if budget_s is not None and budget_s <= cfg.window_s + cfg.immediate_floor_s:
            # the deadline would expire in-queue: single-call path, same
            # bucketed forward, no co-batching wait
            M.SERVING_SUBMITTED_TOTAL.labels("immediate").inc()
            return self._score_now(model, features, pairs)
        req = _Request(np.asarray(features, np.float32), pairs)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            # a full queue means the serving thread is the bottleneck
            # right now — adding latency on top would only expire
            # budgets; score inline and keep the op moving
            M.SERVING_SUBMITTED_TOTAL.labels("overflow").inc()
            return self._score_now(model, features, pairs)
        M.SERVING_SUBMITTED_TOTAL.labels("batched").inc()
        wait_s = cfg.window_s + cfg.service_grace_s
        if budget_s is not None:
            wait_s = min(wait_s, max(budget_s - cfg.immediate_floor_s / 2, 0.001))
        if not req.done.wait(timeout=wait_s):
            req.abandoned = True  # the loop skips it at pack time
            raise ServingError(f"serving did not answer within {wait_s:.3f}s")
        PH_SERVING_WAIT.observe(time.perf_counter() - req.t_submit)
        if req.error is not None:
            if isinstance(req.error, ServingError):
                raise req.error  # preserves the per-request/unsupported type
            raise ServingError(str(req.error)) from req.error
        return req.scores

    def score_wave(
        self,
        features: np.ndarray,
        pairs,
        counts,
        budget_s: "float | None" = None,
    ) -> "list":
        """Packed wave: [R, F] rows for W decisions whose per-decision
        candidate counts are ``counts`` (Σ counts == R) → a W-long list
        of ``(scores_j, ranking_j)`` — scores_j the decision's flat cost
        slice, ranking_j its stable ascending candidate order as INDICES
        (``wave.rank_segments`` contract). An entry is ``None`` when the
        served GNN cannot embed that decision's hosts: that decision
        alone drops a rung, the rest of the wave still packs. Raises
        :class:`ServingUnsupported` only when NO decision is servable,
        :class:`ServingError` on service failure — same ladder semantics
        as :meth:`score`."""
        served = self._served
        if served is None or not self.running():
            raise ServingError("scoring service has no model installed")
        model = served[0]
        counts = [int(c) for c in counts]
        features = np.asarray(features, np.float32)
        dropped: "list[int]" = []
        kept = list(range(len(counts)))
        eff_counts = counts
        if model.kind == "gnn":
            # per-decision support BEFORE queueing: one unembeddable
            # host inside a wave drops only that decision a rung
            kept, dropped = [], []
            sub_feats, sub_pairs, sub_counts = [], [], []
            off = 0
            for j, c in enumerate(counts):
                p = pairs[off : off + c]
                if model.supports(p):
                    kept.append(j)
                    sub_feats.append(features[off : off + c])
                    sub_pairs.extend(p)
                    sub_counts.append(c)
                else:
                    dropped.append(j)
                off += c
            if not kept:
                raise ServingUnsupported(
                    "gnn cannot embed any decision in this wave"
                )
            if dropped:
                features = np.concatenate(sub_feats)
                pairs = sub_pairs
                eff_counts = sub_counts
        cfg = self.cfg
        if budget_s is not None and budget_s <= cfg.window_s + cfg.immediate_floor_s:
            M.WAVE_DECISIONS_TOTAL.labels("immediate").inc(len(eff_counts))
            out = self._wave_now(model, features, pairs, eff_counts)
        else:
            req = _Request(features, pairs, counts=eff_counts)
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                M.WAVE_DECISIONS_TOTAL.labels("overflow").inc(len(eff_counts))
                out = self._wave_now(model, features, pairs, eff_counts)
            else:
                M.WAVE_DECISIONS_TOTAL.labels("batched").inc(len(eff_counts))
                wait_s = cfg.window_s + cfg.service_grace_s
                if budget_s is not None:
                    wait_s = min(
                        wait_s, max(budget_s - cfg.immediate_floor_s / 2, 0.001)
                    )
                if not req.done.wait(timeout=wait_s):
                    req.abandoned = True
                    raise ServingError(
                        f"serving did not answer within {wait_s:.3f}s"
                    )
                PH_SERVING_WAIT.observe(time.perf_counter() - req.t_submit)
                if req.error is not None:
                    if isinstance(req.error, ServingError):
                        raise req.error
                    raise ServingError(str(req.error)) from req.error
                out = []
                off = 0
                for c, rk in zip(eff_counts, req.rankings):
                    out.append((req.scores[off : off + c], rk))
                    off += c
        if not dropped:
            return out
        full: "list" = [None] * len(counts)
        for j, res in zip(kept, out):
            full[j] = res
        return full

    # -- internals -----------------------------------------------------
    def _wave_now(self, model, features, pairs, counts) -> "list":
        """Immediate/overflow escape for a wave: one bucketed forward,
        host segment rank — same orders as the fused path."""
        scores = self._score_now(model, features, pairs)
        t0 = time.perf_counter()
        rankings = wavelib.rank_segments(scores, counts)
        self._note_unpack(time.perf_counter() - t0)
        out = []
        off = 0
        for c, rk in zip(counts, rankings):
            out.append((scores[off : off + c], rk))
            off += c
        return out

    def _note_unpack(self, dt_s: float) -> None:
        M.WAVE_UNPACK_SECONDS.observe(dt_s)
        us = self.wave_unpack_us
        us.append(dt_s * 1e6)
        if len(us) > 4096:
            del us[:2048]

    def _score_now(self, model, features, pairs) -> np.ndarray:
        FP_SCORE()
        scores = model.score(np.asarray(features, np.float32), pairs)
        if scores.shape[0] != features.shape[0]:
            raise ServingError(
                f"served model returned {scores.shape[0]} scores for"
                f" {features.shape[0]} rows"
            )
        return scores

    def _loop(self) -> None:
        cfg = self.cfg
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first.abandoned:
                first.done.set()
                continue
            batch = [first]
            rows = first.rows
            # under load the queue IS the batch: drain everything already
            # waiting without sleeping — concurrency, not the window,
            # builds occupancy when decisions outpace the scorer
            while rows < cfg.max_rows:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt.abandoned:
                    nxt.done.set()
                    continue
                batch.append(nxt)
                rows += nxt.rows
            # light traffic: give stragglers up to the window, measured
            # from the FIRST submission so no request ever waits past
            # window_s for co-batching on top of its pickup lag
            pack_deadline = first.t_submit + cfg.window_s
            while rows < cfg.max_rows:
                remaining = pack_deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt.abandoned:
                    nxt.done.set()
                    continue
                batch.append(nxt)
                rows += nxt.rows
            M.SERVING_QUEUE_DEPTH.set(self._queue.qsize())
            self._score_batch(batch, rows)

    def _score_batch(self, batch: "list[_Request]", rows: int) -> None:
        with PH_SERVING_BATCH:
            served = self._served  # ONE model per batch (hot-swap safety)
            if served is None:
                err = ServingError("model withdrawn while queued")
                for req in batch:
                    req.error = err
                    req.done.set()
                M.SERVING_ERRORS_TOTAL.inc(len(batch))
                return
            model = served[0]
            if model.kind == "gnn":
                # per-request support: one unembeddable host fails that
                # request alone, the rest of the batch still scores
                scorable = [r for r in batch if model.supports(r.pairs)]
                for req in batch:
                    if req not in scorable:
                        req.error = ServingUnsupported(
                            "gnn cannot embed this candidate set"
                        )
                        req.done.set()
                        M.SERVING_ERRORS_TOTAL.inc()
                batch = scorable
                if not batch:
                    return
                rows = sum(r.rows for r in batch)
            has_wave = any(r.counts is not None for r in batch)
            try:
                FP_SCORE()
                if len(batch) == 1:
                    feats = batch[0].features
                    pairs = batch[0].pairs
                else:
                    feats = np.concatenate([r.features for r in batch])
                    pairs = (
                        [p for r in batch for p in (r.pairs or ())]
                        if any(r.pairs for r in batch)
                        else None
                    )
                order = None
                if has_wave:
                    # one GLOBAL segment vector over the packed matrix:
                    # each wave decision is its own segment, each plain
                    # request one singleton segment — the fused forward
                    # returns scores AND the segment-grouped rank
                    # permutation in the same dispatch (score_ranked),
                    # so no per-decision host sort ever happens
                    seg_parts = []
                    seg_off = 0
                    for r in batch:
                        cs = r.counts if r.counts is not None else [r.rows]
                        seg_parts.append(wavelib.segment_ids(cs) + seg_off)
                        seg_off += len(cs)
                    seg = np.concatenate(seg_parts)
                    sr = getattr(model, "score_ranked", None)
                    if sr is not None:
                        scores, order = sr(feats, pairs, seg)
                        scores = np.asarray(scores)
                        order = np.asarray(order)
                    else:
                        scores = np.asarray(model.score(feats, pairs))
                        order = wavelib.rank_order(scores, seg)
                else:
                    scores = model.score(feats, pairs)
                if scores.shape[0] != rows:
                    raise ServingError(
                        f"served model returned {scores.shape[0]} scores"
                        f" for {rows} rows"
                    )
            except Exception as e:
                EV_ERROR(kind=model.kind, batch=len(batch), error=str(e)[:200])
                M.SERVING_ERRORS_TOTAL.inc(len(batch))
                for req in batch:
                    req.error = e
                    req.done.set()
                return
            M.SERVING_BATCHES_TOTAL.inc()
            M.SERVING_BATCH_OCCUPANCY.observe(rows)
            self.batches += 1
            self.rows_scored += rows
            if has_wave:
                M.WAVE_OCCUPANCY_ROWS.observe(rows)
                self.waves += 1
                self.wave_rows += rows
            off = 0
            for req in batch:
                req.scores = scores[off : off + req.rows]
                if req.counts is not None:
                    # the request's rows are one contiguous run of
                    # segments, so its slice of the global permutation
                    # is already its local segment-grouped order
                    t0 = time.perf_counter()
                    local = order[off : off + req.rows] - off
                    req.rankings = wavelib.split_order(local, req.counts)
                    self._note_unpack(time.perf_counter() - t0)
                off += req.rows
                req.done.set()

    # -- introspection (flight probe, bench) ---------------------------
    def snapshot(self) -> dict:
        served = self._served
        return {
            "running": self.running(),
            "model_kind": served[0].kind if served else "",
            "model_version": served[1] if served else "",
            "queue_depth": self._queue.qsize(),
            "window_ms": self.cfg.window_s * 1e3,
            "max_rows": self.cfg.max_rows,
            "batches": self.batches,
            "rows_scored": self.rows_scored,
            "batch_occupancy": (
                round(self.rows_scored / self.batches, 2) if self.batches else 0.0
            ),
            "waves": self.waves,
            "wave_rows": self.wave_rows,
            "wave_occupancy_rows": (
                round(self.wave_rows / self.waves, 2) if self.waves else 0.0
            ),
        }
