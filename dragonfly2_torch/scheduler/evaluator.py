"""Parent evaluators: rank candidate parents for a downloading peer
(counterpart of the reference's ``scheduler/evaluator.py``).

- ``BaseEvaluator`` — the hand-tuned linear score (upstream
  evaluator_base.go:32-104: weights piece 0.2, upload-success 0.2,
  free-upload 0.15, host-type 0.15, IDC 0.15, location 0.15) plus the
  statistical bad-node detector (mean×20 for n<30, mean+3σ otherwise,
  upstream evaluator_base.go:211-247).
- ``MLEvaluator`` — ranks parents by the trained MLP's predicted piece
  cost, built from the same live resource state the linear score reads.
  A wave of decisions is packed into one feature matrix (``rtt_affinity``
  joined on the device by the topology engine), scored by the batched
  scoring service or the per-call scorer, and falls back to the base
  score when no model is loaded or inference fails — visibly, rung by
  rung.
"""

from __future__ import annotations

import math
import statistics
import threading
from typing import Protocol

import numpy as np

from dragonfly2_torch.rpc import resilience
from dragonfly2_torch.scheduler import metrics as M
from dragonfly2_torch.scheduler import wave as wavelib
from dragonfly2_torch.scheduler.serving import ServingUnsupported
from dragonfly2_torch.schema.features import (
    MLP_FEATURE_DIM,
    location_affinity as offline_location_affinity,
)
from dragonfly2_torch.utils import dflog, flight, profiling, tracing
from dragonfly2_torch.utils.dfplugin import registry as plugin_registry

logger = dflog.get("scheduler.evaluator")

# degradation-ladder altitude: serving (the batched model) ranks above the
# per-call MLP, which ranks above the hand-tuned base score
_RUNG_ORDER = {"serving": 3, "mlp": 2, "base": 1}

# phase: the per-decision topology-engine lookup leg (one ledger
# entry per candidate batch, like the batch span below)
PH_TOPOLOGY_RTT = profiling.phase_type("scheduler.topology_rtt")

# per-decision "explain" record: the top-k candidates' predicted costs
# and full feature vectors (rtt_affinity included) — the evidence for
# WHY the model ranked a parent first, kept in the always-on ring so a
# misplaced-parent postmortem doesn't depend on a sampled trace
EV_EXPLAIN = flight.event_type("scheduler.evaluate_explain")
EXPLAIN_TOP_K = 4

# degradation-ladder rung drops (serving → per-call MLP → Base):
# edge-triggered — one event per transition, not one per decision
EV_SERVING_FALLBACK = flight.event_type("scheduler.serving_fallback")

from dragonfly2_torch.scheduler.resource import (
    PEER_STATE_FAILED,
    PEER_STATE_LEAVE,
    PEER_STATE_PENDING,
    PEER_STATE_RECEIVED_EMPTY,
    PEER_STATE_RECEIVED_NORMAL,
    PEER_STATE_RECEIVED_SMALL,
    PEER_STATE_RECEIVED_TINY,
    PEER_STATE_RUNNING,
    PEER_STATE_SUCCEEDED,
    HostType,
    Peer,
)

# feature weights (upstream evaluator_base.go:32-50)
FINISHED_PIECE_WEIGHT = 0.2
UPLOAD_SUCCESS_WEIGHT = 0.2
FREE_UPLOAD_WEIGHT = 0.15
HOST_TYPE_WEIGHT = 0.15
IDC_AFFINITY_WEIGHT = 0.15
LOCATION_AFFINITY_WEIGHT = 0.15

MAX_SCORE = 1.0
MIN_SCORE = 0.0

NORMAL_DISTRIBUTION_LEN = 30
MIN_AVAILABLE_COST_LEN = 2
MAX_ELEMENT_LEN = 5
AFFINITY_SEPARATOR = "|"

_BAD_STATES = (
    PEER_STATE_FAILED,
    PEER_STATE_LEAVE,
    PEER_STATE_PENDING,
    PEER_STATE_RECEIVED_TINY,
    PEER_STATE_RECEIVED_SMALL,
    PEER_STATE_RECEIVED_NORMAL,
    PEER_STATE_RECEIVED_EMPTY,
)


class Evaluator(Protocol):
    def evaluate_parents(
        self, parents: list[Peer], child: Peer, total_piece_count: int
    ) -> list[Peer]: ...

    def evaluate_wave(
        self,
        children: "list[Peer]",
        candidate_sets: "list[list[Peer]]",
        total_piece_counts: "list[int]",
    ) -> "list[list[Peer]]": ...

    def is_bad_node(self, peer: Peer) -> bool: ...


def piece_score(parent: Peer, child: Peer, total_piece_count: int) -> float:
    if total_piece_count > 0:
        return parent.finished_piece_count() / total_piece_count
    return float(parent.finished_piece_count() - child.finished_piece_count())


def upload_success_score(parent: Peer) -> float:
    uploads = parent.host.upload_count
    failed = parent.host.upload_failed_count
    if uploads < failed:
        return MIN_SCORE
    if uploads == 0 and failed == 0:
        return MAX_SCORE  # never scheduled → try it first
    return (uploads - failed) / uploads


def free_upload_score(parent: Peer) -> float:
    limit = parent.host.concurrent_upload_limit
    free = parent.host.free_upload_count()
    if limit > 0 and free > 0:
        return free / limit
    return MIN_SCORE


def host_type_score(parent: Peer) -> float:
    """Seed peers win for first-time downloads; steady-state favors
    dfdaemon peers (upstream evaluator_base.go:calculateHostTypeScore)."""
    if parent.host.type is not HostType.NORMAL:
        if parent.fsm.is_state(PEER_STATE_RECEIVED_NORMAL, PEER_STATE_RUNNING):
            return MAX_SCORE
        return MIN_SCORE
    return MAX_SCORE * 0.5


def idc_affinity_score(dst: str, src: str) -> float:
    if not dst or not src:
        return MIN_SCORE
    return MAX_SCORE if dst.lower() == src.lower() else MIN_SCORE


def location_affinity_score(dst: str, src: str) -> float:
    if not dst or not src:
        return MIN_SCORE
    if dst.lower() == src.lower():
        return MAX_SCORE
    de = dst.split(AFFINITY_SEPARATOR)
    se = src.split(AFFINITY_SEPARATOR)
    n = min(len(de), len(se), MAX_ELEMENT_LEN)
    score = 0
    for i in range(n):
        if de[i].lower() != se[i].lower():
            break
        score += 1
    return score / MAX_ELEMENT_LEN


class BaseEvaluator:
    def evaluate(self, parent: Peer, child: Peer, total_piece_count: int) -> float:
        return (
            FINISHED_PIECE_WEIGHT * piece_score(parent, child, total_piece_count)
            + UPLOAD_SUCCESS_WEIGHT * upload_success_score(parent)
            + FREE_UPLOAD_WEIGHT * free_upload_score(parent)
            + HOST_TYPE_WEIGHT * host_type_score(parent)
            + IDC_AFFINITY_WEIGHT
            * idc_affinity_score(parent.host.network.idc, child.host.network.idc)
            + LOCATION_AFFINITY_WEIGHT
            * location_affinity_score(
                parent.host.network.location, child.host.network.location
            )
        )

    def evaluate_parents(
        self, parents: list[Peer], child: Peer, total_piece_count: int
    ) -> list[Peer]:
        return sorted(
            parents,
            key=lambda p: self.evaluate(p, child, total_piece_count),
            reverse=True,
        )

    def evaluate_wave(
        self,
        children: "list[Peer]",
        candidate_sets: "list[list[Peer]]",
        total_piece_counts: "list[int]",
    ) -> "list[list[Peer]]":
        """Rank each decision's candidate set. The base score has no
        batch dispatch to amortize, so the wave is just the per-decision
        loop — the API exists so wave callers degrade uniformly."""
        return [
            self.evaluate_parents(ps, c, t)
            for c, ps, t in zip(children, candidate_sets, total_piece_counts)
        ]

    def is_bad_node(self, peer: Peer) -> bool:
        if peer.fsm.is_state(*_BAD_STATES):
            return True
        costs = peer.piece_costs()
        n = len(costs)
        if n < MIN_AVAILABLE_COST_LEN:
            return False
        last = costs[-1]
        mean = sum(costs[:-1]) / (n - 1)
        if n < NORMAL_DISTRIBUTION_LEN:
            return last > mean * 20
        stdev = statistics.pstdev(costs[:-1])
        return last > mean + 3 * stdev


class MLEvaluator(BaseEvaluator):
    """Ranks parents by the trained MLP's predicted piece cost — lower
    predicted cost sorts first. With a GRU installed, bad-node detection
    is model-based too: a parent whose latest piece cost blows far past
    the prediction from its own history is flagged (base statistics
    remain the fallback)."""

    # flag when the observed cost exceeds ~6× the PREDICTED cost. Tighter
    # than the base rule's blunt 20×-mean threshold on purpose: the
    # prediction is conditioned on the peer's own cost sequence, so
    # benign structure the statistics cannot separate (cold first
    # pieces, periodic slow chunks — which inflate the mean/σ and mask
    # real degradation) is explained away by the model, leaving a margin
    # that only genuine anomalies cross. 6× sits well above the GRU's
    # eval residual (~1.3× typical mae on log costs) and is validated by
    # the A/B harness's degrading-parent scenario: no false positives on
    # the benign pattern, detection where the statistical rule stays
    # blind (tools/ab_harness.py run_gru_ab).
    GRU_BAD_LOG_MARGIN = math.log(6.0)

    # verdict cache bound: cleared wholesale when exceeded (entries are
    # invalidated naturally by the piece count changing)
    GRU_CACHE_MAX = 4096

    # degraded-mode component name on /healthz + the
    # resilience_degraded_mode gauge
    DEGRADED_COMPONENT = "scheduler.evaluator"

    def __init__(self, model=None, gru=None, topology=None, serving=None):
        self._model = model  # trainer.serving.MLPScorer-compatible
        self._gru = gru  # trainer.serving.GRUScorer-compatible
        self._topology = topology  # topology.TopologyEngine-compatible
        self._serving = serving  # scheduler.serving.ScoringService
        self._degraded = False  # local edge detector: flag flips are rare
        self._rung = ""  # last ladder rung served (edge detector twin)
        # serializes rung transitions only: the steady state is one
        # unlocked string compare; without it two concurrent schedule
        # threads observing the same flip would both emit the event
        self._rung_lock = threading.Lock()
        # peer.id -> (piece_count, verdict): is_bad_node runs once per
        # candidate per scheduling attempt (per piece event), and a model
        # forward per call would multiply hot-path latency — the verdict
        # only changes when a new piece cost lands
        self._gru_verdicts: dict = {}
        super().__init__()

    def set_gru(self, gru) -> None:
        self._gru = gru
        self._gru_verdicts.clear()

    def set_topology(self, topology) -> None:
        self._topology = topology

    def set_serving(self, serving) -> None:
        self._serving = serving

    def _rtt_affinity(self, parent: Peer, child: Peer) -> float:
        """Topology-engine rtt_affinity for the pair, never fatal: an
        engine hiccup degrades the feature to its missing-value, not
        the schedule."""
        if self._topology is None:
            return 0.0
        try:
            return self._topology.rtt_affinity(child.host.id, parent.host.id)
        except Exception:
            logger.warning("topology rtt_affinity failed", exc_info=True)
            return 0.0

    def is_bad_node(self, peer: Peer) -> bool:
        if self._gru is None:
            return super().is_bad_node(peer)
        if peer.fsm.is_state(*_BAD_STATES):
            return True
        costs = peer.piece_costs()
        n = len(costs)
        if n < MIN_AVAILABLE_COST_LEN:
            return False
        cached = self._gru_verdicts.get(peer.id)
        if cached is not None and cached[0] == n:
            return cached[1]
        try:
            predicted = float(self._gru.predict_next_log_cost([costs[:-1]])[0])
            verdict = (
                math.log1p(max(costs[-1], 0.0)) > predicted + self.GRU_BAD_LOG_MARGIN
            )
        except Exception:
            logger.warning(
                "gru bad-node predict failed; using base statistics", exc_info=True
            )
            return super().is_bad_node(peer)
        if len(self._gru_verdicts) >= self.GRU_CACHE_MAX:
            self._gru_verdicts.clear()
        self._gru_verdicts[peer.id] = (n, verdict)
        return verdict

    def set_model(self, model) -> None:
        # a model trained against an older feature schema must be refused
        # LOUDLY at install time — a silent per-schedule fallback would
        # disable ML scheduling with no operator signal (the feature dim
        # changes when the schema grows, e.g. 12 → 18)
        dim = getattr(model, "feature_dim", None)
        if model is not None and dim is not None:
            if dim != MLP_FEATURE_DIM:
                logger.warning(
                    "rejecting model with feature_dim=%d (current schema is %d);"
                    " keeping %s — retrain to re-enable ML scheduling",
                    dim,
                    MLP_FEATURE_DIM,
                    "previous model" if self._model is not None else "base evaluator",
                )
                return
        self._model = model

    def _set_degraded(self, reason: "str | None") -> None:
        """Edge-triggered degraded-mode flag: a ladder fallback is a
        *visible* state (resilience registry → /healthz + gauge + flight
        event), not a silent ranking change. Only flips pay the registry
        lock; the steady state costs one predicate. ``_degraded`` holds
        the current reason so a reason CHANGE (serving-down → model-gone)
        re-registers instead of being swallowed by a boolean."""
        if reason == self._degraded or (reason is None and not self._degraded):
            return
        self._degraded = reason if reason is not None else False
        resilience.set_degraded(self.DEGRADED_COMPONENT, reason)

    def _note_rung(self, rung: str, reason: "str | None") -> None:
        """Record which ladder rung served this decision. Edge-triggered:
        a rung CHANGE emits one flight event (and counts a fallback when
        moving down), then the registry reason updates — steady state is
        one unlocked string compare per decision; only transitions pay
        the lock (and re-check under it, so concurrent schedule threads
        can't double-emit one flip)."""
        if rung != self._rung:
            with self._rung_lock:
                prev = self._rung
                if rung != prev:  # re-check: another thread may have won
                    self._rung = rung
                    if prev and _RUNG_ORDER.get(rung, 0) < _RUNG_ORDER.get(prev, 0):
                        M.SERVING_FALLBACK_TOTAL.labels(rung).inc()
                    EV_SERVING_FALLBACK(
                        from_rung=prev, to_rung=rung, reason=reason or ""
                    )
        self._set_degraded(reason)

    def evaluate_parents(
        self, parents: list[Peer], child: Peer, total_piece_count: int
    ) -> list[Peer]:
        # the degenerate W=1 wave: per-peer and wave rankings are
        # bit-identical BY CONSTRUCTION — one code path, not two kept
        # in sync (the wave tests still pin the equality)
        return self.evaluate_wave([child], [parents], [total_piece_count])[0]

    def evaluate_wave(
        self,
        children: "list[Peer]",
        candidate_sets: "list[list[Peer]]",
        total_piece_counts: "list[int]",
    ) -> "list[list[Peer]]":
        """Rank W decisions' candidate sets in ONE fused dispatch: the
        feature join packs every (child, candidate) pair into a single
        rung-padded ``(rows, F)`` matrix (rtt_affinity gathered from the
        device-resident landmark distances in one gather, not per-pair
        lock round-trips), the
        scoring service scores it as one batch, and per-decision
        rankings come back as a segment-grouped index permutation — no
        per-child host sort of C floats. The serving → MLP → base ladder
        applies PER DECISION: a decision the served model cannot take
        drops a rung alone."""
        W = len(children)
        if W == 0:
            return []
        serving = self._serving
        serving_up = serving is not None and serving.available()
        if self._model is None and not serving_up:
            self._note_rung("base", "no model loaded; base evaluator ranking")
            base_rank = super().evaluate_parents
            return [
                base_rank(ps, c, t)
                for c, ps, t in zip(children, candidate_sets, total_piece_counts)
            ]
        counts = [len(ps) for ps in candidate_sets]
        live = [j for j in range(W) if counts[j] > 0]
        results: "list" = [[] for _ in range(W)]
        if not live:
            return results
        with wavelib.PH_WAVE_PACK:
            try:
                feats, pairs = self._pack_wave(
                    children, candidate_sets, total_piece_counts
                )
            except Exception:
                # feature build failed: no rung can rank — base, visibly
                logger.warning(
                    "wave feature build failed; using base ranking",
                    exc_info=True,
                )
                self._note_rung(
                    "base", "feature build failed; base evaluator ranking"
                )
                base_rank = super().evaluate_parents
                for j in live:
                    results[j] = base_rank(
                        candidate_sets[j], children[j], total_piece_counts[j]
                    )
                return results
        live_counts = [counts[j] for j in live]
        # offsets of each live decision's rows in the packed matrix
        offs = np.concatenate(([0], np.cumsum(live_counts)))

        # the degradation ladder, PER DECISION: batched serving (the
        # resident model) → per-call MLP → Base. ``scored[i]`` is the
        # (costs, ranking) pair for live decision i, or None while a
        # lower rung still owes it a ranking.
        scored: "list" = [None] * len(live)
        per_request = False  # decisions skipped serving, not the service
        if serving_up:
            try:
                with wavelib.PH_WAVE_SCORE:
                    scored = serving.score_wave(
                        feats,
                        pairs,
                        live_counts,
                        budget_s=resilience.remaining_budget_s(),
                    )
                self._note_rung("serving", None)
                if any(r is None for r in scored):
                    # the served GNN couldn't embed SOME decisions'
                    # hosts: those drop a rung per-request (the service
                    # itself is healthy — no ladder flip)
                    per_request = True
            except ServingUnsupported as e:
                # NO decision in the wave can take the served model:
                # score the wave a rung down without flipping the
                # service-level ladder state — a brand-new host would
                # otherwise flap the edge detector at decision rate
                # until the next swap embeds it
                per_request = True
                logger.debug("serving cannot take this wave (%s)", e)
            except Exception as e:
                # expected under faults: one debug line, the
                # edge-triggered rung change is the operator signal
                logger.debug("serving wave score failed (%s); dropping a rung", e)
        demoted = [i for i, r in enumerate(scored) if r is None]
        served_any = len(demoted) < len(live)
        if demoted and self._model is not None:
            try:
                dem_counts = [live_counts[i] for i in demoted]
                dem_feats = np.concatenate(
                    [feats[offs[i] : offs[i + 1]] for i in demoted]
                )
                dem_costs = np.asarray(self._model.predict(dem_feats))
                dem_orders = wavelib.rank_segments(dem_costs, dem_counts)
                off = 0
                for i, c, rk in zip(demoted, dem_counts, dem_orders):
                    scored[i] = (dem_costs[off : off + c], rk)
                    off += c
                if not per_request and not served_any:
                    self._note_rung(
                        "mlp",
                        "serving unavailable; per-call mlp ranking"
                        if serving_up
                        else None,
                    )
            except Exception:
                # never fail scheduling because of the model — but say
                # so, or operators can't tell ML scheduling is off
                logger.warning(
                    "ml evaluator predict failed; using base ranking",
                    exc_info=True,
                )
        if any(r is None for r in scored) and not per_request and not served_any:
            self._note_rung("base", "ml predict failed; base evaluator ranking")

        sampled = tracing.is_sampling() or flight.dump_armed()
        base_rank = super().evaluate_parents
        for i, j in enumerate(live):
            ps = candidate_sets[j]
            if scored[i] is None:
                results[j] = base_rank(ps, children[j], total_piece_counts[j])
                continue
            costs, order = scored[i]
            results[j] = [ps[int(k)] for k in order]
            if flight.enabled():
                # per-decision explain event. The top-k payload (scores
                # + the full feature rows the model saw, schema order,
                # rtt_affinity last) is built ONLY when this decision's
                # trace is sampled or a flight dump is armed — at wave
                # rate the W×k list builds would dominate the pack.
                sub = feats[offs[i] : offs[i + 1]]
                EV_EXPLAIN(
                    peer_id=children[j].id,
                    task_id=children[j].task.id,
                    candidates=len(ps),
                    feature_dim=int(sub.shape[1]),
                    rung=self._rung,
                    top=[
                        {
                            "parent_id": ps[int(k)].id,
                            "predicted_log_cost": round(float(costs[int(k)]), 6),
                            "rtt_affinity": round(float(sub[int(k), -1]), 6),
                            "features": [round(float(v), 5) for v in sub[int(k)]],
                        }
                        for k in order[:EXPLAIN_TOP_K]
                    ]
                    if sampled
                    else [],
                )
        wavelib.EV_WAVE(
            decisions=W,
            rows=int(feats.shape[0]),
            demoted=len(demoted),
            rung=self._rung,
        )
        return results

    def _pack_wave(self, children, candidate_sets, total_piece_counts):
        """The wave's feature join: flatten the (child, candidate) pairs,
        gather ``rtt_affinity`` for ALL of them in one rung-padded device
        gather (the topology engine's), vectorize ``location_affinity``
        over the whole wave, then assemble the schema-ordered feature
        rows. Returns ``(feats [rows, F], pairs [(child, parent) ids])``
        with rows in decision order."""
        src, dst = [], []
        child_locs, parent_locs = [], []
        for c, ps in zip(children, candidate_sets):
            for p in ps:
                src.append(c.host.id)
                dst.append(p.host.id)
                child_locs.append(c.host.network.location)
                parent_locs.append(p.host.network.location)
        rtts = self._wave_rtt(src, dst)
        # one vectorized location-affinity call for the whole wave: the
        # per-pair form built two 1-element string arrays per candidate
        # per schedule op, which the numpy-fallback path paid per decision
        loc_aff = offline_location_affinity(
            np.array(child_locs), np.array(parent_locs)
        )
        rows = []
        k = 0
        for c, ps, t in zip(children, candidate_sets, total_piece_counts):
            for p in ps:
                rows.append(
                    pair_features(
                        p, c, t, float(rtts[k]), loc_affinity=float(loc_aff[k])
                    )
                )
                k += 1
        return np.stack(rows), list(zip(src, dst))

    def _wave_rtt(self, src: "list[str]", dst: "list[str]") -> np.ndarray:
        """[N] child→parent host-id pairs → [N] rtt_affinity in one
        engine batch (one lock hold + one device gather), never fatal: an
        engine hiccup degrades the feature to its missing-value, not the
        schedule. Stub topologies without the batch join fall back to
        the scalar per-pair lookup."""
        if self._topology is None or not src:
            return np.zeros(len(src), np.float32)
        # one span over the whole wave of engine lookups (a span per
        # pair would dominate the hot path)
        with tracing.maybe_span(
            "scheduler", "topology.rtt_affinity", pairs=len(src)
        ):
            with PH_TOPOLOGY_RTT:
                batch = getattr(self._topology, "rtt_affinity_pairs", None)
                if batch is not None:
                    try:
                        return np.asarray(batch(src, dst), np.float32)
                    except Exception:
                        logger.warning(
                            "topology rtt_affinity_pairs failed;"
                            " per-pair fallback",
                            exc_info=True,
                        )
                out = np.zeros(len(src), np.float32)
                for i, (s, d) in enumerate(zip(src, dst)):
                    try:
                        out[i] = self._topology.rtt_affinity(s, d)
                    except Exception:
                        logger.warning(
                            "topology rtt_affinity failed", exc_info=True
                        )
                return out


def pair_features(
    parent: Peer,
    child: Peer,
    total_piece_count: int,
    rtt_affinity: float = 0.0,
    loc_affinity: float | None = None,
) -> np.ndarray:
    """Live (child, parent) features in schema.features.MLP_FEATURE_NAMES
    order — must stay in lockstep with the offline extraction the model was
    trained on (schema/features.py). ``rtt_affinity`` is the topology
    engine's estimate for the child→parent pair (TopologyEngine.
    rtt_affinity); the 0.0 default is the schema's missing-value, which
    is also what offline extraction emits. ``loc_affinity`` lets a batch
    caller pass the vectorized ``location_affinity`` result instead of
    paying a per-pair 1-element array round trip; None computes it here
    (same math either way — the lockstep contract is with features.py)."""
    h = parent.host
    uploads, failed = h.upload_count, h.upload_failed_count
    child_idc, parent_idc = child.host.network.idc, h.network.idc
    child_loc, parent_loc = child.host.network.location, h.network.location
    # NB: these must match schema/features.extract_pair_features exactly
    # (the offline training regime): upload_success uses max(uploads, 1)
    # (fresh host → 0.0) and idc/location compare case-SENSITIVELY —
    # unlike the BaseEvaluator's hand-tuned score above.
    loc_aff = (
        float(
            offline_location_affinity(
                np.array([child_loc]), np.array([parent_loc])
            )[0]
        )
        if loc_affinity is None
        else loc_affinity
    )
    return np.array(
        [
            min(max(piece_score(parent, child, total_piece_count), 0.0), 1.0),
            (uploads - failed) / max(uploads, 1),
            min(max(h.free_upload_count() / h.concurrent_upload_limit, 0.0), 1.0)
            if h.concurrent_upload_limit > 0
            else 0.0,
            0.0 if h.type is HostType.NORMAL else 1.0,
            1.0 if (child_idc == parent_idc and parent_idc != "") else 0.0,
            loc_aff,
            h.cpu.percent / 100.0,
            h.memory.used_percent / 100.0,
            math.log1p(h.network.tcp_connection_count) / 10.0,
            math.log1p(h.network.upload_tcp_connection_count) / 10.0,
            h.disk.used_percent / 100.0,
            1.0 if parent.fsm.is_state(PEER_STATE_SUCCEEDED) else 0.0,
            h.cpu.process_percent / 100.0,
            h.memory.available / max(h.memory.total, 1),
            h.disk.inodes_used_percent / 100.0,
            child.host.cpu.percent / 100.0,
            child.host.memory.used_percent / 100.0,
            math.log1p(max(child.task.content_length, 0)) / 30.0,
            rtt_affinity,
        ],
        dtype=np.float32,
    )


def new_evaluator(algorithm: str = "default", model=None) -> Evaluator:
    """Factory (upstream evaluator.go:26-59: default | ml | plugin).
    Any other name is looked up in the plugin registry
    (utils/dfplugin); unknown names fall back to the base evaluator,
    mirroring upstream's fallthrough."""
    if algorithm == "ml":
        return MLEvaluator(model)
    if algorithm not in ("", "default"):
        plugin = plugin_registry.evaluator(algorithm)
        if plugin is not None:
            return plugin
    return BaseEvaluator()
