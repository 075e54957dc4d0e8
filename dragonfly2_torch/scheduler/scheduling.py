"""Scheduling algorithm: find candidate parents for downloading peers
(counterpart of the reference's ``scheduler/scheduling.py``).

Semantics track upstream Dragonfly2's v2 path (its
scheduler/scheduling/scheduling.go:383-424 FindCandidateParents and
:500-571 filterCandidateParents): the six filter rules — blocklist,
DAG-edge feasibility, same-host exclusion, bad-node, the in-degree/seed
"parent must itself be fed" rule, and free upload slots — then the
evaluator's ranking, cut to the candidate-parent limit. The wave form
filters each peer on the host and ranks the whole wave in one evaluator
dispatch. The retry loop that pushes decisions to a peer's stream
(``schedule_candidate_parents``) comes with the server slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from dragonfly2_torch.scheduler.evaluator import Evaluator
from dragonfly2_torch.scheduler.resource import (
    PEER_STATE_BACK_TO_SOURCE,
    PEER_STATE_RECEIVED_NORMAL,
    PEER_STATE_RUNNING,
    PEER_STATE_SUCCEEDED,
    HostType,
    Peer,
)
from dragonfly2_torch.utils import profiling, tracing

# phase: the evaluator leg of a decision (or of a whole wave)
PH_EVALUATE = profiling.phase_type("scheduler.evaluate")

# defaults (upstream scheduler/config/constants.go); the retry limits come
# with the retry loop
DEFAULT_FILTER_PARENT_LIMIT = 15
DEFAULT_CANDIDATE_PARENT_LIMIT = 4


@dataclass
class SchedulingConfig:
    filter_parent_limit: int = DEFAULT_FILTER_PARENT_LIMIT
    candidate_parent_limit: int = DEFAULT_CANDIDATE_PARENT_LIMIT


class Scheduling:
    def __init__(
        self,
        evaluator: Evaluator,
        config: SchedulingConfig | None = None,
        dynconfig=None,  # optional provider of live candidate/filter limits
    ):
        self.evaluator = evaluator
        self.config = config or SchedulingConfig()
        self.dynconfig = dynconfig

    # -- limits (dynconfig-overridable, upstream scheduling.go:405-413) ---
    def _candidate_parent_limit(self) -> int:
        if self.dynconfig is not None:
            v = getattr(self.dynconfig, "candidate_parent_limit", 0)
            if v and v > 0:
                return int(v)
        return self.config.candidate_parent_limit

    def _filter_parent_limit(self) -> int:
        if self.dynconfig is not None:
            v = getattr(self.dynconfig, "filter_parent_limit", 0)
            if v and v > 0:
                return int(v)
        return self.config.filter_parent_limit

    # -- finders ----------------------------------------------------------
    def find_candidate_parents(
        self, peer: Peer, blocklist: set[str] | None = None
    ) -> tuple[list[Peer], bool]:
        blocklist = blocklist or set()
        # only ReceivedNormal/Running peers reschedule; other states
        # (incl. BackToSource) are already placed
        if not peer.fsm.is_state(PEER_STATE_RECEIVED_NORMAL, PEER_STATE_RUNNING):
            return [], False

        candidates = self._filter_candidate_parents(peer, blocklist)
        if not candidates:
            return [], False

        total = peer.task.total_piece_count
        # duplicated call instead of maybe_span: the unsampled branch
        # then pays ONE predicate — not even the attrs dict build
        _e0 = time.perf_counter()
        if tracing.is_sampling():
            with tracing.get("scheduler").span("evaluate", candidates=len(candidates)):
                candidates = self.evaluator.evaluate_parents(candidates, peer, total)
        else:
            candidates = self.evaluator.evaluate_parents(candidates, peer, total)
        PH_EVALUATE.observe(time.perf_counter() - _e0)
        limit = self._candidate_parent_limit()
        return candidates[:limit], True

    def find_candidate_parents_wave(
        self, peers: "list[Peer]", blocklist: set[str] | None = None
    ) -> "list[tuple[list[Peer], bool]]":
        """The wave form of :meth:`find_candidate_parents`: filter each
        peer's candidates on host, then rank the WHOLE wave in one
        fused evaluator dispatch (``evaluate_wave``). Per-peer results
        keep :meth:`find_candidate_parents` semantics exactly — a peer
        in the wrong state or with nothing after filtering contributes
        ``([], False)`` without costing the wave a rung."""
        blocklist = blocklist or set()
        sets: "list[list[Peer]]" = []
        live: "list[int]" = []
        out: "list[tuple[list[Peer], bool]]" = [([], False)] * len(peers)
        for i, peer in enumerate(peers):
            if not peer.fsm.is_state(
                PEER_STATE_RECEIVED_NORMAL, PEER_STATE_RUNNING
            ):
                continue
            candidates = self._filter_candidate_parents(peer, blocklist)
            if not candidates:
                continue
            live.append(i)
            sets.append(candidates)
        if not live:
            return out
        children = [peers[i] for i in live]
        totals = [peers[i].task.total_piece_count for i in live]
        # plugin evaluators may predate the wave API — fall back to the
        # per-decision loop rather than failing the whole wave
        wave = getattr(self.evaluator, "evaluate_wave", None)
        _e0 = time.perf_counter()
        if tracing.is_sampling():
            with tracing.get("scheduler").span(
                "evaluate_wave",
                decisions=len(live),
                rows=sum(len(s) for s in sets),
            ):
                ranked = (
                    wave(children, sets, totals)
                    if wave is not None
                    else [
                        self.evaluator.evaluate_parents(s, c, t)
                        for c, s, t in zip(children, sets, totals)
                    ]
                )
        else:
            ranked = (
                wave(children, sets, totals)
                if wave is not None
                else [
                    self.evaluator.evaluate_parents(s, c, t)
                    for c, s, t in zip(children, sets, totals)
                ]
            )
        PH_EVALUATE.observe(time.perf_counter() - _e0)
        limit = self._candidate_parent_limit()
        for i, rk in zip(live, ranked):
            out[i] = (rk[:limit], True)
        return out

    def find_success_parent(
        self, peer: Peer, blocklist: set[str] | None = None
    ) -> Peer | None:
        if not peer.fsm.is_state(PEER_STATE_RUNNING):
            return None
        candidates = self._filter_candidate_parents(peer, blocklist or set())
        succeeded = [c for c in candidates if c.fsm.is_state(PEER_STATE_SUCCEEDED)]
        if not succeeded:
            return None
        total = peer.task.total_piece_count
        return self.evaluator.evaluate_parents(succeeded, peer, total)[0]

    def _filter_candidate_parents(self, peer: Peer, blocklist: set[str]) -> list[Peer]:
        """The six filter rules (upstream scheduling.go:500-571)."""
        out = []
        for cand in peer.task.load_random_peers(self._filter_parent_limit()):
            if cand.id in blocklist:
                continue
            # peer-side blocks (reported bad parents) are also respected
            if cand.id in peer.block_parents:
                continue
            if not peer.task.can_add_peer_edge(cand.id, peer.id):
                continue
            # two daemons on one host would download from each other
            if peer.host.id == cand.host.id:
                continue
            if self.evaluator.is_bad_node(cand):
                continue
            try:
                in_degree = peer.task.peer_in_degree(cand.id)
            except Exception:
                continue
            # a normal-host parent must itself be fed: have a parent, or be
            # back-to-source, or have finished
            if (
                cand.host.type is HostType.NORMAL
                and in_degree == 0
                and not cand.fsm.is_state(PEER_STATE_BACK_TO_SOURCE)
                and not cand.fsm.is_state(PEER_STATE_SUCCEEDED)
            ):
                continue
            if cand.host.free_upload_count() <= 0:
                continue
            out.append(cand)
        return out
