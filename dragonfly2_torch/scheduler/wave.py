"""Wave scheduling helpers: pack/unpack for scoring W decisions × C
candidates in one dispatch (counterpart of the reference's
``scheduler/wave.py``).

Ranking contract: sorting by (segment, score, row index) is exactly a
per-segment ``np.argsort(kind="stable")``. ``MLPScorer.predict_ranked``
computes the same permutation on the device.
"""

from __future__ import annotations

import numpy as np

from dragonfly2_torch.utils import flight, profiling

# phases: the wave feature pack (id intern + rtt gather + column assembly)
# and the wave score leg (submit → scores + rankings in hand)
PH_WAVE_PACK = profiling.phase_type("scheduler.wave_pack")
PH_WAVE_SCORE = profiling.phase_type("scheduler.wave_score")

# flight event: one record per evaluated wave (never per decision)
EV_WAVE = flight.event_type("scheduler.wave_evaluated")


def segment_ids(counts) -> np.ndarray:
    """[Σ counts] non-decreasing segment id per flattened row."""
    return np.repeat(
        np.arange(len(counts), dtype=np.int32),
        np.asarray(counts, dtype=np.int64),
    )


def rank_order(scores, seg) -> np.ndarray:
    """Global sort permutation of flat ``scores`` grouped by segment:
    segment first, then score ascending, then row index (the stable
    tie-break)."""
    scores = np.asarray(scores)
    return np.lexsort((np.arange(scores.shape[0]), scores, np.asarray(seg)))


def split_order(order, counts) -> "list[np.ndarray]":
    """Segment-grouped permutation → per-decision local rankings."""
    out = []
    off = 0
    order = np.asarray(order)
    for c in counts:
        c = int(c)
        out.append(order[off : off + c] - off)
        off += c
    return out


def rank_segments(scores, counts) -> "list[np.ndarray]":
    """Flat scores + per-decision counts → per-decision stable ascending
    rankings."""
    return split_order(rank_order(scores, segment_ids(counts)), counts)
