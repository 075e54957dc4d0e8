"""Seed-peer placement (counterpart of the reference's
``scheduler/seed_placement.py``).

A good seed peer is the host the rest of the fleet reaches fastest.
``recommend_seeds`` ranks candidates by the mean GNN-predicted
child→candidate RTT over the live probe graph; ``recommend_seeds_by_rtt``
by the topology engine's own inferred RTT centrality, with no model.
"""

from __future__ import annotations

from dragonfly2_torch.schema.columnar import records_to_columns
from dragonfly2_torch.schema.features import build_probe_graph
from dragonfly2_torch.trainer.serving import GNNScorer
from dragonfly2_torch.utils import dflog

logger = dflog.get("scheduler.seed_placement")


def recommend_seeds(
    networktopology,
    gnn_params,
    k: int = 3,
    candidates: "list[str] | None" = None,
    device="cuda",
) -> "list[dict]":
    """→ up to ``k`` ``{host_id, mean_predicted_rtt_log_ms}`` rows, best
    (lowest predicted RTT from the rest of the fleet) first.

    The graph is built from the LIVE probe state (the export the trainer's
    snapshot consumes) and embedded on ``device``; candidates outside the
    probe graph cannot be embedded and are skipped. An explicit empty
    candidate list raises rather than rank the whole fleet."""
    records = networktopology.export_records()
    if not records:
        return []
    graph = build_probe_graph(records_to_columns(records))
    if graph.num_nodes < 2:
        return []
    scorer = GNNScorer(gnn_params, graph, device=device)

    # an EXPLICIT empty candidate list means "none eligible" — ranking
    # the whole fleet instead would silently widen the caller's scope
    pool = candidates if candidates is not None else graph.node_ids
    hosts = [h for h in pool if scorer.has_host(h)]
    if candidates is not None and not hosts:
        raise ValueError(
            "no candidate host is in the probe graph yet"
            f" (candidates={candidates!r})"
        )
    scores: "list[tuple[float, str]]" = []
    for h in hosts:
        others = [o for o in graph.node_ids if o != h]
        if not others:
            continue
        pred = scorer.predict_rtt_log_ms(others, [h] * len(others))
        scores.append((float(pred.mean()), h))
    scores.sort()
    return [
        {"host_id": h, "mean_predicted_rtt_log_ms": round(s, 4)}
        for s, h in scores[:k]
    ]


def recommend_seeds_by_rtt(
    topology_engine,
    k: int = 3,
    candidates: "list[str] | None" = None,
) -> "list[dict]":
    """→ up to ``k`` ``{host_id, mean_rtt_ms}`` rows ranked by inferred RTT
    centrality: the mean landmark-inferred (or directly probed) RTT from
    every other host in the device adjacency. No trained model needed."""
    if topology_engine is None:
        return []
    ranking = topology_engine.centrality(candidates)
    if candidates is not None and not ranking:
        raise ValueError(
            "no candidate host is rankable: each is either absent from the"
            " device adjacency (never probed / not yet flushed) or has no"
            f" finite RTT path to the fleet (candidates={candidates!r})"
        )
    return ranking[:k]
