"""Topology query gRPC service: operators (and tooling) read the
device-resident probe adjacency — est_rtt between any two hosts,
nearest neighbors, graph stats — without touching the KV store or
waiting for a snapshot."""

from __future__ import annotations

from dragonfly2_torch.rpc import protos
from dragonfly2_torch.rpc.glue import TOPOLOGY_SERVICE as SERVICE_NAME  # noqa: F401

topology_pb2 = protos.load("topology_pb2")


class TopologyService:
    def __init__(self, engine):
        self.engine = engine  # topology.TopologyEngine

    def EstRtt(self, request, context):
        # direct-vs-inferred provenance matters operationally (an
        # inferred estimate says "probe this pair to confirm"); the
        # engine resolves value + provenance under one lock so they
        # can't disagree across a concurrent flush or delete
        rtt, source = self.engine.est_rtt_detail(
            request.src_host_id, request.dest_host_id
        )
        if rtt is None:
            return topology_pb2.EstRttResponse(found=False)
        return topology_pb2.EstRttResponse(found=True, rtt_ns=int(rtt), source=source)

    def Neighbors(self, request, context):
        limit = request.limit or 32
        return topology_pb2.NeighborsResponse(
            neighbors=[
                topology_pb2.Neighbor(
                    host_id=n["host_id"],
                    avg_rtt_ns=n["avg_rtt_ns"],
                    age_s=n["age_s"],
                )
                for n in self.engine.neighbors(request.host_id, limit)
            ]
        )

    def Stats(self, request, context):
        s = self.engine.stats()
        return topology_pb2.StatsResponse(
            hosts=s["hosts"],
            edges=s["edges"],
            pending_deltas=s["pending_deltas"],
            flushes=s["flushes"],
            landmarks=s["landmarks"],
            cache_hit_rate=s["cache_hit_rate"],
            backend=s["backend"],
            query_p50_ms=s["query_p50_ms"],
        )
