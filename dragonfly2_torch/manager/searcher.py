"""Searcher: pick the best scheduler cluster for a joining peer
(counterpart of the reference's ``manager/searcher.py``; upstream
manager/searcher/searcher.go:38-290).

Scoring weights: security/CIDR affinity 0.4, IDC 0.35, location 0.24,
cluster type (default bonus) 0.01 — upstream searcher.go:47-57.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field

CIDR_AFFINITY_WEIGHT = 0.4
IDC_AFFINITY_WEIGHT = 0.35
LOCATION_AFFINITY_WEIGHT = 0.24
CLUSTER_TYPE_WEIGHT = 0.01

MAX_LOCATION_ELEMENTS = 5


@dataclass
class ClusterScope:
    idc: str = ""  # "|"-separated alternatives
    location: str = ""
    cidrs: list[str] = field(default_factory=list)


@dataclass
class Cluster:
    id: int
    name: str
    scopes: ClusterScope = field(default_factory=ClusterScope)
    is_default: bool = False


@dataclass
class PeerInfo:
    ip: str = ""
    idc: str = ""
    location: str = ""


def cidr_affinity(ip: str, cidrs: list[str]) -> float:
    if not ip or not cidrs:
        return 0.0
    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return 0.0
    for cidr in cidrs:
        try:
            if addr in ipaddress.ip_network(cidr, strict=False):
                return 1.0
        except ValueError:
            continue
    return 0.0


def idc_affinity(peer_idc: str, cluster_idc: str) -> float:
    if not peer_idc or not cluster_idc:
        return 0.0
    alternatives = [x.lower() for x in cluster_idc.split("|")]
    return 1.0 if peer_idc.lower() in alternatives else 0.0


def location_affinity(peer_location: str, cluster_location: str) -> float:
    if not peer_location or not cluster_location:
        return 0.0
    pe = peer_location.split("|")
    ce = cluster_location.split("|")
    n = min(len(pe), len(ce), MAX_LOCATION_ELEMENTS)
    score = 0
    for i in range(n):
        if pe[i].lower() != ce[i].lower():
            break
        score += 1
    return score / MAX_LOCATION_ELEMENTS


class Searcher:
    def find_matching_cluster(
        self, clusters: list[Cluster], peer: PeerInfo
    ) -> Cluster | None:
        if not clusters:
            return None
        return max(clusters, key=lambda c: self.score(c, peer))

    def score(self, cluster: Cluster, peer: PeerInfo) -> float:
        return (
            CIDR_AFFINITY_WEIGHT * cidr_affinity(peer.ip, cluster.scopes.cidrs)
            + IDC_AFFINITY_WEIGHT * idc_affinity(peer.idc, cluster.scopes.idc)
            + LOCATION_AFFINITY_WEIGHT
            * location_affinity(peer.location, cluster.scopes.location)
            + CLUSTER_TYPE_WEIGHT * (1.0 if cluster.is_default else 0.0)
        )


def new_searcher() -> "Searcher":
    """Factory with the plugin seam (upstream manager/searcher uses
    dfplugin to swap the cluster-scoring algorithm)."""
    from dragonfly2_torch.utils.dfplugin import registry

    plugin = registry.searcher()
    return plugin if plugin is not None else Searcher()
