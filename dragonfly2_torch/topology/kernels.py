"""Topology array math over the padded adjacency, as PyTorch ops on the
engine's device (counterpart of the reference's ``topology/kernels.py``,
whose ``NumpyKernels`` is the spec): staleness decay, k-hop EWMA-RTT
aggregation, landmark min-plus RTT inference and the wave-join affinity
gather.

Distance math is linear milliseconds (min-plus composition adds RTTs);
aggregation math is log1p-ms. Index tensors may be int32 or int64.
"""

from __future__ import annotations

import torch

# distances at or above this are "no path" (float32-safe headroom)
INF_MS = 1e12


def _segment_sum(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, seg, data)


def _segment_min(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.full(
        (n,) + tuple(data.shape[1:]), INF_MS, dtype=data.dtype, device=data.device
    )
    index = seg.long().view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce_(0, index, data, "amin")


class TorchKernels:
    """The five topology kernels on tensors; every input lies on one
    device and the results stay there."""

    backend = "torch"

    def decay_weights(self, age_s, valid, half_life_s: float):
        """weight = valid · 2^(−age/half-life)."""
        return valid * torch.exp2(-age_s / half_life_s)

    def khop_rtt(self, edge_src, edge_dst, rtt_log_ms, weights, num_nodes: int, k: int):
        """[num_nodes] k-hop EWMA-RTT aggregate (log-ms): hop 0 is the
        weighted mean of a node's own out-edge RTTs, each further hop mixes
        in the neighbours' aggregate at 0.5; nodes with no fresh edge → 0."""
        w_rtt = _segment_sum(weights * rtt_log_ms, edge_src, num_nodes)
        w_tot = _segment_sum(weights, edge_src, num_nodes)
        h0 = w_rtt / torch.clamp_min(w_tot, 1e-9)
        has = (w_tot > 1e-9).float()
        h = h0 * has
        for _ in range(k):
            nbr = _segment_sum(weights * h[edge_dst], edge_src, num_nodes)
            nbr = nbr / torch.clamp_min(w_tot, 1e-9)
            h = (0.5 * h0 + 0.5 * nbr) * has
        return h

    def landmark_distances(
        self, edge_src, edge_dst, rtt_ms, weights,
        landmark_idx, landmark_valid, num_nodes: int, iters: int,
    ):
        """[num_nodes, L] min-plus distances to each landmark over the
        (symmetrized) fresh adjacency after ``iters`` relaxation rounds;
        unreached pairs stay INF_MS."""
        L = landmark_idx.shape[0]
        dev = rtt_ms.device
        cost = torch.where(
            weights > 0, rtt_ms, torch.tensor(INF_MS, dtype=torch.float32, device=dev)
        ).float()
        D = torch.full((num_nodes, L), INF_MS, dtype=torch.float32, device=dev)
        seed = torch.where(
            landmark_valid > 0,
            torch.tensor(0.0, device=dev),
            torch.tensor(INF_MS, dtype=torch.float32, device=dev),
        ).float()
        flat = landmark_idx.long() * L + torch.arange(L, device=dev)
        D.view(-1).scatter_reduce_(0, flat, seed, "amin")
        for _ in range(iters):
            cand = cost[:, None] + D[edge_dst]
            D = torch.minimum(D, _segment_min(cand, edge_src, num_nodes))
        return D

    def est_from_landmarks(self, D, src_idx, dst_idx):
        """est[i] = min_l D[src_i, l] + D[dst_i, l]  (linear ms)."""
        return (D[src_idx] + D[dst_idx]).amin(dim=-1)

    def gather_rtt_affinity(self, D, src_idx, dst_idx, direct_ms, has_direct, known):
        """[N] rtt_affinity: direct probe EWMAs (``direct_ms`` where
        ``has_direct``) win over the landmark estimate; log1p-ms/10, with
        0.0 for unknown hosts (``known`` ≤ 0) and no-path pairs."""
        est_ms = (D[src_idx] + D[dst_idx]).amin(dim=-1)
        ms = torch.where(has_direct > 0, direct_ms, est_ms)
        miss = (known <= 0) | ((has_direct <= 0) & (est_ms >= INF_MS / 2))
        aff = torch.log1p(torch.clamp_min(ms, 0.0)) / 10.0
        return torch.where(miss, torch.zeros_like(aff), aff).float()
