"""Neighbor aggregation for graph neural networks (counterpart of the
fixed-degree half of the reference's ``ops/segment.py``; its edge-list
segment ops have no caller on the port's paths yet).

The [N, K] sampled-neighbor table from ``schema.features`` turns
aggregation into a dense gather + masked mean with static shapes.
"""

from __future__ import annotations

import torch


def gather_neighbors(features: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """[N, F] features + [N, K] int neighbor table → [N, K, F]."""
    return features[neighbors.long()]


def masked_mean(values: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Mean over ``dim`` counting only mask==1 slots; zero where empty.

    values: [..., K, F]; mask: [..., K].
    """
    mask = mask.to(values.dtype)
    total = (values * mask[..., None]).sum(dim=dim)
    count = mask.sum(dim=dim)[..., None]
    return total / torch.clamp(count, min=1.0)


def aggregate_neighbors(
    features: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked-mean GraphSAGE aggregation: [N,F], [N,K], [N,K] → [N,F]."""
    return masked_mean(gather_neighbors(features, neighbors), mask, dim=1)
