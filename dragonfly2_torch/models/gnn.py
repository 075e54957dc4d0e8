"""GraphSAGE GNN over the probe graph (counterpart of the reference's
``models/gnn.py``). Hosts are nodes, probe measurements are edges (EWMA
RTT). The model learns host embeddings whose pairwise head predicts edge
log-RTT.

Aggregation runs over a fixed-degree sampled neighbor table [N, K]
(``schema.features.sample_neighbors``): dense gathers and masked means.
The SAGE layers' matmul inputs are bfloat16 on every device, the CPU
included, as in the reference; the head follows the device's MLP dtype
(``device.compute_dtype``). Parameter names map 1:1 to the reference's
tree (``sage.0.w_self`` ↔ ``sage/0/w_self``, ``head.layers.0.w``,
``node_embed``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dragonfly2_torch.device import matmul_f32acc
from dragonfly2_torch.models.mlp import MLP, apply_mlp, init_mlp
from dragonfly2_torch.ops.segment import aggregate_neighbors


class SageLayer(nn.Module):
    """h' = relu(h·w_self + mean_{u∈N(v)} h_u·w_nbr + b); weights [in, out]."""

    def __init__(self, fan_in: int, fan_out: int):
        super().__init__()
        self.w_self = nn.Parameter(torch.zeros(fan_in, fan_out))
        self.w_nbr = nn.Parameter(torch.zeros(fan_in, fan_out))
        self.b = nn.Parameter(torch.zeros(fan_out))


class GraphSAGE(nn.Module):
    """SAGE layers + pairwise edge head ``MLP([3·H, head_hidden, 1])``;
    with ``num_nodes`` a learnable per-node embedding table is
    concatenated to the input features. A parameter container, like the
    reference's tree: ``forward_edge_rtt`` runs it."""

    def __init__(
        self,
        in_dim: int,
        hidden_dims: Sequence[int],
        head_hidden: int = 64,
        num_nodes: "int | None" = None,
        embed_dim: int = 16,
    ):
        super().__init__()
        self.node_embed = None
        if num_nodes is not None:
            self.node_embed = nn.Parameter(torch.zeros(num_nodes, embed_dim))
            in_dim += embed_dim
        dims = [in_dim, *hidden_dims]
        self.sage = nn.ModuleList(SageLayer(i, o) for i, o in zip(dims[:-1], dims[1:]))
        self.head = MLP([3 * dims[-1], head_hidden, 1])


def init_graphsage(
    generator: torch.Generator,
    in_dim: int,
    hidden_dims: Sequence[int],
    head_hidden: int = 64,
    num_nodes: "int | None" = None,
    embed_dim: int = 16,
) -> GraphSAGE:
    """The reference's ``init_graphsage`` scheme: embedding N(0, 0.1²),
    He-normal SAGE weights, zero biases, He-normal head (the numbers
    differ, since the generators do)."""
    model = GraphSAGE(in_dim, hidden_dims, head_hidden, num_nodes, embed_dim)
    with torch.no_grad():
        if model.node_embed is not None:
            model.node_embed.copy_(
                torch.randn(model.node_embed.shape, generator=generator) * 0.1
            )
        for layer in model.sage:
            scale = (2.0 / layer.w_self.shape[0]) ** 0.5
            layer.w_self.copy_(torch.randn(layer.w_self.shape, generator=generator) * scale)
            layer.w_nbr.copy_(torch.randn(layer.w_nbr.shape, generator=generator) * scale)
        head = init_mlp(generator, [3 * hidden_dims[-1], head_hidden, 1])
        model.head.load_state_dict(head.state_dict())
    return model


def apply_graphsage(
    model: GraphSAGE,
    node_features: torch.Tensor,  # [N, F]
    neighbors: torch.Tensor,  # [N, K] int
    neighbor_mask: torch.Tensor,  # [N, K]
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """→ [N, H] node embeddings (L2-normalized, GraphSAGE convention)."""
    h = node_features
    if model.node_embed is not None:
        h = torch.cat([h, model.node_embed], dim=-1)
    for layer in model.sage:
        agg = aggregate_neighbors(h, neighbors, neighbor_mask)
        z = matmul_f32acc(h, layer.w_self, compute_dtype) + matmul_f32acc(
            agg, layer.w_nbr, compute_dtype
        )
        h = torch.relu(z + layer.b.float())
    norm = torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    return h / torch.clamp(norm, min=1e-6)


def predict_edge(
    model: GraphSAGE, embeddings: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
) -> torch.Tensor:
    """Pairwise head: predicted log-RTT for edges (src[i] → dst[i])."""
    hs = embeddings[src.long()]
    hd = embeddings[dst.long()]
    pair = torch.cat([hs, hd, hs * hd], dim=-1)
    return apply_mlp(model.head, pair)[..., 0]


def forward_edge_rtt(
    model: GraphSAGE,
    node_features: torch.Tensor,
    neighbors: torch.Tensor,
    neighbor_mask: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """Full forward: features → embeddings → edge log-RTT predictions."""
    emb = apply_graphsage(model, node_features, neighbors, neighbor_mask)
    return predict_edge(model, emb, src, dst)
