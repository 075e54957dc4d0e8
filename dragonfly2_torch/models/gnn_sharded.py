"""Graph-parallel GraphSAGE: node tables sharded over a process-mesh axis
(counterpart of the reference's ``models/gnn_sharded.py``).

A probe graph with O(hosts²) edges and its per-node embedding table need
not fit one device: each rank holds a row shard of the node feature and
embedding tables and a block of the edges, and the shards rotate around
the axis's ring (``ops.ring.ring_gather_rows``) for the two places a rank
needs rows it does not own — neighbor aggregation and edge-endpoint
lookup. Per-rank memory is O(N/ranks + E/ranks).

The reference writes the per-device bodies in jitted ``jnp`` under
``shard_map``; here they are plain PyTorch ops over this rank's shards
plus the collectives, and ``make_*`` return functions of a rank's local
shards (every rank of the axis calls them together). The arithmetic
matches ``models.gnn.forward_edge_rtt``: the same masked-mean
aggregation, SAGE inputs in ``compute_dtype`` with float32 sums
(``device.matmul_f32acc``), L2-normalized embeddings and the pairwise
head. ``dense`` is a ``GraphSAGE`` whose ``node_embed`` is not used: the
embedding table comes in as this rank's shard.
"""

from __future__ import annotations

import numpy as np
import torch

from dragonfly2_torch.device import matmul_f32acc
from dragonfly2_torch.models.mlp import apply_mlp
from dragonfly2_torch.ops.ring import ring_gather_rows
from dragonfly2_torch.ops.segment import masked_mean
from dragonfly2_torch.parallel.sharding import SumOverAxis, axis_group, pad_to_multiple


def pad_rows(a: np.ndarray, multiple: int) -> np.ndarray:
    """Pad axis 0 up to a multiple so row-sharding divides evenly."""
    padded, _ = pad_to_multiple(a, multiple)
    return padded


def pad_node_arrays(graph, num_shards: int):
    """ProbeGraph → padded NODE arrays sharding-ready over ``num_shards``
    — the serving half of :func:`pad_graph`. Padded nodes self-neighbor
    with zero mask, inert under the masked mean. Returns (node_features,
    neighbors, neighbor_mask) as numpy arrays."""
    nf = pad_rows(graph.node_features.astype(np.float32), num_shards)
    n_pad = nf.shape[0]
    neighbors = pad_rows(graph.neighbors.astype(np.int32), num_shards)
    if n_pad > graph.num_nodes:
        pad_ids = np.arange(graph.num_nodes, n_pad, dtype=np.int32)
        neighbors[graph.num_nodes :] = pad_ids[:, None]
    mask = pad_rows(graph.neighbor_mask.astype(np.float32), num_shards)
    return nf, neighbors, mask


def pad_graph(graph, num_shards: int):
    """ProbeGraph → padded arrays sharding-ready over ``num_shards``.
    Padded nodes self-neighbor with zero mask; padded edges point at node
    0 with zero weight in the loss. Returns (node_features, neighbors,
    neighbor_mask, edge_src, edge_dst, edge_y, edge_w) as numpy arrays."""
    nf, neighbors, mask = pad_node_arrays(graph, num_shards)
    src = pad_rows(graph.edge_src.astype(np.int32), num_shards)
    dst = pad_rows(graph.edge_dst.astype(np.int32), num_shards)
    y = pad_rows(graph.edge_rtt_log_ms.astype(np.float32), num_shards)
    w = pad_rows(np.ones(len(graph.edge_src), np.float32), num_shards)
    return nf, neighbors, mask, src, dst, y, w


def _embed_local(dense, embed_shard, feat_shard, nbr_shard, mask_shard, group, compute_dtype):
    """This rank's SAGE stack → its [S, H] L2-normalized embedding rows.
    ``nbr_shard`` holds global node ids; the rows they name come over the
    ring."""
    h = feat_shard
    if embed_shard is not None:
        h = torch.cat([h, embed_shard], dim=-1)
    for layer in dense.sage:
        nbr_feats = ring_gather_rows(h, nbr_shard.long(), group)  # [S, K, F]
        agg = masked_mean(nbr_feats, mask_shard)
        z = matmul_f32acc(h, layer.w_self, compute_dtype) + matmul_f32acc(
            agg, layer.w_nbr, compute_dtype
        )
        h = torch.relu(z + layer.b.float())
    norm = torch.linalg.vector_norm(h, dim=-1, keepdim=True)
    return h / torch.clamp(norm, min=1e-6)


def _forward_local(dense, embed_shard, feat_shard, nbr_shard, mask_shard, src_blk, dst_blk,
                   group, compute_dtype):
    """This rank's body → per-edge log-RTT for its edge block."""
    h = _embed_local(dense, embed_shard, feat_shard, nbr_shard, mask_shard, group, compute_dtype)
    # one ring rotation serves both endpoints: the stacked indices halve
    # the shifts of the hottest collective in the loop
    ends = ring_gather_rows(h, torch.stack([src_blk, dst_blk]).long(), group)  # [2, Eb, H]
    hs, hd = ends[0], ends[1]
    pair = torch.cat([hs, hd, hs * hd], dim=-1)
    return apply_mlp(dense.head, pair)[..., 0]


def make_sharded_forward(mesh, axis: str = "gp", compute_dtype=torch.bfloat16):
    """→ fn(dense, embed, node_features, neighbors, mask, src, dst) over
    this rank's row shards of the node tables (``embed`` may be None) and
    its edge block → its edges' predictions."""
    group = mesh.get_group(axis)

    def apply(dense, embed, feats, nbrs, mask, src, dst):
        return _forward_local(dense, embed, feats, nbrs, mask, src, dst, group, compute_dtype)

    return apply


def make_sharded_embed(mesh, axis: str = "gp", compute_dtype=torch.bfloat16):
    """→ fn(dense, embed, node_features, neighbors, mask) over this rank's
    row shards → its rows of the [N, H] embedding table: the serving half
    of the sharded forward (the scoring service embeds once, at model-swap
    time)."""
    group = mesh.get_group(axis)

    def apply(dense, embed, feats, nbrs, mask):
        return _embed_local(dense, embed, feats, nbrs, mask, group, compute_dtype)

    return apply


def make_sharded_loss(mesh, axis: str = "gp", compute_dtype=torch.bfloat16):
    """→ loss(dense, embed, graph shards, src, dst, y, w): the weighted
    squared error over valid edges, summed with its weight across the axis
    so every rank sees the global mean. Each rank's backward seeds its own
    edges' share; the ring's backward carries the rest home, so a rank's
    replicated parameters hold their part of the gradient, to be summed
    over the axis, and its embedding shard holds all of its own."""
    group = mesh.get_group(axis)

    def loss(dense, embed, feats, nbrs, mask, src, dst, y, w):
        pred = _forward_local(dense, embed, feats, nbrs, mask, src, dst, group, compute_dtype)
        count = w.sum().detach().clone()
        torch.distributed.all_reduce(count, group=group)
        share = (w * (pred - y) ** 2).sum() / torch.clamp(count, min=1.0)
        return SumOverAxis.apply(share, group)

    return loss


def shard_graph_arrays(mesh, axis: str, *arrays, device="cpu"):
    """This rank's row shard of each (numpy) array over ``mesh[axis]``, on
    ``device``."""
    _, n, rank = axis_group(mesh, axis)
    out = []
    for a in arrays:
        per = a.shape[0] // n
        out.append(torch.from_numpy(np.ascontiguousarray(a[rank * per : (rank + 1) * per])).to(device))
    return out
