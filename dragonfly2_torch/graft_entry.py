"""Entry point of the flagship model (counterpart of the reference's
``__graft_entry__.py`` ``entry()``).

``entry()`` returns the GraphSAGE edge-RTT forward and example arguments
on the port's device: a GNN over a seeded synthetic probe graph of 200
topology records among 32 hosts, and that graph's arrays. The reference's
``dryrun_multichip`` waits for the multi-device port (ROADMAP queue A
item 11).
"""

from __future__ import annotations

import torch

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.models.gnn import forward_edge_rtt, init_graphsage
from dragonfly2_torch.schema.columnar import records_to_columns
from dragonfly2_torch.schema.features import build_probe_graph
from dragonfly2_torch.schema.synth import make_topology_records


def entry(device="cuda"):
    """→ (fn, example_args): ``fn(*example_args)`` is the flagship GraphSAGE
    forward, edge log-RTT for every probed edge of the example graph."""
    dev = resolve_device(device)
    g = build_probe_graph(
        records_to_columns(make_topology_records(200, num_hosts=32, seed=0)),
        max_degree=8,
    )
    model = init_graphsage(
        torch.Generator().manual_seed(0),
        g.node_features.shape[1],
        [64, 64],
        num_nodes=g.num_nodes,
    ).to(dev)
    example_args = (
        model,
        torch.from_numpy(g.node_features).to(dev),
        torch.from_numpy(g.neighbors).to(dev),
        torch.from_numpy(g.neighbor_mask).to(dev),
        torch.from_numpy(g.edge_src).to(dev),
        torch.from_numpy(g.edge_dst).to(dev),
    )
    return forward_edge_rtt, example_args
