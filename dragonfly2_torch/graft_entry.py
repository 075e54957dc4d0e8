"""Entry point of the flagship model (counterpart of the reference's
``__graft_entry__.py`` ``entry()``).

``entry()`` returns the GraphSAGE edge-RTT forward and example arguments
on the port's device: a GNN over a seeded synthetic probe graph of 200
topology records among 32 hosts, and that graph's arrays.

``dryrun_multichip(n)`` spawns a gloo world of ``n`` CPU processes (one a
rank, as one a device) and runs the full set of multi-device steps with
real collectives at tiny shapes: a data-parallel × tensor-parallel MLP
training step (``dp`` × ``mp``) held against the same step on one rank, a
graph-parallel GraphSAGE fit (``gp``), ring and Ulysses attention (``sp``)
against the plain attention, and in-mesh FedAvg (``fed``).
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path

import numpy as np
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


def dryrun_multichip(n_devices: int) -> dict:
    """One step of every multi-device path on a gloo world of
    ``n_devices`` spawned CPU ranks → rank 0's summary. Every rank checks
    its own results; a failed check or a failed rank raises here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as work:
        mp.spawn(_dryrun_rank, args=(n_devices, work), nprocs=n_devices, join=True)
        return json.loads((Path(work) / "rank0.json").read_text())


def _dryrun_rank(rank: int, n: int, work: str) -> None:
    import torch.distributed as dist

    from dragonfly2_torch.models import mlp as mlp_mod
    from dragonfly2_torch.ops.ring import local_attention, make_ring_attention
    from dragonfly2_torch.ops.ulysses import make_ulysses_attention
    from dragonfly2_torch.parallel import make_mesh
    from dragonfly2_torch.parallel.fedavg import fedavg_psum
    from dragonfly2_torch.parallel.sharding import (
        apply_mlp_sharded,
        mean_grads,
        mlp_param_spec,
        shard_batch,
        tree_sharding,
    )
    from dragonfly2_torch.schema.features import MLP_FEATURE_DIM
    from dragonfly2_torch.schema.synth import make_pair_tensors
    from dragonfly2_torch.trainer.train import AdamW, GNNFitConfig, train_gnn_sharded
    from dragonfly2_torch.weights import module_tree

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(work) / "store"), n), rank=rank, world_size=n
    )
    try:
        out = {}
        # ---- dp × mp: data-parallel batch, tensor-parallel hidden dims ----
        mp_size = 2 if n % 2 == 0 else 1
        dp = n // mp_size
        mesh = make_mesh(dp=dp, mp=mp_size)
        dims = [MLP_FEATURE_DIM, 64, 64, 1]
        x, y = make_pair_tensors(64 * dp, seed=0)
        tree = module_tree(mlp_mod.init_mlp(torch.Generator().manual_seed(0), dims))
        layers = [
            {k: torch.nn.Parameter(torch.from_numpy(np.ascontiguousarray(v))) for k, v in layer.items()}
            for layer in tree_sharding(mesh, tree, mlp_param_spec)["layers"]
        ]
        params = [p for layer in layers for p in layer.values()]
        opt = AdamW(params, lambda count: 1e-3, weight_decay=1e-4)
        xb, yb = (torch.from_numpy(a) for a in shard_batch(mesh, (x, y), "dp"))
        loss = torch.mean((apply_mlp_sharded(layers, dims, xb, mesh)[..., 0] - yb) ** 2)
        loss.backward()
        group = mesh.get_group("dp")
        loss = float(mean_grads(params, group, dp, extra=loss.detach())[0]) / dp
        opt.step()
        assert np.isfinite(loss), "dp×mp train step produced a non-finite loss"

        # the same global batch stepped on one rank must land on the same
        # parameters: the collectives change where the math runs, never what
        solo = mlp_mod.init_mlp(torch.Generator().manual_seed(0), dims)
        solo_opt = AdamW(list(solo.parameters()), lambda count: 1e-3, weight_decay=1e-4)
        solo_loss = torch.mean((mlp_mod.score_parents(solo, torch.from_numpy(x)) - torch.from_numpy(y)) ** 2)
        solo_loss.backward()
        solo_opt.step()
        np.testing.assert_allclose(loss, float(solo_loss.detach()), rtol=1e-5)
        want = tree_sharding(mesh, module_tree(solo), mlp_param_spec)["layers"]
        for got_layer, want_layer in zip(layers, want):
            for k in got_layer:
                np.testing.assert_allclose(got_layer[k].detach().numpy(), want_layer[k], atol=1e-5)
        out["dp_mp"] = {"dp": dp, "mp": mp_size, "loss": loss, "solo_loss": float(solo_loss.detach())}

        # ---- gp: graph-parallel GraphSAGE training ----
        from dragonfly2_torch.schema.columnar import records_to_columns
        from dragonfly2_torch.schema.synth import make_topology_records

        graph = build_probe_graph(
            records_to_columns(make_topology_records(60, num_hosts=24, seed=0)), max_degree=4
        )
        gnn = train_gnn_sharded(
            graph, make_mesh(gp=n), config=GNNFitConfig(hidden_dims=(16,), epochs=2), device="cpu"
        )
        assert np.isfinite(gnn.history[-1]), "gp GNN step produced a non-finite loss"
        out["gp"] = {"history": gnn.history}

        # ---- sp: ring and Ulysses attention over sequence shards ----
        sp_mesh = make_mesh(sp=n)
        b, t, h, d = 2, 16 * n, max(2, n), 8
        gen = torch.Generator().manual_seed(1)
        q, k, v = (torch.randn((b, t, h, d), generator=gen) for _ in range(3))
        want_o = local_attention(q, k, v, causal=True)
        rows = slice(rank * 16, (rank + 1) * 16)
        qs, ks, vs = (a[:, rows].contiguous() for a in (q, k, v))
        errs = {}
        for name, fn in (
            ("ring", make_ring_attention(sp_mesh, "sp", causal=True)),
            ("ulysses", make_ulysses_attention(sp_mesh, "sp", causal=True)),
            ("ulysses_kernel", make_ulysses_attention(sp_mesh, "sp", causal=True, use_kernel=True)),
        ):
            with torch.no_grad():
                got = fn(qs, ks, vs)
            errs[name] = float((got - want_o[:, rows]).abs().max())
            assert errs[name] <= 2e-4, (name, errs[name])
        out["sp_max_abs_err"] = errs

        # ---- fed: in-mesh FedAvg over the federated axis ----
        merged = fedavg_psum({"w": torch.tensor([float(rank)])}, rank + 1, mesh=make_mesh(fed=n))
        want_avg = sum(r * (r + 1) for r in range(n)) / sum(r + 1 for r in range(n))
        np.testing.assert_allclose(float(merged["w"][0]), want_avg, rtol=1e-6)
        out["fed"] = float(merged["w"][0])
        if rank == 0:
            (Path(work) / "rank0.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
