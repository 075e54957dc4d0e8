"""One rank of a gloo world for tests/test_torch_mesh.py.

    python tests/torch_mesh_child.py <workdir> <world size> <rank>

Reads ``inputs.pkl`` from the work directory (global arrays and init trees,
made by the test from seeds), joins the world through a ``FileStore``
there, runs every multi-device case of the port on this rank — the
data-parallel fits, the graph-parallel GraphSAGE, the gp ``GNNScorer``,
in-mesh FedAvg, the superbatch feed, the streamed fit and a ``Training``
round — and writes what it got to ``out_<rank>.pkl``. It imports torch and
the port, never jax or the JAX package.

``one_rank_world`` is the same world at size one, in this process, for
tests that need a process group but no peers.
"""

from __future__ import annotations

import contextlib
import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist

from dragonfly2_torch.models import gnn_sharded as gs
from dragonfly2_torch.parallel import make_mesh
from dragonfly2_torch.parallel import sharding
from dragonfly2_torch.parallel.fedavg import fedavg_psum, fedavg_trees
from dragonfly2_torch.schema import native
from dragonfly2_torch.schema.features import ProbeGraph
from dragonfly2_torch.trainer import ingest, train
from dragonfly2_torch.trainer.serving import GNNScorer
from dragonfly2_torch.trainer.storage import TrainerStorage
from dragonfly2_torch.trainer.training import Training, TrainingConfig
from dragonfly2_torch.weights import graphsage_from_numpy, mlp_from_numpy, module_tree


@contextlib.contextmanager
def one_rank_world():
    """A gloo process group of one rank in this process, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


class Uploads:
    """The manager client: keeps each upload's params as a numpy tree."""

    def __init__(self):
        self.models = {}

    def create_model(self, model_id, model_type, ip, hostname, params, evaluation):
        self.models[model_type] = dict(model_id=model_id, params=module_tree(params),
                                       evaluation=dict(evaluation))


def _fit(result) -> dict:
    return {"history": result.history, "params": module_tree(result.params), "metrics": result.metrics}


def _graph(arrays: dict) -> ProbeGraph:
    return ProbeGraph(**arrays)


def main() -> None:
    work, n, rank = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    inp = pickle.loads((work / "inputs.pkl").read_bytes())
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(work / "store"), n), rank=rank, world_size=n
    )
    out = {}
    dp = make_mesh(dp=n)
    gp = make_mesh(gp=n)

    # the superbatch feed: this rank's rows, one put a superbatch
    buf = torch.from_numpy(inp["superbatch"])
    out["superbatch"] = sharding.shard_superbatch(dp, buf).numpy()
    out["superbatch_k"] = sharding.shard_superbatch(
        dp, buf.view(2, -1, buf.shape[1]), batch_dim=1
    ).numpy()
    out["puts"] = sharding.PUTS

    # the data-parallel fits, from the reference's init trees
    x, y = inp["pairs"]
    out["train_mlp"] = _fit(train.train_mlp(
        x, y, config=train.FitConfig(init=inp["mlp_init"], **inp["mlp_cfg"]), device="cpu", mesh=dp
    ))
    # a batch the axis does not divide fits replicated, as on one device
    odd = dict(inp["mlp_cfg"], batch_size=inp["mlp_cfg"]["batch_size"] * n + 1)
    out["train_mlp_odd"] = _fit(train.train_mlp(
        x, y, config=train.FitConfig(init=inp["mlp_init"], **odd), device="cpu", mesh=dp
    ))
    out["train_mlp_odd_solo"] = _fit(train.train_mlp(
        x, y, config=train.FitConfig(init=inp["mlp_init"], **odd), device="cpu"
    ))
    graph = _graph(inp["graph"])
    out["train_gnn"] = _fit(train.train_gnn(
        graph, config=train.GNNFitConfig(init=inp["gnn_init"], **inp["gnn_cfg"]), device="cpu",
        mesh=dp,
    ))
    seqs, labels, lengths = inp["gru"]
    out["train_gru"] = _fit(train.train_gru(
        seqs, labels, lengths=lengths, mesh=dp,
        config=train.FitConfig(init=inp["gru_init"], **inp["gru_cfg"]), device="cpu",
    ))

    # graph parallel: the sharded forward and embed, this rank's rows
    model = graphsage_from_numpy(inp["gnn_init"], device="cpu").requires_grad_(False)
    nf, nbrs, mask, src, dst, _, _ = gs.pad_graph(graph, n)
    table = gs.pad_rows(inp["gnn_init"]["node_embed"], n)
    local = gs.shard_graph_arrays(gp, "gp", nf, nbrs, mask, src, dst, table)
    with torch.no_grad():
        out["sharded_forward"] = gs.make_sharded_forward(gp, compute_dtype=torch.float32)(
            model, local[5], *local[:5]
        ).numpy()
        out["sharded_embed"] = gs.make_sharded_embed(gp, compute_dtype=torch.float32)(
            model, local[5], *local[:3]
        ).numpy()
    sharded = train.train_gnn_sharded(
        graph, gp, config=train.GNNFitConfig(init=inp["sharded_init"], **inp["sharded_cfg"]), device="cpu"
    )
    out["train_gnn_sharded"] = _fit(sharded)

    # the served GNN embedded graph parallel, against the same without a mesh
    src_ids = [graph.node_ids[i] for i in graph.edge_src]
    dst_ids = [graph.node_ids[i] for i in graph.edge_dst]
    scorer = GNNScorer(inp["gnn_init"], graph, mesh=gp, device="cpu")
    plain = GNNScorer(inp["gnn_init"], graph, device="cpu")
    out["scorer"] = {
        "mesh": scorer.predict_rtt_log_ms(src_ids, dst_ids),
        "plain": plain.predict_rtt_log_ms(src_ids, dst_ids),
        "emb": scorer._emb.numpy(),
    }

    # in-mesh FedAvg: this rank's replica against the host-side average
    fed = make_mesh(fed=n)
    mine = mlp_from_numpy(inp["fed_trees"][rank], device="cpu").state_dict()
    merged = fedavg_psum(mine, inp["fed_examples"][rank], mesh=fed)
    every = [mlp_from_numpy(t, device="cpu").state_dict() for t in inp["fed_trees"]]
    host = fedavg_trees(every, inp["fed_examples"])
    out["fedavg"] = {k: (merged[k].numpy(), host[k].numpy()) for k in merged}

    # the streamed fit over the dp axis, and every rank's stream in one
    # order with several producers
    stream_kw = dict(hidden_dims=inp["stream_hidden"], device="cpu", mesh=dp, **inp["stream_cfg"])
    params, stats = ingest.stream_train_mlp(inp["blocks"], workers=1, init=inp["stream_init"], **stream_kw)
    out["stream"] = {"params": module_tree(params), "losses": stats.losses, "steps": stats.steps,
                     "metrics": stats.metrics, "pct": stats.h2d_overlap_pct}
    params, stats = ingest.stream_train_mlp(inp["blocks"], workers=3, init=inp["stream_init"], **stream_kw)
    out["stream_workers"] = {"params": module_tree(params), "losses": stats.losses}
    _, stats = ingest.stream_train_mlp(
        inp["blocks"], workers=1, init=inp["stream_init"], time_budget_s=0.0, **stream_kw
    )
    out["stream_budget"] = {"steps": stats.steps, "truncated": stats.truncated}
    # a CSV stream in spans (their 8 MiB floor lowered so this small file
    # splits), whose bounds follow the producer count: ranks asking for 2,
    # 3, ... producers take the least and fit as every rank does with 2
    floor, native._MIN_SPAN = native._MIN_SPAN, 4096
    try:
        for key, workers in (("stream_csv", 2), ("stream_csv_mixed", 2 + rank)):
            params, stats = ingest.stream_train_mlp(
                inp["csv_downloads"], workers=workers, init=inp["stream_init"], **stream_kw
            )
            out[key] = {"params": module_tree(params), "losses": stats.losses}
    finally:
        native._MIN_SPAN = floor

    if inp["round"]:
        # a Training round with a dp mesh: the CSV upload streamed through the
        # native decoder, the topology through build_probe_graph_file
        storage = TrainerStorage(work / f"storage-{rank}")
        storage.append_download(inp["host_id"], Path(inp["csv_downloads"]).read_bytes())
        storage.append_network_topology(inp["host_id"], Path(inp["csv_topology"]).read_bytes())
        uploads = Uploads()
        cfg = TrainingConfig(
            mlp=train.FitConfig(init=inp["stream_init"], **inp["round_mlp"]),
            gnn=train.GNNFitConfig(init=inp["round_gnn_init"], **inp["round_gnn"]),
            **inp["round_common"],
        )
        training = Training(storage, uploads, cfg, device="cpu")
        outcome = training.train(*inp["ip_host"])
        out["round"] = {"mesh": dict(zip(training.mesh.mesh_dim_names, training.mesh.mesh.shape)),
                        "ok": outcome.ok, "errors": (outcome.mlp_error, outcome.gnn_error),
                        "models": uploads.models}

    (work / f"out_{rank}.pkl").write_bytes(pickle.dumps(out))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
