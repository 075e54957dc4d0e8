"""The port's multi-device trainer (``dragonfly2_torch.parallel.sharding``,
``models.gnn_sharded``, the fits' ``mesh=``, ``train_gnn_sharded``,
``GNNScorer``'s graph-parallel embed, ``fedavg_psum``, the streamed fit's
mesh feed and ``Training``'s auto dp mesh) over gloo worlds of 2 and 4
processes, against the JAX package on ``make_mesh(dp=n)`` /
``make_mesh(gp=n)`` meshes of this process's virtual CPU devices, on the
same seeded inputs and init trees.

Each world is spawned once for the module (``tests/torch_mesh_child.py``,
one process a rank, a ``FileStore`` under a temporary directory, never
jax); the JAX side runs here while the worlds run. A dp fit is held to
the single-device limits of ``tests/test_torch_train.py`` and
``tests/test_torch_ingest.py``, and every rank must hold the same
parameters; the sharded forward and embed at float32 to rtol 1e-4, atol
1e-5 (``tests/test_gnn_sharded.py``'s limits).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from dragonfly2_torch import graft_entry
from dragonfly2_torch.parallel import make_mesh as t_make_mesh
from dragonfly2_torch.parallel import sharding as t_sharding
from dragonfly2_tpu.models import gnn_sharded as j_gs
from dragonfly2_tpu.models import gru as j_gru
from dragonfly2_tpu.models import mlp as j_mlp
from dragonfly2_tpu.parallel import sharding as j_sharding
from dragonfly2_tpu.parallel.fedavg import fedavg_trees as j_fedavg_trees
from dragonfly2_tpu.parallel.mesh import make_mesh
from dragonfly2_tpu.schema import columnar as j_columnar
from dragonfly2_tpu.schema import features as j_features
from dragonfly2_tpu.schema import synth as j_synth
from dragonfly2_tpu.schema import wire as j_wire
from dragonfly2_tpu.schema.features import MLP_FEATURE_DIM
from dragonfly2_tpu.trainer import ingest as j_ingest
from dragonfly2_tpu.trainer import train as j_train
from dragonfly2_tpu.trainer import training as j_training
from dragonfly2_tpu.trainer.serving import GNNScorer as JScorer
from dragonfly2_tpu.trainer.storage import TrainerStorage as JStorage
from dragonfly2_tpu.utils.idgen import host_id_v2
from torch_mesh_child import one_rank_world

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CHILD = Path(__file__).resolve().parent / "torch_mesh_child.py"
WORLDS = (2, 4)
IP, HOST = "10.1.2.3", "scheduler-a"
MLP_CFG = dict(hidden_dims=(16, 16), batch_size=64, epochs=2, seed=3)
GNN_CFG = dict(hidden_dims=(16, 16), batch_size=64, epochs=3, seed=0)
GRU_CFG = dict(hidden_dims=(8,), batch_size=32, epochs=3, seed=2)
SHARDED_CFG = dict(hidden_dims=(16,), epochs=12, seed=0, learning_rate=5e-2)
STREAM_HIDDEN = (16, 16)
STREAM_CFG = dict(passes=2, batch_size=96, steps_per_call=2, eval_every=5)
ROUND_MLP = dict(hidden_dims=(16, 16), batch_size=64, epochs=2, seed=0)
ROUND_GNN = dict(hidden_dims=(16, 16), batch_size=64, epochs=2, seed=0)
ROUND_COMMON = dict(gru=False, streaming_workers=1, clear_after_train=False, streaming_threshold_bytes=0)


def _numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _flat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items() for k2, v in _flat(sub, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, sub in enumerate(tree) for k2, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float64)}


def _max_rel(got, want) -> float:
    a, b = _flat(got), _flat(want)
    assert a.keys() == b.keys()
    return max(float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)) for k in a)


def _graph(records=300, hosts=40, max_degree=8, seed=2):
    """test_torch_train's GNN parity graph, whose limits these fits keep."""
    cols = j_columnar.records_to_columns(j_synth.make_topology_records(records, num_hosts=hosts, seed=seed))
    return j_features.build_probe_graph(cols, max_degree=max_degree, seed=seed)


def _common(work: Path) -> dict:
    """The inputs both worlds share, and their files under ``work``."""
    cols = j_columnar.records_to_columns(j_synth.make_download_records(300, seed=2))
    pairs = j_features.extract_pair_features(cols)
    jg = _graph()
    seqs = j_features.extract_piece_sequences(
        j_columnar.records_to_columns(j_synth.make_download_records(160, seed=5))
    )
    blocks = work / "download.dfb"
    recs = j_synth.make_download_records(480, seed=6)
    blocks.write_bytes(b"".join(j_wire.encode_train_block(recs[i : i + 40]) for i in range(0, 480, 40)))
    csv_d, csv_t = work / "d.csv", work / "t.csv"
    j_columnar.write_csv(csv_d, j_synth.make_download_records(240, seed=11))
    topology = j_synth.make_topology_records(160, num_hosts=32, seed=12)
    j_columnar.write_csv(csv_t, topology)
    round_graph = j_features.build_probe_graph(j_columnar.records_to_columns(topology), max_degree=16)
    return {
        "pairs": (pairs.features, pairs.labels),
        "mlp_cfg": MLP_CFG,
        "mlp_init": _numpy(j_mlp.init_mlp(jax.random.PRNGKey(3), [MLP_FEATURE_DIM, 16, 16, 1])),
        "graph": dataclasses.asdict(jg),
        "gnn_cfg": GNN_CFG,
        "gnn_init": _numpy(j_train._init_gnn(jg, j_train.GNNFitConfig(**GNN_CFG))),
        "sharded_cfg": SHARDED_CFG,
        "sharded_init": _numpy(j_train._init_gnn(jg, j_train.GNNFitConfig(**SHARDED_CFG))),
        "gru": (seqs.sequences, seqs.labels, seqs.lengths),
        "gru_cfg": GRU_CFG,
        "gru_init": _numpy(j_gru.init_gru(jax.random.PRNGKey(2), 2, 8)),
        "blocks": str(blocks),
        "stream_hidden": STREAM_HIDDEN,
        "stream_cfg": STREAM_CFG,
        "stream_init": _numpy(j_mlp.init_mlp(jax.random.PRNGKey(0), [MLP_FEATURE_DIM, *STREAM_HIDDEN, 1])),
        "csv_downloads": str(csv_d),
        "csv_topology": str(csv_t),
        "host_id": host_id_v2(IP, HOST),
        "ip_host": (IP, HOST),
        "round_mlp": ROUND_MLP,
        "round_gnn": ROUND_GNN,
        "round_gnn_init": _numpy(j_train._init_gnn(round_graph, j_train.GNNFitConfig(**ROUND_GNN))),
        "round_common": ROUND_COMMON,
    }


def _inputs(n: int, common: dict) -> dict:
    rng = np.random.default_rng(200 + n)
    return {
        **common,
        "superbatch": rng.standard_normal((16 * n, MLP_FEATURE_DIM + 1)).astype(np.float16),
        "fed_trees": [
            _numpy(j_mlp.init_mlp(jax.random.PRNGKey(10 + r), [MLP_FEATURE_DIM, 8, 1])) for r in range(n)
        ],
        "fed_examples": [float(30 + 20 * r) for r in range(n)],
        # the Training round runs in the world of 2 only
        "round": n == 2,
    }


class _Uploads:
    def __init__(self):
        self.models = {}

    def create_model(self, model_id, model_type, ip, hostname, params, evaluation):
        self.models[model_type] = dict(model_id=model_id, params=_numpy(params), evaluation=dict(evaluation))


def _meshes(n):
    devs = jax.devices()[:n]
    return devs, make_mesh(devs, dp=n), make_mesh(devs, gp=n)


def _reference_fits(n: int, inp: dict) -> dict:
    """The JAX package's superbatch feed and dp fits on n virtual CPU
    devices."""
    devs, dp, _ = _meshes(n)
    want = {}
    buf = inp["superbatch"]

    def shards(arr):
        return [np.asarray(s.data) for s in sorted(arr.addressable_shards, key=lambda s: devs.index(s.device))]

    want["superbatch"] = shards(j_sharding.shard_superbatch(dp, buf))
    want["superbatch_k"] = shards(j_sharding.shard_superbatch(dp, buf.reshape(2, -1, buf.shape[1]), batch_dim=1))
    x, y = inp["pairs"]
    want["train_mlp"] = j_train.train_mlp(x, y, mesh=dp, config=j_train.FitConfig(**MLP_CFG))
    jg = j_features.ProbeGraph(**inp["graph"])
    want["train_gnn"] = j_train.train_gnn(jg, mesh=dp, config=j_train.GNNFitConfig(**GNN_CFG))
    s, lab, ln = inp["gru"]
    want["train_gru"] = j_train.train_gru(s, lab, lengths=ln, mesh=dp, config=j_train.FitConfig(**GRU_CFG))
    return want


def _reference_rest(n: int, inp: dict, work: Path) -> dict:
    """The JAX package's graph-parallel forward, embed and fit, scorer,
    FedAvg, streamed fit and round on n virtual CPU devices."""
    _, dp, gp = _meshes(n)
    want = {}
    jg = j_features.ProbeGraph(**inp["graph"])
    tree = inp["gnn_init"]
    dense = {k: v for k, v in tree.items() if k != "node_embed"}
    nf, nbrs, mask, src, dst, _, _ = j_gs.pad_graph(jg, n)
    embed = j_gs.pad_rows(tree["node_embed"], n)
    arrays = j_gs.shard_graph_arrays(gp, "gp", nf, nbrs, mask, src, dst)
    emb_d = jax.device_put(jnp.asarray(embed), NamedSharding(gp, P("gp", None)))
    # jitted: shard_map run eagerly takes seconds a call
    want["sharded_forward"] = np.asarray(
        jax.jit(j_gs.make_sharded_forward(gp, "gp", compute_dtype=jnp.float32))(dense, emb_d, *arrays)
    )
    want["sharded_embed"] = np.asarray(
        jax.jit(j_gs.make_sharded_embed(gp, "gp", compute_dtype=jnp.float32))(dense, emb_d, *arrays[:3])
    )
    want["train_gnn_sharded"] = j_train.train_gnn_sharded(jg, gp, config=j_train.GNNFitConfig(**SHARDED_CFG))
    src_ids = [jg.node_ids[i] for i in jg.edge_src]
    dst_ids = [jg.node_ids[i] for i in jg.edge_dst]
    want["scorer"] = JScorer(tree, jg).predict_rtt_log_ms(src_ids, dst_ids)
    want["fedavg"] = j_fedavg_trees(inp["fed_trees"], inp["fed_examples"])

    params, stats = j_ingest.stream_train_mlp(
        inp["blocks"], hidden_dims=STREAM_HIDDEN, workers=1, mesh=dp, **STREAM_CFG
    )
    want["stream"] = (_numpy(params), stats)
    if not inp["round"]:
        return want

    storage = JStorage(work / "jax-storage")
    host_id = host_id_v2(IP, HOST)
    storage.append_download(host_id, Path(inp["csv_downloads"]).read_bytes())
    storage.append_network_topology(host_id, Path(inp["csv_topology"]).read_bytes())
    uploads = _Uploads()
    cfg = j_training.TrainingConfig(
        mlp=j_train.FitConfig(**ROUND_MLP), gnn=j_train.GNNFitConfig(**ROUND_GNN), auto_mesh=False, **ROUND_COMMON
    )
    outcome = j_training.Training(storage, uploads, cfg, mesh=dp).train(IP, HOST)
    want["round"] = (outcome.ok, uploads.models)
    return want


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds spawned at once, the reference computed meanwhile →
    {n: (inputs, [rank outputs], reference), "dryrun": rank 0's summary of
    ``graft_entry.dryrun_multichip(2)``}."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    common = _common(tmp_path_factory.mktemp("mesh"))
    runs = {}
    for n in WORLDS:
        work = tmp_path_factory.mktemp(f"mesh{n}")
        inputs = _inputs(n, common)
        (work / "inputs.pkl").write_bytes(pickle.dumps(inputs))
        procs = [
            subprocess.Popen(
                [sys.executable, str(CHILD), str(work), str(n), str(r)],
                cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for r in range(n)
        ]
        runs[n] = (work, inputs, procs)
    out = {}
    try:
        # both meshes' references at once, each in two parts (XLA compiles
        # outside the GIL), and the dry run's own world of 2 beside them
        with ThreadPoolExecutor(2 * len(runs) + 1) as pool:
            dryrun = pool.submit(graft_entry.dryrun_multichip, 2)
            futures = {
                n: (pool.submit(_reference_fits, n, inputs), pool.submit(_reference_rest, n, inputs, work))
                for n, (work, inputs, _) in runs.items()
            }
            want = {n: {**fits.result(), **rest.result()} for n, (fits, rest) in futures.items()}
            out["dryrun"] = dryrun.result()
        for n, (work, inputs, procs) in runs.items():
            logs = [p.communicate(timeout=300)[0] for p in procs]
            for r, (p, log) in enumerate(zip(procs, logs)):
                assert p.returncode == 0, f"rank {r} of {n} failed:\n{log}"
            ranks = [pickle.loads((work / f"out_{r}.pkl").read_bytes()) for r in range(n)]
            out[n] = (inputs, ranks, want[n])
    finally:
        for _, _, procs in runs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def _same_on_every_rank(ranks, key):
    first = _flat(ranks[0][key]["params"])
    for r in ranks[1:]:
        got = _flat(r[key]["params"])
        assert all(np.array_equal(got[k], first[k]) for k in first), key


# --- the superbatch feed ---


@pytest.mark.parametrize("n", WORLDS)
def test_shard_superbatch_puts_only_the_rank_rows(worlds, n):
    _, ranks, want = worlds[n]
    assert len(want["superbatch"]) == n
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["superbatch"], want["superbatch"][r])
        np.testing.assert_array_equal(got["superbatch_k"], want["superbatch_k"][r])
        assert got["superbatch"].shape[0] == 16  # 16·n rows over n ranks
        assert got["puts"] == 2  # one put per superbatch on each rank


# --- the data-parallel fits ---


@pytest.mark.parametrize("n", WORLDS)
def test_dp_train_mlp_matches_reference(worlds, n):
    _, ranks, want = worlds[n]
    got, w = ranks[0]["train_mlp"], want["train_mlp"]
    np.testing.assert_allclose(got["history"], w.history, rtol=1e-5)
    assert _max_rel(got["params"], _numpy(w.params)) <= 2e-5
    for k in w.metrics:
        assert got["metrics"][k] == pytest.approx(w.metrics[k], rel=1e-4)
    _same_on_every_rank(ranks, "train_mlp")


@pytest.mark.parametrize("n", WORLDS)
def test_dp_batch_that_does_not_divide_fits_as_one_device(worlds, n):
    """The reference's degrade: a batch the axis does not divide is fed
    whole to every rank, which then runs the single-device fit exactly."""
    _, ranks, _ = worlds[n]
    got, solo = _flat(ranks[0]["train_mlp_odd"]["params"]), _flat(ranks[0]["train_mlp_odd_solo"]["params"])
    assert ranks[0]["train_mlp_odd"]["history"] == ranks[0]["train_mlp_odd_solo"]["history"]
    assert all(np.array_equal(got[k], solo[k]) for k in got)
    _same_on_every_rank(ranks, "train_mlp_odd")


@pytest.mark.parametrize("n", WORLDS)
def test_dp_train_gnn_matches_reference(worlds, n):
    _, ranks, want = worlds[n]
    got, w = ranks[0]["train_gnn"], want["train_gnn"]
    np.testing.assert_allclose(got["history"], w.history, rtol=5e-5)
    assert _max_rel(got["params"], _numpy(w.params)) <= 2e-3
    for k in w.metrics:
        assert got["metrics"][k] == pytest.approx(w.metrics[k], rel=1e-3, abs=1e-6), k
    _same_on_every_rank(ranks, "train_gnn")


@pytest.mark.parametrize("n", WORLDS)
def test_dp_train_gru_matches_reference(worlds, n):
    _, ranks, want = worlds[n]
    got, w = ranks[0]["train_gru"], want["train_gru"]
    np.testing.assert_allclose(got["history"], w.history, rtol=1e-5)
    assert _max_rel(got["params"], _numpy(w.params)) <= 2e-3
    for k in w.metrics:
        assert got["metrics"][k] == pytest.approx(w.metrics[k], rel=1e-4)
    _same_on_every_rank(ranks, "train_gru")


# --- graph parallel ---


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("what", ["sharded_forward", "sharded_embed"])
def test_sharded_forward_and_embed_match_reference(worlds, n, what):
    _, ranks, want = worlds[n]
    got = np.concatenate([r[what] for r in ranks])
    np.testing.assert_allclose(got, want[what], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_train_gnn_sharded_learns_as_the_reference(worlds, n):
    """bfloat16 SAGE inputs on both sides, one full-batch step an epoch:
    the limits of ``train_gnn``'s parity (test_torch_train)."""
    inp, ranks, want = worlds[n]
    got, w = ranks[0]["train_gnn_sharded"], want["train_gnn_sharded"]
    assert got["history"][-1] < got["history"][0]
    np.testing.assert_allclose(got["history"], w.history, rtol=5e-5)
    assert _max_rel(got["params"], _numpy(w.params)) <= 2e-3
    assert got["params"]["node_embed"].shape[0] == len(inp["graph"]["node_ids"])  # unpadded
    for k in w.metrics:
        assert got["metrics"][k] == pytest.approx(w.metrics[k], rel=1e-3, abs=1e-6), k
    _same_on_every_rank(ranks, "train_gnn_sharded")


@pytest.mark.parametrize("n", WORLDS)
def test_gnn_scorer_with_a_gp_mesh_matches_without(worlds, n):
    _, ranks, want = worlds[n]
    for got in ranks:
        np.testing.assert_allclose(got["scorer"]["mesh"], got["scorer"]["plain"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["scorer"]["mesh"], want["scorer"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["scorer"]["emb"], ranks[0]["scorer"]["emb"])


# --- in-mesh FedAvg ---


@pytest.mark.parametrize("n", WORLDS)
def test_fedavg_psum_matches_fedavg_trees(worlds, n):
    _, ranks, want = worlds[n]
    ref = {k.replace("/", "."): v for k, v in _flat(_numpy(want["fedavg"])).items()}
    for got in ranks:
        for k, (psum, host) in got["fedavg"].items():
            np.testing.assert_allclose(psum, host, rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(psum, ref[k], rtol=1e-6, atol=1e-7)


# --- the streamed fit and the round ---


@pytest.mark.parametrize("n", WORLDS)
def test_streamed_fit_over_dp_matches_reference(worlds, n):
    _, ranks, want = worlds[n]
    got = ranks[0]["stream"]
    w_params, w_stats = want["stream"]
    assert got["steps"] == w_stats.steps > 0
    np.testing.assert_allclose(got["losses"], w_stats.losses, rtol=2e-5)
    assert _max_rel(got["params"], w_params) <= 2e-5
    assert got["metrics"]["mse"] == pytest.approx(w_stats.metrics["mse"], rel=1e-4)
    _same_on_every_rank(ranks, "stream")
    # three producers, taken in one order: every rank packs the same
    # superbatches, so every rank lands on the same parameters
    _same_on_every_rank(ranks, "stream_workers")


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_asking_for_different_producer_counts_stream_alike(worlds, n):
    """A CSV stream's spans, and so its shards, follow the producer count,
    which defaults off each host's cores: ranks asking for 2, 3, ...
    producers take the least, so every rank packs the same superbatches
    as with 2 producers each."""
    _, ranks, _ = worlds[n]
    _same_on_every_rank(ranks, "stream_csv_mixed")
    got, want = ranks[0]["stream_csv_mixed"], ranks[0]["stream_csv"]
    assert got["losses"] == want["losses"]
    a, b = _flat(got["params"]), _flat(want["params"])
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("n", WORLDS)
def test_a_time_budget_stops_every_rank_after_the_same_step(worlds, n):
    _, ranks, _ = worlds[n]
    # one dispatch of steps_per_call steps, then every rank stops
    want = {"steps": STREAM_CFG["steps_per_call"], "truncated": True}
    assert [r["stream_budget"] for r in ranks] == [want] * n


def test_training_round_with_a_dp_mesh_matches_reference(worlds):
    """``Training`` at its default ``auto_mesh`` in a world of 2 builds a dp
    mesh over it; the CSV upload streams through the native decoder."""
    n = 2
    _, ranks, want = worlds[n]
    w_ok, w_models = want["round"]
    got = ranks[0]["round"]
    assert got["mesh"] == {"dp": n} and got["ok"] and w_ok, got["errors"]
    assert got["models"].keys() == w_models.keys() == {"mlp", "gnn"}
    for kind, limit in (("mlp", 2e-5), ("gnn", 2e-3)):
        g, w = got["models"][kind], w_models[kind]
        assert g["model_id"] == w["model_id"]
        assert _max_rel(g["params"], w["params"]) <= limit, kind
        for k in w["evaluation"]:
            assert g["evaluation"][k] == pytest.approx(w["evaluation"][k], rel=10 * limit, abs=1e-6), (kind, k)
    for r in ranks[1:]:
        for kind in ("mlp", "gnn"):
            a, b = _flat(r["round"]["models"][kind]["params"]), _flat(got["models"][kind]["params"])
            assert all(np.array_equal(a[k], b[k]) for k in a), kind


# --- the multi-device dry run ---


def test_dryrun_multichip_runs_every_axis_at_two(worlds):
    out = worlds["dryrun"]
    assert out["dp_mp"]["mp"] == 2 and out["dp_mp"]["loss"] == pytest.approx(out["dp_mp"]["solo_loss"], rel=1e-5)
    assert np.isfinite(out["gp"]["history"]).all()
    assert max(out["sp_max_abs_err"].values()) <= 2e-4
    assert out["fed"] == pytest.approx(2.0 / 3.0, rel=1e-6)


# --- the sharding specs, in this process ---


def test_mlp_param_spec_matches_reference():
    tree = _numpy(j_mlp.init_mlp(jax.random.PRNGKey(0), [MLP_FEATURE_DIM, 64, 64, 1]))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        keys = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        want = tuple(j_sharding.mlp_param_spec(path, leaf))
        assert t_sharding.mlp_param_spec(keys, leaf) == want, keys


@pytest.mark.parametrize("n,multiple", [(10, 4), (12, 4), (1, 3)])
def test_pad_to_multiple_matches_reference(n, multiple):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    got, want = t_sharding.pad_to_multiple(x, multiple), j_sharding.pad_to_multiple(x, multiple)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == n


def test_batch_sharding_and_replicate_in_a_world_of_one():
    with one_rank_world():
        mesh = t_make_mesh(dp=1)
        assert t_sharding.batch_sharding(mesh) == (Shard(0),)
        assert t_sharding.batch_sharding(mesh, "mp") == (Replicate(),)
        tree = {"w": torch.ones(2), "layers": [torch.zeros(3)]}
        assert t_sharding.replicate(mesh, tree) is tree
        x = np.arange(6)
        np.testing.assert_array_equal(t_sharding.shard_batch(mesh, {"x": x})["x"], x)
