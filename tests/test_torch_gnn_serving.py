"""The port's GNN serving and seed placement (topology engine's
``export_records``, scheduler.networktopology over the engine,
trainer.serving's ``GNNScorer``, scheduler.serving's ``GNNServed``, the
refresher's GNN and GRU halves, scheduler.seed_placement, graft_entry)
against the JAX package's on the CPU: one probe stream fed to both
engines, one npz loaded by both scorers. Scores agree at ≤ 1e-5 (as
``test_gnn_forward_matches_reference``), rankings are equal except
between candidates whose reference scores lie within 1e-5 of each other,
and a pair with a host the GNN never embedded drops only its own decision
one rung."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_torch import graft_entry as t_graft
from dragonfly2_torch.parallel import make_mesh
from dragonfly2_torch.scheduler import model_refresher as t_refresher
from dragonfly2_torch.scheduler import resource as t_res
from dragonfly2_torch.scheduler import seed_placement as t_seeds
from dragonfly2_torch.scheduler import wave as t_wave
from dragonfly2_torch.scheduler.evaluator import MLEvaluator as TEvaluator
from dragonfly2_torch.scheduler import networktopology as t_networktopology
from dragonfly2_torch.scheduler.networktopology import NetworkTopology as TNetworkTopology
from dragonfly2_torch.scheduler.serving import GNNServed as TGNNServed
from dragonfly2_torch.scheduler.serving import ScoringService as TService
from dragonfly2_torch.schema import columnar as t_columnar
from dragonfly2_torch.schema import features as t_features
from dragonfly2_torch.topology import TopologyConfig as TConfig
from dragonfly2_torch.topology import TopologyEngine as TEngine
from dragonfly2_torch.trainer import serving as t_serving
from dragonfly2_torch.utils import flight
from dragonfly2_torch.utils.kvstore import KVStore as TKVStore
from dragonfly2_tpu.manager.database import Database
from dragonfly2_tpu.manager.models_registry import ModelRegistry
from dragonfly2_tpu.manager.objectstorage import FSObjectStorage
from dragonfly2_tpu.manager.service import SERVICE_NAME, ManagerService
from dragonfly2_tpu.models import gru as j_gru
from dragonfly2_tpu.models import mlp as j_mlp
from dragonfly2_tpu.rpc import gen  # noqa: F401
from dragonfly2_tpu.rpc.glue import ServiceClient, dial, serve
from dragonfly2_tpu.scheduler import resource as j_res
from dragonfly2_tpu.scheduler import seed_placement as j_seeds
from dragonfly2_tpu.scheduler.evaluator import MLEvaluator as JEvaluator
from dragonfly2_tpu.scheduler.model_refresher import ModelRefresher as JRefresher
from dragonfly2_tpu.scheduler import networktopology as j_networktopology
from dragonfly2_tpu.scheduler.networktopology import NetworkTopology as JNetworkTopology
from dragonfly2_tpu.scheduler.serving import GNNServed as JGNNServed
from dragonfly2_tpu.scheduler.serving import ScoringService as JService
from dragonfly2_tpu.schema import columnar as j_columnar
from dragonfly2_tpu.schema import features as j_features
from dragonfly2_tpu.schema.features import MLP_FEATURE_DIM
from dragonfly2_tpu.topology import TopologyConfig as JConfig
from dragonfly2_tpu.topology import TopologyEngine as JEngine
from dragonfly2_tpu.trainer import serving as j_serving
from dragonfly2_tpu.trainer import train as j_train
from dragonfly2_tpu.utils.kvstore import KVStore

import manager_pb2  # noqa: E402  (the reference's generated module)
from torch_mesh_child import one_rank_world  # noqa: E402

torch.set_num_threads(1)

HOSTS = 30
SCORE_TOL = 1e-5
TIE = 1e-5


def _numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _world(seed=0, probes=6):
    """Both packages' resource models over hosts h0..h29 and both engines
    fed one probe stream (RTTs from seeded latent coordinates, recent
    timestamps so a flush at the wall clock keeps every edge) → (port
    topology, reference topology)."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 1, (HOSTS, 2))
    now = time.time()
    stream = []
    for i in range(HOSTS):
        for j in rng.choice([k for k in range(HOSTS) if k != i], probes, replace=False):
            rtt = int((1.0 + 80.0 * np.linalg.norm(coords[i] - coords[j]) + rng.exponential(2.0)) * 1e6)
            stream.append((f"h{i}", f"h{j}", rtt, now - 30.0 + float(rng.uniform(0, 10))))
    tcp, utcp = rng.integers(0, 3000, HOSTS), rng.integers(0, 300, HOSTS)
    out = []
    for side, eng in ((t_res, TEngine(TConfig(flush_threshold=10**9), device="cpu")),
                      (j_res, JEngine(JConfig(backend="numpy", flush_threshold=10**9)))):
        resource = side.Resource()
        for i in range(HOSTS):
            h = side.Host(id=f"h{i}", type=side.HostType.SUPER if i % 7 == 0 else side.HostType.NORMAL,
                          hostname=f"host-{i}", ip=f"10.0.0.{i}", port=8000 + i)
            h.network.tcp_connection_count = int(tcp[i])
            h.network.upload_tcp_connection_count = int(utcp[i])
            resource.host_manager.store(h)
        for s, d, rtt, at in stream:
            eng.enqueue(s, d, rtt, created_at=at)
        if side is t_res:
            out.append(TNetworkTopology(TKVStore(), resource.host_manager, engine=eng))
        else:
            out.append(JNetworkTopology(KVStore(), resource.host_manager, engine=eng))
        out[-1].resource = resource
    return tuple(out)


def _rows(records):
    """Records without their random ids and stamps: (src, [(dst, rtt, at)])
    per source host, sorted."""
    return sorted(
        (r.host.id, r.host.type, r.host.ip, r.host.network.tcp_connection_count,
         [(d.id, d.type, d.probes.average_rtt, d.probes.updated_at) for d in r.dest_hosts])
        for r in records
    )


@pytest.fixture(scope="module")
def world():
    return _world()


@pytest.fixture(scope="module")
def graphs(world):
    port, ref = world
    tg = t_features.build_probe_graph(t_columnar.records_to_columns(port.export_records()))
    jg = j_features.build_probe_graph(j_columnar.records_to_columns(ref.export_records()))
    return tg, jg


@pytest.fixture(scope="module")
def gnn_tree(graphs):
    _, jg = graphs
    tree = _numpy(j_train._init_gnn(jg, j_train.GNNFitConfig(hidden_dims=(16, 16))))
    # a spread of head outputs, so rankings are not decided by ties alone
    tree["head"]["layers"][0]["w"] = tree["head"]["layers"][0]["w"] * 4.0
    return tree


# ---------------------------------------------------------------------------
# the probe-graph export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dest_limit", [1, 3, 5, 99])
def test_export_records_match_the_reference(world, dest_limit):
    """The freshest ``dest_limit`` destinations per source (clamped to
    MAX_DEST_HOSTS), every field the graph reads as in the reference."""
    port, ref = world
    got, want = port.export_records(dest_limit), ref.export_records(dest_limit)
    assert len(got) == len(want) == HOSTS
    assert _rows(got) == _rows(want)
    assert max(len(r.dest_hosts) for r in got) == min(dest_limit, 5)


def test_engine_export_keeps_hosts_the_manager_knows(world):
    port, _ = world
    from dragonfly2_torch.scheduler.resource import HostManager

    known = HostManager()
    for i in range(0, HOSTS, 2):
        known.store(port.resource.host_manager.load(f"h{i}"))
    rows = port.engine.export_records(known, 5)
    assert {r.host.id for r in rows} <= {f"h{i}" for i in range(0, HOSTS, 2)}
    assert all(int(d.id[1:]) % 2 == 0 for r in rows for d in r.dest_hosts)


def test_network_topology_is_engine_backed_only(world):
    # since the KV half landed, a topology without an engine walks its KV
    # store: the same probes through both packages' enqueue_probe give the
    # same rows, and an engine attached later adopts the KV graph
    port, ref = world
    tt = TNetworkTopology(TKVStore(), port.resource.host_manager)
    jt = JNetworkTopology(KVStore(), ref.resource.host_manager)
    for k in range(40):
        src, dst = f"h{k % HOSTS}", f"h{(3 * k + 1) % HOSTS}"
        if src == dst:
            continue
        for topo, side in ((tt, t_networktopology), (jt, j_networktopology)):
            topo.enqueue_probe(src, side.Probe(dst, rtt_ns=1_000_000 * (k + 1), created_at=1_000.0 + k))
    assert _rows(tt.export_records()) == _rows(jt.export_records())
    engine = TEngine(TConfig(flush_threshold=10**9), device="cpu")
    tt.engine = engine
    assert tt.hydrate_engine() == len(tt.kv.scan_iter("networktopology:*:*")) > 0


def test_probe_graphs_are_the_same(graphs):
    tg, jg = graphs
    assert tg.node_ids == jg.node_ids and tg.num_nodes == HOSTS
    for f in ("node_features", "edge_src", "edge_dst", "edge_rtt_log_ms", "neighbors", "neighbor_mask"):
        assert np.array_equal(getattr(tg, f), getattr(jg, f)), f


# ---------------------------------------------------------------------------
# the scorer and the served rung
# ---------------------------------------------------------------------------


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    return [f"h{i}" for i in rng.integers(0, HOSTS, n)], [f"h{i}" for i in rng.integers(0, HOSTS, n)]


@pytest.mark.parametrize("n", [1, 7, 40, 130])
def test_gnn_scorer_matches_the_reference(graphs, gnn_tree, n):
    """One npz in both scorers: swap-time embeddings, then scores ≤ 1e-5."""
    tg, jg = graphs
    blob = j_serving.serialize_params(gnn_tree)
    port = t_serving.GNNScorer(t_serving.deserialize_params_auto(blob), tg, device="cpu")
    ref = j_serving.GNNScorer(j_serving.deserialize_params_auto(blob), jg)
    src, dst = _pairs(n, seed=n)
    got = port.predict_rtt_log_ms(src, dst)
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref.predict_rtt_log_ms(src, dst)), atol=SCORE_TOL, rtol=0)
    assert port.has_host("h3") and not port.has_host("ghost")
    # the embedding stays as apply_graphsage made it (bf16 SAGE inputs)
    from dragonfly2_tpu.models.gnn import apply_graphsage

    want_emb = apply_graphsage(gnn_tree, jnp.asarray(jg.node_features), jnp.asarray(jg.neighbors),
                               jnp.asarray(jg.neighbor_mask))
    np.testing.assert_allclose(port._emb.numpy(), np.asarray(want_emb), atol=SCORE_TOL, rtol=0)


def test_gnn_scorer_mesh_is_not_ported_yet(graphs, gnn_tree):
    """Ported since: a gp mesh of one rank embeds as without a mesh, as in
    the reference (the graph-parallel embed over 2 and 4 ranks:
    tests/test_torch_mesh.py)."""
    tg, _ = graphs
    with one_rank_world():
        got = t_serving.GNNScorer(gnn_tree, tg, mesh=make_mesh(gp=1), device="cpu")
    want = t_serving.GNNScorer(gnn_tree, tg, device="cpu")
    assert torch.equal(got._emb, want._emb)


def test_the_card_check_bands_every_rounding_of_the_gnn_head(graphs, gnn_tree):
    """``chip_smoke.hold_served_gnn`` holds the card's served GNN scores to
    the CPU's bf16 head over the card's own embeddings, within a band for
    the hidden units that may round to either bf16 neighbour
    (``chip_smoke.gnn_head_band``). Scores summed in another order must all
    land in it: here the CPU's float32 sums under ``gnn_head_like_the_card``
    against the band's float64 head, on every host pair of the graph and on
    20,000 pairs of seeded unit embeddings, where some units round the
    other way. The band must stay narrow: scores moved by 1e-2 leave it,
    and on most pairs it is under 1e-3 wide."""
    import chip_smoke

    tg, _ = graphs
    card = t_serving.GNNScorer(gnn_tree, tg, device="cpu")
    cpu = t_serving.GNNScorer(gnn_tree, tg, device="cpu")
    src = [a for a in tg.node_ids for _ in tg.node_ids]
    dst = [b for _ in tg.node_ids for b in tg.node_ids]
    with chip_smoke.gnn_head_like_the_card():
        scores = card.predict_rtt_log_ms(src, dst)
    out = chip_smoke.hold_served_gnn("cpu", card, cpu, src, dst, scores)
    assert out["emb_err"] == 0 and out["head_err"] <= chip_smoke.GNN_HEAD_TOL, out
    with pytest.raises(AssertionError, match="outside their rounding band"):
        chip_smoke.hold_served_gnn("cpu", card, cpu, src, dst, scores + 1e-2)

    model = cpu._model
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((2000, cpu._emb.shape[1])).astype(np.float32)
    emb = torch.from_numpy(emb / np.linalg.norm(emb, axis=1, keepdims=True))
    s_idx, d_idx = (torch.from_numpy(rng.integers(0, 2000, 20_000)) for _ in range(2))
    with torch.no_grad():
        want, allowance = chip_smoke.gnn_head_band(model, emb, s_idx, d_idx)
        with chip_smoke.gnn_head_like_the_card():
            got = t_serving.predict_edge(model, emb, s_idx, d_idx).numpy()
    gap = np.abs(got - want)
    assert (gap > chip_smoke.GNN_HEAD_TOL).sum() > 0  # units rounded the other way
    assert (gap - allowance).max() <= chip_smoke.GNN_HEAD_TOL
    assert np.median(allowance) < 1e-3


def _check_rankings(got_rank, want_rank, want_scores):
    """Equal orders, except that candidates whose reference scores lie
    within TIE of each other may trade places."""
    got_rank, want_rank = np.asarray(got_rank), np.asarray(want_rank)
    assert sorted(got_rank) == sorted(want_rank)
    s = np.asarray(want_scores)
    np.testing.assert_allclose(s[got_rank], s[want_rank], atol=TIE, rtol=0)


@pytest.mark.parametrize("counts", [[5, 15, 3], [15] * 6, [1]])
def test_gnn_served_ranks_like_the_reference(graphs, gnn_tree, counts):
    tg, jg = graphs
    port = TGNNServed(t_serving.GNNScorer(gnn_tree, tg, device="cpu"))
    ref = JGNNServed(j_serving.GNNScorer(gnn_tree, jg))
    assert port.kind == ref.kind == "gnn"
    src, dst = _pairs(sum(counts), seed=len(counts))
    pairs = list(zip(src, dst))
    seg = t_wave.segment_ids(counts)
    feats = np.zeros((len(pairs), MLP_FEATURE_DIM), np.float32)
    s, order = port.score_ranked(feats, pairs, seg)
    ws, worder = ref.score_ranked(feats, pairs, seg)
    np.testing.assert_allclose(s, ws, atol=SCORE_TOL, rtol=0)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for k, (g, w) in enumerate(zip(t_wave.split_order(order, counts), t_wave.split_order(worder, counts))):
        _check_rankings(g, w, ws[offsets[k] : offsets[k + 1]])
    np.testing.assert_array_equal(order, t_wave.rank_order(s, seg))
    assert port.supports(pairs) and not port.supports([("h1", "ghost")]) and not port.supports([])


def test_an_unembedded_host_drops_only_its_decision(graphs, gnn_tree):
    """Through both scoring services: the decision holding a host the GNN
    never embedded comes back None (it drops one rung), every other
    decision is served and ranked as in the reference."""
    tg, jg = graphs
    counts = [4, 3, 5]
    src, dst = _pairs(sum(counts), seed=9)
    dst[5] = "ghost"  # in the second decision
    pairs = list(zip(src, dst))
    feats = np.zeros((len(pairs), MLP_FEATURE_DIM), np.float32)
    results = {}
    for name, service_cls, served in (
        ("torch", TService, TGNNServed(t_serving.GNNScorer(gnn_tree, tg, device="cpu"))),
        ("jax", JService, JGNNServed(j_serving.GNNScorer(gnn_tree, jg))),
    ):
        svc = service_cls()
        svc.start()
        try:
            svc.install(served, version="gnn/v1")
            results[name] = svc.score_wave(feats, pairs, counts)
        finally:
            svc.stop()
    got, want = results["torch"], results["jax"]
    assert [r is None for r in got] == [r is None for r in want] == [False, True, False]
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_allclose(g[0], w[0], atol=SCORE_TOL, rtol=0)
            _check_rankings(g[1], w[1], w[0])


# ---------------------------------------------------------------------------
# the refresher, against the reference's manager over gRPC
# ---------------------------------------------------------------------------


@pytest.fixture
def manager(tmp_path):
    db = Database(tmp_path / "manager.db")
    registry = ModelRegistry(db, FSObjectStorage(tmp_path / "objects"))
    server, port = serve({SERVICE_NAME: ManagerService(db, registry)})
    channel = dial(f"127.0.0.1:{port}")
    yield ServiceClient(channel, SERVICE_NAME)
    channel.close()
    server.stop(0)
    db.close()


def _upload(client, model_type, weights, model_id=None):
    client.CreateModel(
        manager_pb2.CreateModelRequest(
            model_id=model_id or f"{model_type}-model", type=model_type, ip="10.0.0.1",
            hostname="trainer-host", weights=weights,
            evaluation=manager_pb2.ModelEvaluation(mse=0.1), scheduler_cluster_id=1,
        )
    )


def _activate(client, model_type, version=1, state="active"):
    client.UpdateModel(
        manager_pb2.UpdateModelRequest(model_id=f"{model_type}-model", version=version, state=state)
    )


def _mlp_blob():
    return j_serving.serialize_params(_numpy(j_mlp.init_mlp(jax.random.PRNGKey(0), [MLP_FEATURE_DIM, 16, 1])))


def _gru_tree():
    return _numpy(j_gru.init_gru(jax.random.PRNGKey(1), 2, 8))


def test_refresher_installs_gnn_and_gru_then_hands_the_slot_back(manager, world, gnn_tree):
    """MLP, GNN and GRU active: the GNN holds the serving slot (its
    embeddings made at swap time over the engine's export) and the GRU
    backs bad-node detection, as the reference's refresher installs them;
    withdrawing the GNN hands the slot back to the loaded MLP, withdrawing
    the GRU returns bad-node detection to statistics."""
    port_topo, ref_topo = world
    _upload(manager, "mlp", _mlp_blob())
    _upload(manager, "gnn", j_serving.serialize_params(gnn_tree))
    _upload(manager, "gru", j_serving.serialize_params(_gru_tree()))
    for kind in ("mlp", "gnn", "gru"):
        _activate(manager, kind)
    t_svc, j_svc = TService(), JService()
    t_svc.start()
    j_svc.start()
    try:
        t_ev, j_ev = TEvaluator(serving=t_svc), JEvaluator()
        port = t_refresher.ModelRefresher(manager, t_ev, serving=t_svc, networktopology=port_topo, device="cpu")
        ref = JRefresher(manager, j_ev, serving=j_svc, networktopology=ref_topo)
        assert port.refresh_once() and ref.refresh_once()
        for r in (port, ref):
            assert r.loaded_version == ("mlp-model", 1)
            assert r.loaded_gnn_version == ("gnn-model", 1)
            assert r.loaded_gru_version == ("gru-model", 1)
        assert t_svc.model_kind() == j_svc.model_kind() == "gnn"
        assert t_svc.snapshot()["model_version"] == "gnn-model/v1"
        # the served GNN scores as the reference's
        src, dst = _pairs(20, seed=3)
        pairs = list(zip(src, dst))
        feats = np.zeros((20, MLP_FEATURE_DIM), np.float32)
        np.testing.assert_allclose(t_svc.score(feats, pairs), j_svc.score(feats, pairs), atol=SCORE_TOL)
        hists = [[40.0, 42.0, 39.0, 41.0], [5.0] * 12]
        np.testing.assert_allclose(
            t_ev._gru.predict_next_log_cost(hists), j_ev._gru.predict_next_log_cost(hists), atol=2e-5
        )
        assert not port.refresh_once()  # same versions: nothing reinstalled

        _activate(manager, "gnn", state="inactive")
        assert not port.refresh_once() and not ref.refresh_once()
        assert port.loaded_gnn_version is ref.loaded_gnn_version is None
        assert t_svc.model_kind() == j_svc.model_kind() == "mlp"
        assert t_svc.snapshot()["model_version"] == "mlp-model/v1"

        _activate(manager, "gru", state="inactive")
        assert not port.refresh_once()
        assert port.loaded_gru_version is None and t_ev._gru is None
    finally:
        t_svc.stop()
        j_svc.stop()


def test_a_gnn_without_a_probe_graph_leaves_the_mlp_serving(manager, gnn_tree):
    _upload(manager, "mlp", _mlp_blob())
    _upload(manager, "gnn", j_serving.serialize_params(gnn_tree))
    _activate(manager, "mlp")
    _activate(manager, "gnn")
    svc = TService()
    svc.start()
    try:
        port = t_refresher.ModelRefresher(manager, TEvaluator(serving=svc), serving=svc, device="cpu")
        assert port.refresh_once()  # the MLP
        assert port.loaded_gnn_version is None and svc.model_kind() == "mlp"
    finally:
        svc.stop()


def test_a_broken_gnn_keeps_the_mlp_and_a_broken_gru_keeps_statistics(manager, world, gnn_tree):
    port_topo, _ = world
    bad = dict(gnn_tree)
    bad["node_embed"] = bad["node_embed"][:5]  # embedded for another graph
    _upload(manager, "mlp", _mlp_blob())
    _upload(manager, "gnn", j_serving.serialize_params(bad))
    _upload(manager, "gru", b"not-an-npz")
    for kind in ("mlp", "gnn", "gru"):
        _activate(manager, kind)
    svc = TService()
    svc.start()
    try:
        ev = TEvaluator(serving=svc)
        port = t_refresher.ModelRefresher(manager, ev, serving=svc, networktopology=port_topo, device="cpu")
        assert port.refresh_once()
        assert port.loaded_gnn_version is None and svc.model_kind() == "mlp"
        assert port.loaded_gru_version is None and ev._gru is None
    finally:
        svc.stop()


def test_create_job_requests_from_both_factories():
    proto = t_refresher.ProtoRequests().create_job("preheat", '{"urls": []}', 3)
    assert proto == manager_pb2.CreateJobRequest(type="preheat", args_json='{"urls": []}', scheduler_cluster_id=3)
    plain = t_refresher.PlainRequests().create_job("preheat", "{}", 3)
    assert (plain.type, plain.args_json, plain.scheduler_cluster_id) == ("preheat", "{}", 3)


def test_evaluator_drops_only_the_unembedded_decision_to_the_mlp(graphs, gnn_tree):
    """Through the port's ``MLEvaluator.evaluate_wave``: with a GNN served
    and the MLP per call, the wave's one decision holding an unembedded
    host is demoted (ranked by the per-call MLP), the rest are ranked by
    the GNN."""
    tg, _ = graphs
    resource = t_res.Resource()
    for i in list(range(HOSTS)) + ["ghost"]:
        hid = i if isinstance(i, str) else f"h{i}"
        resource.host_manager.store(t_res.Host(id=hid, hostname=hid, ip="10.1.0.1"))
    hosts = resource.host_manager
    task = t_res.Task("task-0", url="https://origin/blob")
    task.content_length = 64 << 20
    task.total_piece_count = -(-task.content_length // task.piece_length)
    resource.task_manager.store(task)

    def peer(pid, hid):
        p = t_res.Peer(pid, task, hosts.load(hid))
        resource.peer_manager.store(p)
        return p

    children = [peer(f"c{j}", f"h{j}") for j in range(3)]
    sets = [
        [peer(f"p{j}-{k}", f"h{10 + 4 * j + k}") for k in range(4)] for j in range(3)
    ]
    sets[1][2] = peer("p-ghost", "ghost")
    svc = TService()
    svc.start()
    try:
        from dragonfly2_torch.trainer.serving import MLPScorer

        mlp = MLPScorer(j_serving.deserialize_params_auto(_mlp_blob()), device="cpu")
        ev = TEvaluator(model=mlp, serving=svc)
        gnn = t_serving.GNNScorer(gnn_tree, tg, device="cpu")
        svc.install(TGNNServed(gnn), version="gnn/v1")
        since = time.time_ns()
        ranked = ev.evaluate_wave(children, sets, [task.total_piece_count] * 3)
        events = [
            e for e in flight.snapshot(["scheduler"])["scheduler"]
            if e["type"] == "scheduler.wave_evaluated" and e["ts_ns"] >= since
        ]
        assert events and events[-1]["demoted"] == 1
        assert ev._rung == "serving"
        for j in (0, 2):
            scores = gnn.predict_rtt_log_ms([children[j].host.id] * 4, [p.host.id for p in sets[j]])
            want = [sets[j][int(k)] for k in np.argsort(scores, kind="stable")]
            assert [p.id for p in ranked[j]] == [p.id for p in want]
        assert sorted(p.id for p in ranked[1]) == sorted(p.id for p in sets[1])
    finally:
        svc.stop()


# ---------------------------------------------------------------------------
# seed placement and the entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("candidates", [None, ["h1", "h4", "h9", "h20", "ghost"]])
def test_recommend_seeds_matches_the_reference(world, gnn_tree, candidates):
    port_topo, ref_topo = world
    got = t_seeds.recommend_seeds(port_topo, gnn_tree, k=4, candidates=candidates, device="cpu")
    want = j_seeds.recommend_seeds(ref_topo, gnn_tree, k=4, candidates=candidates)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["mean_predicted_rtt_log_ms"] == pytest.approx(w["mean_predicted_rtt_log_ms"], abs=2e-4)
    gv = {r["host_id"]: r["mean_predicted_rtt_log_ms"] for r in got}
    wv = {r["host_id"]: r["mean_predicted_rtt_log_ms"] for r in want}
    # the same hosts, except where two means sit within rounding of each other
    for h in set(gv) ^ set(wv):
        v = gv.get(h, wv.get(h))
        assert any(abs(v - x) <= 2e-4 for x in list(gv.values()) + list(wv.values()) if x != v)


def test_recommend_seeds_by_rtt_matches_the_reference(world):
    port_topo, ref_topo = world
    for candidates in (None, ["h2", "h3", "h17"]):
        got = t_seeds.recommend_seeds_by_rtt(port_topo.engine, k=3, candidates=candidates)
        want = j_seeds.recommend_seeds_by_rtt(ref_topo.engine, k=3, candidates=candidates)
        assert [r["host_id"] for r in got] == [r["host_id"] for r in want]
        for g, w in zip(got, want):
            assert g["mean_rtt_ms"] == pytest.approx(w["mean_rtt_ms"], abs=1e-3)
    assert t_seeds.recommend_seeds_by_rtt(None) == []


def test_seed_placement_refuses_an_empty_candidate_list(world, gnn_tree):
    port_topo, ref_topo = world
    with pytest.raises(ValueError, match="no candidate host is in the probe graph"):
        t_seeds.recommend_seeds(port_topo, gnn_tree, candidates=[], device="cpu")
    with pytest.raises(ValueError, match="no candidate host is in the probe graph"):
        j_seeds.recommend_seeds(ref_topo, gnn_tree, candidates=[])
    with pytest.raises(ValueError, match="no candidate host is rankable"):
        t_seeds.recommend_seeds_by_rtt(port_topo.engine, candidates=[])
    with pytest.raises(ValueError, match="no candidate host is rankable"):
        t_seeds.recommend_seeds_by_rtt(port_topo.engine, candidates=["ghost"])
    empty = type("NT", (), {"export_records": lambda self: []})()
    assert t_seeds.recommend_seeds(empty, gnn_tree, device="cpu") == []


def test_graft_entry_matches_the_references():
    """The same example graph; the reference's parameters through the
    port's forward give the reference's edge RTTs (≤ 1e-5)."""
    import __graft_entry__ as j_graft

    from dragonfly2_torch.weights import graphsage_from_numpy

    fn, args = t_graft.entry(device="cpu")
    j_fn, j_args = j_graft.entry()
    for got, want in zip(args[1:], j_args[1:]):
        assert np.array_equal(got.numpy(), np.asarray(want))
    with torch.no_grad():
        out = fn(*args)
        ref_model = graphsage_from_numpy(_numpy(j_args[0]), device="cpu")
        mine = fn(ref_model, *args[1:]).numpy()
    assert out.shape == (len(args[4]),) and torch.isfinite(out).all()
    np.testing.assert_allclose(mine, np.asarray(j_fn(*j_args)), atol=SCORE_TOL, rtol=0)
    assert dict(args[0].named_parameters()).keys() == dict(ref_model.named_parameters()).keys()
