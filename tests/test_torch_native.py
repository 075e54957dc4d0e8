"""The port's native CSV decoder (``dragonfly2_torch/csrc/dfnative.cc``
through ``dragonfly2_torch.schema.native``) against the JAX package's
(``native/dfnative.cc`` through ``dragonfly2_tpu.schema.native``) on the
same seeded CSV files: the pairs (embedded headers, quoted fields, a
quoted newline), a chunked feed across a boundary, record-aligned spans,
the ``min_download_records`` gate, the topology graph and the float16 NaN
case, at the reference's own limits (``tests/test_native.py``: rtol 1e-6 /
atol 1e-7 on pairs, 1e-6 on edge RTTs); then the CSV branch of
``stream_shards`` and a streamed CSV ``Training`` round against the
reference's on the same upload. The port builds its own copy of the
source into ``build/torch_native/`` and never loads the reference's
build."""

import jax
import numpy as np
import pytest
import torch

from dragonfly2_torch.schema import native as t_native
from dragonfly2_torch.trainer import federation as t_federation
from dragonfly2_torch.trainer import ingest as t_ingest
from dragonfly2_torch.trainer import train as t_train
from dragonfly2_torch.trainer import training as t_training
from dragonfly2_torch.trainer.storage import TrainerStorage as TStorage
from dragonfly2_torch.weights import module_tree
from dragonfly2_tpu.models import mlp as j_mlp
from dragonfly2_tpu.schema import native as j_native
from dragonfly2_tpu.schema.columnar import records_to_columns, write_csv
from dragonfly2_tpu.schema.features import MLP_FEATURE_DIM, build_probe_graph, extract_pair_features
from dragonfly2_tpu.schema.records import NetworkTopologyRecord
from dragonfly2_tpu.schema.synth import make_download_records, make_topology_records
from dragonfly2_tpu.trainer import ingest as j_ingest
from dragonfly2_tpu.trainer import train as j_train
from dragonfly2_tpu.trainer import training as j_training
from dragonfly2_tpu.trainer.storage import TrainerStorage as JStorage
from dragonfly2_tpu.utils.idgen import host_id_v2
from torch_reference_native import load_reference_native

torch.set_num_threads(1)

PAIR_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def _reference_library():
    load_reference_native()


def _concat_uploads(path, *rec_lists, tmp_path):
    """A trainer dataset file as the Train stream writes it: each upload
    round a whole CSV with its own header, appended byte-wise."""
    with open(path, "wb") as out:
        for i, recs in enumerate(rec_lists):
            part = tmp_path / f"part{i}.csv"
            write_csv(part, recs)
            out.write(part.read_bytes())


def _same_pairs(got, want):
    assert got.num_downloads == want.num_downloads
    assert got.features.shape == want.features.shape
    np.testing.assert_array_equal(got.download_index, want.download_index)
    np.testing.assert_allclose(got.features, want.features, **PAIR_TOL)
    np.testing.assert_allclose(got.labels, want.labels, **PAIR_TOL)


def test_the_port_builds_its_own_library():
    assert t_native.available() and j_native.available()
    path = t_native.library_path()
    assert path.parent.parts[-2:] == ("build", "torch_native") and path.exists()
    assert t_native.load() is not j_native.load()
    assert t_native.load().df_feature_dim() == MLP_FEATURE_DIM


def test_pairs_match_reference_across_embedded_headers(tmp_path):
    path = tmp_path / "download.csv"
    recs1, recs2 = make_download_records(60, seed=1), make_download_records(40, seed=2)
    _concat_uploads(path, recs1, recs2, tmp_path=tmp_path)
    assert path.read_bytes().count(b"id,tag,application") == 2
    got = t_native.decode_pairs_file(path)
    _same_pairs(got, j_native.decode_pairs_file(path))
    _same_pairs(got, extract_pair_features(records_to_columns(recs1 + recs2)))
    # a round boundary as offset and end, in both
    cut = path.read_bytes().index(b"id,tag,application", 10)
    _same_pairs(t_native.decode_pairs_file(path, offset=cut), j_native.decode_pairs_file(path, offset=cut))
    _same_pairs(t_native.decode_pairs_file(path, end=cut), j_native.decode_pairs_file(path, end=cut))


@pytest.mark.parametrize("location", ['dc|rack,1|"edge"', "dc|row\nrack|x"], ids=["quotes", "newline"])
def test_pairs_with_quoted_fields_match_reference(tmp_path, location):
    recs = make_download_records(6, seed=9)
    recs[0].host.network.location = location
    recs[2].parents[0].host.network.location = location
    path = tmp_path / "dl.csv"
    write_csv(path, recs)
    got = t_native.decode_pairs_file(path)
    assert got.num_downloads == 6
    _same_pairs(got, j_native.decode_pairs_file(path))


def test_a_missing_file_decodes_to_none_in_both(tmp_path):
    assert t_native.decode_pairs_file(tmp_path / "nope.csv") is None
    assert j_native.decode_pairs_file(tmp_path / "nope.csv") is None
    assert t_native.build_probe_graph_file(tmp_path / "nope.csv") is None


@pytest.mark.parametrize("half", [False, True], ids=["f32", "f16"])
def test_a_chunked_feed_across_boundaries_matches_reference(tmp_path, half):
    """Prime-sized chunks split lines (and a quoted newline) mid-record."""
    recs = make_download_records(30, seed=5)
    recs[3].host.network.location = "a\nb,c"
    path = tmp_path / "dl.csv"
    write_csv(path, recs)
    got = list(t_native.stream_pairs_file(path, chunk_bytes=97, half=half, passes=2))
    want = list(j_native.stream_pairs_file(path, chunk_bytes=97, half=half, passes=2))
    assert len(got) == len(want) > 10
    for (gf, gl, gr), (wf, wl, wr) in zip(got, want):
        assert gr == wr and gf.dtype == wf.dtype
        np.testing.assert_array_equal(gf.view(np.uint8), wf.view(np.uint8))
        np.testing.assert_array_equal(gl.view(np.uint8), wl.view(np.uint8))
    assert got[-1][2] == 60


def test_spans_and_their_stream_match_reference(tmp_path, monkeypatch):
    path = tmp_path / "download.csv"
    _concat_uploads(path, make_download_records(80, seed=1), make_download_records(50, seed=2), tmp_path=tmp_path)
    for mod in (t_native, j_native):
        monkeypatch.setattr(mod, "_MIN_SPAN", 4096)
    size = path.stat().st_size
    end = path.read_bytes().index(b"id,tag,application", 10)
    for kw in (dict(n=4), dict(n=3, end=end), dict(n=5, offset=end)):
        spans = t_native.split_file_spans(path, **kw)
        assert spans == j_native.split_file_spans(path, **kw) and len(spans) > 1
        got = list(t_native.stream_pairs_file(spans, chunk_bytes=1000))
        want = list(j_native.stream_pairs_file(spans, chunk_bytes=1000))
        assert [g[2] for g in got] == [w[2] for w in want]
        np.testing.assert_allclose(np.concatenate([g[0] for g in got]), np.concatenate([w[0] for w in want]), **PAIR_TOL)
    assert size > 4096 * 4


def test_max_records_stops_alike(tmp_path):
    path = tmp_path / "dl.csv"
    write_csv(path, make_download_records(50, seed=4))
    got = list(t_native.stream_pairs_file(path, chunk_bytes=500, max_records=7))
    want = list(j_native.stream_pairs_file(path, chunk_bytes=500, max_records=7))
    assert [g[2] for g in got] == [w[2] for w in want] and got[-1][2] >= 7


@pytest.mark.parametrize("streaming", [False, True], ids=["batch", "streamed"])
def test_min_download_records_gate_applies_on_the_native_path(tmp_path, streaming):
    recs = make_download_records(3, seed=11)
    src = tmp_path / "src.csv"
    write_csv(src, recs)
    kw = dict(min_download_records=100, streaming_threshold_bytes=0 if streaming else 1 << 40)
    for name, storage_cls, mod in (("t", TStorage, t_training), ("j", JStorage, j_training)):
        storage = storage_cls(tmp_path / name)
        storage.append_download("h", src.read_bytes())
        extra = {"device": "cpu"} if name == "t" else {}
        training = mod.Training(storage, config=mod.TrainingConfig(auto_mesh=False, **kw), **extra)
        assert training._use_streaming(storage.download_path("h"), 0, False) is streaming
        with pytest.raises(ValueError, match="< min 100"):
            training._train_mlp("h", "ip", "host")


def test_topology_graph_matches_reference(tmp_path):
    path = tmp_path / "topo.csv"
    t1, t2 = make_topology_records(80, num_hosts=24, seed=3), make_topology_records(50, num_hosts=24, seed=4)
    _concat_uploads(path, t1, t2, tmp_path=tmp_path)
    got = t_native.build_probe_graph_file(path, max_degree=8, seed=0)
    for want in (j_native.build_probe_graph_file(path, max_degree=8, seed=0),
                 build_probe_graph(records_to_columns(t1 + t2), max_degree=8, seed=0)):
        assert got.node_ids == want.node_ids and got.num_records == want.num_records
        np.testing.assert_array_equal(got.edge_src, want.edge_src)
        np.testing.assert_array_equal(got.edge_dst, want.edge_dst)
        np.testing.assert_allclose(got.edge_rtt_log_ms, want.edge_rtt_log_ms, rtol=1e-6)
        np.testing.assert_allclose(got.node_features, want.node_features, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got.neighbors, want.neighbors)
        np.testing.assert_array_equal(got.neighbor_mask, want.neighbor_mask)


def test_an_empty_source_id_interns_alike(tmp_path):
    recs = make_topology_records(8, num_hosts=6, seed=0)
    hollow = NetworkTopologyRecord(host=recs[0].host, dest_hosts=recs[0].dest_hosts)
    hollow.host.id = ""
    recs.append(hollow)
    path = tmp_path / "topo.csv"
    write_csv(path, recs)
    got = t_native.build_probe_graph_file(path, max_degree=4)
    want = j_native.build_probe_graph_file(path, max_degree=4)
    assert got.node_ids == want.node_ids and got.num_nodes == want.num_nodes
    np.testing.assert_array_equal(got.edge_src, want.edge_src)
    np.testing.assert_array_equal(got.edge_dst, want.edge_dst)


def test_a_nan_stays_nan_in_float16_as_in_the_reference(tmp_path):
    recs = make_download_records(3, seed=0)
    recs[1].host.cpu.percent = float("nan")
    path = tmp_path / "r.csv"
    write_csv(path, recs)
    got = np.concatenate([f for f, _, _ in t_native.stream_pairs_file(path, half=True)])
    want = np.concatenate([f for f, _, _ in j_native.stream_pairs_file(path, half=True)])
    assert np.isnan(got).any() and not np.isinf(got).any()
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_without_the_library_callers_take_the_numpy_route(tmp_path, monkeypatch):
    path = tmp_path / "dl.csv"
    write_csv(path, make_download_records(4, seed=1))
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setenv("DF_NO_NATIVE", "1")
    assert not t_native.available() and t_native.decode_pairs_file(path) is None
    with pytest.raises(RuntimeError, match="unavailable"):
        list(t_native.stream_pairs_file(path))
    training = t_training.Training(TStorage(tmp_path / "s"), config=t_training.TrainingConfig(
        streaming_threshold_bytes=0), device="cpu")
    assert training._use_streaming(path, 0, False) is False


# --- the CSV branch of stream_shards ---


@pytest.fixture(scope="module")
def upload(tmp_path_factory):
    d = tmp_path_factory.mktemp("csv")
    path = d / "download.csv"
    _concat_uploads(path, make_download_records(150, seed=6), make_download_records(90, seed=7), tmp_path=d)
    return path


@pytest.mark.parametrize("workers", [1, 3])
def test_stream_shards_csv_matches_reference(upload, workers, monkeypatch):
    for mod in (t_native, j_native):
        monkeypatch.setattr(mod, "_MIN_SPAN", 4096)
    end = upload.read_bytes().index(b"id,tag,application", 10)
    kw = dict(passes=2, workers=workers, chunk_bytes=5000, half=True)
    for bound in (dict(), dict(end=end), dict(offset=end)):
        got = list(t_ingest.stream_shards(upload, **kw, **bound))
        want = list(j_ingest.stream_shards(upload, **kw, **bound))
        assert got[-1][2] == want[-1][2] > 0
        key = lambda s: (s[1].tobytes(), s[0].tobytes())  # noqa: E731
        if workers == 1:
            assert [key(s) + (s[2],) for s in got] == [key(s) + (s[2],) for s in want]
        else:  # interleaved across producers: the same shards, in some order
            assert sorted(map(key, got)) == sorted(map(key, want))
            # in turns, the order is one fixed order
            again = list(t_ingest.stream_shards(upload, ordered=True, **kw, **bound))
            assert [key(s) for s in again] == [key(s) for s in t_ingest.stream_shards(upload, ordered=True, **kw, **bound)]
            assert sorted(map(key, again)) == sorted(map(key, want))


def test_streamed_csv_fit_matches_reference(upload):
    """Float32 steps on both sides, the same staged bits (the limits of
    tests/test_torch_ingest.py)."""
    hidden = (16, 16)
    init = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), j_mlp.init_mlp(jax.random.PRNGKey(0), [MLP_FEATURE_DIM, *hidden, 1])
    )
    kw = dict(passes=2, batch_size=96, hidden_dims=hidden, workers=1, eval_every=5)
    j_params, ws = j_ingest.stream_train_mlp(upload, **kw)
    t_params, gs = t_ingest.stream_train_mlp(upload, init=init, device="cpu", **kw)
    assert (gs.download_records, gs.pairs, gs.steps, gs.eval_pairs) == (
        ws.download_records, ws.pairs, ws.steps, ws.eval_pairs)
    assert gs.steps > 0 and gs.read_s > 0
    np.testing.assert_allclose(gs.losses, ws.losses, rtol=2e-5)
    assert gs.metrics["mse"] == pytest.approx(ws.metrics["mse"], rel=1e-4)
    assert 0.0 <= gs.h2d_overlap_pct <= 100.0 and 0.0 <= ws.h2d_overlap_pct <= 100.0
    got = module_tree(t_params)["layers"]
    for g, w in zip(got, j_params["layers"]):
        for k in ("w", "b"):
            assert np.abs(g[k] - np.asarray(w[k])).max() <= 2e-5 * max(np.abs(np.asarray(w[k])).max(), 1e-30)


# --- the trainer's CSV legs ---


class _Uploads:
    def __init__(self, tree):
        self.models, self.tree = {}, tree

    def create_model(self, model_id, model_type, ip, hostname, params, evaluation):
        self.models[model_type] = dict(model_id=model_id, params=self.tree(params), evaluation=dict(evaluation))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items() for k2, v in _flat(sub, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, sub in enumerate(tree) for k2, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree, np.float64)}


def _max_rel(got, want) -> float:
    a, b = _flat(got), _flat(want)
    assert a.keys() == b.keys()
    return max(float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)) for k in a)


def test_streamed_csv_training_round_matches_reference(tmp_path, monkeypatch):
    """One CSV upload round (downloads and topology) through both
    ``Training``s with the streaming threshold at 0: the MLP streams
    through the native decoder, the GNN's graph comes from
    ``build_probe_graph_file``; the uploads match at
    tests/test_torch_training.py's limits."""
    downloads = make_download_records(240, seed=11)
    topology = make_topology_records(160, num_hosts=32, seed=12)
    d, t = tmp_path / "d.csv", tmp_path / "t.csv"
    write_csv(d, downloads)
    write_csv(t, topology)
    fit = dict(hidden_dims=(16, 16), batch_size=64, epochs=2, seed=0)
    common = dict(gru=False, streaming_workers=1, clear_after_train=False, streaming_threshold_bytes=0)
    mlp_init = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), j_mlp.init_mlp(jax.random.PRNGKey(0), [MLP_FEATURE_DIM, 16, 16, 1])
    )
    graph = build_probe_graph(records_to_columns(topology), max_degree=16)
    gnn_init = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), j_train._init_gnn(graph, j_train.GNNFitConfig(**fit))
    )
    calls = {"stream": 0, "graph": 0}
    stream, build = t_native.stream_pairs_file, t_native.build_probe_graph_file

    def count(name, fn):
        def spy(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return spy

    monkeypatch.setattr(t_native, "stream_pairs_file", count("stream", stream))
    monkeypatch.setattr(t_native, "build_probe_graph_file", count("graph", build))
    host_id = host_id_v2("10.0.0.1", "h")
    results = {}
    for name in ("t", "j"):
        storage = (TStorage if name == "t" else JStorage)(tmp_path / name)
        storage.append_download(host_id, d.read_bytes())
        storage.append_network_topology(host_id, t.read_bytes())
        if name == "t":
            uploads = _Uploads(module_tree)
            cfg = t_training.TrainingConfig(mlp=t_train.FitConfig(init=mlp_init, **fit),
                                            gnn=t_train.GNNFitConfig(init=gnn_init, **fit), **common)
            training = t_training.Training(storage, uploads, cfg, device="cpu")
        else:
            uploads = _Uploads(lambda p: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), p))
            cfg = j_training.TrainingConfig(mlp=j_train.FitConfig(**fit), gnn=j_train.GNNFitConfig(**fit),
                                            auto_mesh=False, **common)
            training = j_training.Training(storage, uploads, cfg)
        assert training._use_streaming(storage.download_path(host_id), 0, False)
        outcome = training.train("10.0.0.1", "h")
        assert outcome.ok, (outcome.mlp_error, outcome.gnn_error)
        results[name] = uploads.models
    assert calls == {"stream": 1, "graph": 1}  # the port's leg took the native routes
    for kind, limit in (("mlp", 2e-5), ("gnn", 2e-3)):
        g, w = results["t"][kind], results["j"][kind]
        assert g["model_id"] == w["model_id"]
        assert _max_rel(g["params"], w["params"]) <= limit, kind
        for k in w["evaluation"]:
            assert g["evaluation"][k] == pytest.approx(w["evaluation"][k], rel=10 * limit, abs=1e-6), (kind, k)


def test_csv_batch_fit_and_federation_decode_natively(tmp_path, monkeypatch):
    recs = make_download_records(50, seed=7)
    src = tmp_path / "src.csv"
    write_csv(src, recs)
    storage = TStorage(tmp_path / "s")
    storage.append_download("h", src.read_bytes())
    seen = []
    orig = t_native.decode_pairs_file

    def spy(path, offset=0, end=None):
        seen.append(str(path))
        return orig(path, offset=offset, end=end)

    monkeypatch.setattr(t_native, "decode_pairs_file", spy)
    training = t_training.Training(storage, config=t_training.TrainingConfig(
        mlp=t_train.FitConfig(hidden_dims=(8,), epochs=1, batch_size=256)), device="cpu")
    assert "mse" in training._train_mlp("h", "ip", "host")
    pairs = t_federation._host_pairs(storage, "h")
    assert len(seen) == 2 and all(p.endswith("download_h.csv") for p in seen)
    _same_pairs(pairs, extract_pair_features(records_to_columns(recs)))
