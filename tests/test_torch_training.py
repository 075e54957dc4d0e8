"""The port's trainer assembly (dragonfly2_torch.trainer: service, training,
storage; the manager upload through ``ManagerUploader``) against the JAX
package's on the CPU: the same ``trainer_pb2`` Train messages go through
both packages' ``TrainerService`` (synchronous), with one init tree per
model loaded into both. Both must write byte-identical storage files,
upload the same model ids and types, and fit the same parameters and
evaluations; a broken stream truncates both to the round boundary; the
port's uploaded npz scores alike in both packages' ``MLPScorer``; and the
parts the port leaves out raise."""

import jax
import numpy as np
import pytest
import torch

from dragonfly2_torch.scheduler.model_refresher import (
    ManagerUploader,
    PlainRequests,
    ProtoRequests,
)
from dragonfly2_torch.trainer import service as t_service
from dragonfly2_torch.trainer import train as t_train
from dragonfly2_torch.trainer import training as t_training
from dragonfly2_torch.trainer.serving import MLPScorer as TScorer
from dragonfly2_torch.trainer.storage import TrainerStorage as TStorage
from dragonfly2_torch.weights import deserialize_params_auto as t_deserialize
from dragonfly2_tpu.models import mlp as j_mlp
from dragonfly2_tpu.rpc import gen  # noqa: F401
from dragonfly2_tpu.schema import columnar as j_columnar
from dragonfly2_tpu.schema import features as j_features
from dragonfly2_tpu.schema import synth as j_synth
from dragonfly2_tpu.schema import wire as j_wire
from dragonfly2_tpu.schema.features import MLP_FEATURE_DIM
from dragonfly2_tpu.trainer import service as j_service
from dragonfly2_tpu.trainer import train as j_train
from dragonfly2_tpu.trainer import training as j_training
from dragonfly2_tpu.trainer.serving import MLPScorer as JScorer
from dragonfly2_tpu.trainer.serving import deserialize_params_auto
from dragonfly2_tpu.trainer.storage import TrainerStorage as JStorage

import trainer_pb2  # noqa: E402  (the reference's generated module)

torch.set_num_threads(1)

IP, HOST = "10.1.2.3", "scheduler-a"
MLP_HIDDEN, GNN_HIDDEN = (16, 16), (16, 16)


class _Uploads:
    """The reference's manager client stand-in: records each upload with
    its params as a numpy tree."""

    def __init__(self):
        self.models = []

    def create_model(self, model_id, model_type, ip, hostname, params, evaluation):
        params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
        self.models.append(dict(model_id=model_id, type=model_type, ip=ip, hostname=hostname,
                                params=params, evaluation=dict(evaluation)))


class _Stub:
    """The manager's ``CreateModel`` for the port's uploader: keeps the
    request (a real ``manager_pb2.CreateModelRequest``)."""

    def __init__(self):
        self.requests = []

    def CreateModel(self, request):
        self.requests.append(request)


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


def _data(tmp_path, payload):
    """→ (Train messages of one upload round, topology records)."""
    downloads = j_synth.make_download_records(240, seed=11)
    topology = j_synth.make_topology_records(160, num_hosts=32, seed=12)
    if payload == "csv":
        d, t = tmp_path / "d.csv", tmp_path / "t.csv"
        j_columnar.write_csv(d, downloads)
        j_columnar.write_csv(t, topology)
        mlp_kind, gnn_kind = "train_mlp", "train_gnn"
        mlp_bytes, gnn_bytes = d.read_bytes(), t.read_bytes()
    else:
        mlp_kind, gnn_kind = "train_mlp_binary", "train_gnn_binary"
        mlp_bytes = b"".join(j_wire.encode_train_block(downloads[i : i + 48]) for i in range(0, 240, 48))
        gnn_bytes = j_wire.encode_topology_block(topology)
    cls = {
        "train_mlp": trainer_pb2.TrainMlpRequest,
        "train_gnn": trainer_pb2.TrainGnnRequest,
        "train_mlp_binary": trainer_pb2.TrainMlpBinaryRequest,
        "train_gnn_binary": trainer_pb2.TrainGnnBinaryRequest,
    }
    msgs = []
    for kind, data in ((mlp_kind, mlp_bytes), (gnn_kind, gnn_bytes)):
        for off in range(0, len(data), 40_000):  # announcer-style chunks, cut anywhere
            msgs.append(trainer_pb2.TrainRequest(
                ip=IP, hostname=HOST, **{kind: cls[kind](dataset=data[off : off + 40_000])}
            ))
    return msgs, topology


def _configs(streaming: bool, topology):
    fit = dict(hidden_dims=MLP_HIDDEN, batch_size=64, epochs=2, seed=0)
    gnn = dict(hidden_dims=GNN_HIDDEN, batch_size=64, epochs=2, seed=0)
    common = dict(
        gru=False, streaming_workers=1, clear_after_train=False,
        streaming_threshold_bytes=0 if streaming else 1 << 40,
    )
    want = j_training.TrainingConfig(
        mlp=j_train.FitConfig(**fit), gnn=j_train.GNNFitConfig(**gnn), auto_mesh=False, **common
    )
    # the reference's inits: PRNGKey(0) for the MLP (batch fit: seed 0;
    # streamed fit: always 0) and _init_gnn on the graph it will build
    mlp_init = _numpy(j_mlp.init_mlp(jax.random.PRNGKey(0), [MLP_FEATURE_DIM, *MLP_HIDDEN, 1]))
    graph = j_features.build_probe_graph(j_columnar.records_to_columns(topology), max_degree=16)
    gnn_init = _numpy(j_train._init_gnn(graph, j_train.GNNFitConfig(**gnn)))
    got = t_training.TrainingConfig(
        mlp=t_train.FitConfig(init=mlp_init, **fit),
        gnn=t_train.GNNFitConfig(init=gnn_init, **gnn),
        **common,
    )
    return got, want


def _files(directory) -> dict:
    return {p.name: p.read_bytes() for p in sorted(directory.iterdir()) if p.is_file()}


@pytest.mark.parametrize("payload,streaming", [("binary", True), ("binary", False), ("csv", False)],
                         ids=["binary-streamed", "binary-batch", "csv-batch"])
def test_train_stream_matches_reference(tmp_path, payload, streaming):
    """The MLP fits in float32 on both sides (limits as in
    test_torch_train/test_torch_ingest: ≤ 2e-5 of each leaf's largest
    entry); the GNN's SAGE layers are bfloat16 on both sides (≤ 2e-3)."""
    msgs, topology = _data(tmp_path, payload)
    got_cfg, want_cfg = _configs(streaming, topology)

    j_dir, t_dir = tmp_path / "jax", tmp_path / "torch"
    j_storage, t_storage = JStorage(j_dir), TStorage(t_dir)
    uploads, stub = _Uploads(), _Stub()
    j_svc = j_service.TrainerService(
        j_storage, j_training.Training(j_storage, uploads, want_cfg), synchronous=True
    )
    t_svc = t_service.TrainerService(
        t_storage,
        t_training.Training(t_storage, ManagerUploader(stub, ProtoRequests()), got_cfg, device="cpu"),
        synchronous=True,
    )
    assert isinstance(t_svc.Train(iter(msgs), None), trainer_pb2.TrainResponse)
    j_svc.Train(iter(msgs), None)

    assert _files(t_dir) == _files(j_dir) and len(_files(j_dir)) == 3  # both datasets + rounds
    # the legs run concurrently: uploads arrive in either order
    assert sorted((r.model_id, r.type, r.ip, r.hostname) for r in stub.requests) == sorted(
        (m["model_id"], m["type"], m["ip"], m["hostname"]) for m in uploads.models
    )
    want = {m["type"]: m for m in uploads.models}
    got = {r.type: r for r in stub.requests}
    assert got.keys() == want.keys() == {"mlp", "gnn"}
    for kind, limit in (("mlp", 2e-5), ("gnn", 2e-3)):
        g, w = got[kind], want[kind]
        assert g.model_id == w["model_id"]
        assert _max_rel(deserialize_params_auto(g.weights), w["params"]) <= limit, kind
        for k in ("mse", "mae", "precision", "recall", "f1"):
            assert getattr(g.evaluation, k) == pytest.approx(
                w["evaluation"].get(k, 0.0), rel=10 * limit, abs=1e-6
            ), (kind, k)


class _NoFit:
    def __init__(self):
        self.calls = []

    def train(self, ip, hostname):
        self.calls.append((ip, hostname))


def _broken(msgs, after):
    for i, m in enumerate(msgs):
        if i == after:
            raise ConnectionError("stream broke")
        yield m


def test_a_broken_stream_truncates_to_the_round_boundary(tmp_path):
    msgs, _ = _data(tmp_path, "binary")
    dirs = {}
    for name, storage_cls, service_mod in (
        ("torch", TStorage, t_service), ("jax", JStorage, j_service)
    ):
        storage = storage_cls(tmp_path / name)
        fit = _NoFit()
        svc = service_mod.TrainerService(storage, fit, synchronous=True)
        svc.Train(iter(msgs), None)  # one whole round
        first = _files(tmp_path / name)
        with pytest.raises(ConnectionError):
            svc.Train(_broken(msgs, after=3), None)  # half a round lands, then breaks
        assert _files(tmp_path / name) == first, name
        assert fit.calls == [(IP, HOST)] and svc.train_failure_total == 1
        svc.Train(iter(msgs), None)  # the retry appends whole blocks
        dirs[name] = _files(tmp_path / name)
    assert dirs["torch"] == dirs["jax"]
    assert t_service.TrainerService(None, None).Capabilities(None, None).train_formats == list(
        j_service.TrainerService(None, None).Capabilities(None, None).train_formats
    )


def test_plain_messages_land_the_same_bytes(tmp_path):
    msgs, _ = _data(tmp_path, "binary")
    plain = t_service.PlainMessages()
    kinds = {"train_mlp_binary", "train_gnn_binary"}
    again = [
        plain.train_request(m.ip, m.hostname, k, getattr(m, k).dataset)
        for m in msgs
        for k in kinds
        if m.WhichOneof("request") == k
    ]
    for name, these in (("proto", msgs), ("plain", again)):
        svc = t_service.TrainerService(TStorage(tmp_path / name), _NoFit(), synchronous=True,
                                       messages=plain if name == "plain" else None)
        svc.Train(iter(these), None)
    assert _files(tmp_path / "proto") == _files(tmp_path / "plain")
    assert t_service.PlainMessages().capabilities_response(["x"]).train_formats == ["x"]


def test_uploaded_npz_scores_alike_in_both_scorers(tmp_path):
    x = j_features.extract_pair_features(
        j_columnar.records_to_columns(j_synth.make_download_records(60, seed=3))
    ).features
    result = t_train.train_mlp(
        x, x[:, 0], t_train.FitConfig(hidden_dims=(8,), batch_size=32, epochs=1), device="cpu"
    )
    stub = _Stub()
    for requests in (ProtoRequests(), PlainRequests()):
        ManagerUploader(stub, requests).create_model(
            "m", "mlp", IP, HOST, result.params, {"mse": 0.5, "mae": 0.25}
        )
    proto, plain = stub.requests
    assert proto.weights == plain.weights and proto.evaluation.mse == plain.evaluation.mse == 0.5
    assert proto.evaluation.precision == 0.0
    want = JScorer(deserialize_params_auto(proto.weights)).predict(x)
    got = TScorer(t_deserialize(proto.weights), device="cpu").predict(x)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "config,mesh,item",
    [
        # the reference's defaults, gru=True included, build since the GRU
        # leg landed, and a mesh since item 11 did
        (dict(), object(), "item 11"),
        (dict(gru=False), object(), "item 11"),
    ],
    ids=["gru", "mesh"],
)
def test_legs_not_ported_yet_raise(tmp_path, config, mesh, item):
    """Nothing raises any more: an explicit mesh is the round's, and the
    default ``auto_mesh`` in a single process is None, as the reference's
    on one device (a dp mesh over a world of 2: tests/test_torch_mesh.py)."""
    cfg = t_training.TrainingConfig(**config)
    assert t_training.Training(TStorage(tmp_path), config=cfg, mesh=mesh, device="cpu").mesh is mesh
    assert cfg.auto_mesh and t_training.Training(TStorage(tmp_path), config=cfg, device="cpu").mesh is None


def test_checkpoint_dir_round_matches_reference(tmp_path):
    """A round with ``checkpoint_dir`` in both packages: each batch fit
    snapshots every epoch under ``<dir>/<model>-<host_id>`` and clears its
    snapshots on success; the uploads match as without snapshots."""
    msgs, topology = _data(tmp_path, "binary")
    got_cfg, want_cfg = _configs(False, topology)
    want_cfg.checkpoint_dir = str(tmp_path / "jax-snapshots")
    got_cfg.checkpoint_dir = str(tmp_path / "torch-snapshots")
    j_storage, t_storage = JStorage(tmp_path / "jax"), TStorage(tmp_path / "torch")
    uploads, stub = _Uploads(), _Stub()
    training = t_training.Training(t_storage, ManagerUploader(stub, ProtoRequests()), got_cfg, device="cpu")
    stamped = training._fit_config(got_cfg.mlp, "mlp", "h")
    assert stamped.checkpoint_dir == str(tmp_path / "torch-snapshots" / "mlp-h")
    assert stamped.init is got_cfg.mlp.init and got_cfg.mlp.checkpoint_dir is None
    t_service.TrainerService(t_storage, training, synchronous=True).Train(iter(msgs), None)
    j_service.TrainerService(j_storage, j_training.Training(j_storage, uploads, want_cfg),
                             synchronous=True).Train(iter(msgs), None)
    want = {m["type"]: m for m in uploads.models}
    got = {r.type: r for r in stub.requests}
    assert got.keys() == want.keys() == {"mlp", "gnn"}
    for kind, limit in (("mlp", 2e-5), ("gnn", 2e-3)):
        assert _max_rel(deserialize_params_auto(got[kind].weights), want[kind]["params"]) <= limit, kind
    snapshots = tmp_path / "torch-snapshots"
    assert not snapshots.exists() or not any(snapshots.iterdir())
    assert not any(p.is_file() for p in (tmp_path / "jax-snapshots").rglob("*"))


def testrainingdefaults_to_the_card(tmp_path):
    config = t_training.TrainingConfig(gru=False)
    if torch.cuda.is_available():
        assert t_training.Training(TStorage(tmp_path), config=config).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            t_training.Training(TStorage(tmp_path), config=config)


def test_profile_dir_traces_the_whole_round(tmp_path):
    """One ``torch.profiler`` session for the round (two at once, one per
    leg, crash the profiler), recording the ops of every thread."""
    import json

    msgs, topology = _data(tmp_path, "binary")
    cfg, _ = _configs(True, topology)
    cfg.profile_dir = str(tmp_path / "prof")
    storage = TStorage(tmp_path / "torch")
    training = t_training.Training(storage, None, cfg, device="cpu")
    t_service.TrainerService(storage, training, synchronous=True).Train(iter(msgs), None)
    trace = tmp_path / "prof" / f"{t_training.host_id_v2(IP, HOST)}.json"
    events = json.loads(trace.read_text())["traceEvents"]
    threads = {e["tid"] for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")}
    assert len(threads) >= 2  # the GNN leg's and the MLP step thread's ops at least


def test_incremental_rounds_match_reference(tmp_path):
    """Two upload rounds with ``incremental=True``: each round's MLP fit
    decodes only the blocks appended since the committed offset, and both
    packages commit the same offsets and fit the same models."""
    msgs, topology = _data(tmp_path, "binary")
    later = j_synth.make_download_records(96, seed=21)
    second = [trainer_pb2.TrainRequest(
        ip=IP, hostname=HOST,
        train_mlp_binary=trainer_pb2.TrainMlpBinaryRequest(dataset=j_wire.encode_train_block(later)),
    )]
    got_cfg, want_cfg = _configs(False, topology)
    for cfg in (got_cfg, want_cfg):
        cfg.incremental = True
    uploads, stub = _Uploads(), _Stub()
    j_storage, t_storage = JStorage(tmp_path / "jax"), TStorage(tmp_path / "torch")
    j_svc = j_service.TrainerService(
        j_storage, j_training.Training(j_storage, uploads, want_cfg), synchronous=True
    )
    t_svc = t_service.TrainerService(
        t_storage,
        t_training.Training(t_storage, ManagerUploader(stub, ProtoRequests()), got_cfg, device="cpu"),
        synchronous=True,
    )
    for round_msgs in (msgs, second):
        t_svc.Train(iter(round_msgs), None)
        j_svc.Train(iter(round_msgs), None)
        assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    assert "offsets.json" in _files(tmp_path / "jax")
    want = [m for m in uploads.models if m["type"] == "mlp"]
    got = [r for r in stub.requests if r.type == "mlp"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert _max_rel(deserialize_params_auto(g.weights), w["params"]) <= 2e-5
        assert g.evaluation.mse == pytest.approx(w["evaluation"]["mse"], rel=2e-4)
