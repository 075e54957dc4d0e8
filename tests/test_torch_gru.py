"""The port's GRU (dragonfly2_torch.models.gru, trainer.serving's
``GRUScorer`` and ``np_predict_next_cost``, trainer.train's ``train_gru``,
schema.wire's ``stream_gru_sequences``, the GRU leg of
trainer.training, the task and model ids of utils.idgen) against the JAX
package's on the CPU, from one init tree loaded into both (JAX's random
init cannot be reproduced in torch). The forward agrees to float32
summation order (≤ 2e-5 absolute), the fit to the tolerance the MLP fit
is held to, and a ``Training`` round with ``TrainingConfig(gru=True)``
uploads three models with the reference's ids and the same GRU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_torch.models import gru as t_gru
from dragonfly2_torch.parallel import make_mesh
from dragonfly2_torch.scheduler.model_refresher import ManagerUploader, PlainRequests
from dragonfly2_torch.schema import wire as t_wire
from dragonfly2_torch.trainer import service as t_service
from dragonfly2_torch.trainer import serving as t_serving
from dragonfly2_torch.trainer import train as t_train
from dragonfly2_torch.trainer import training as t_training
from dragonfly2_torch.trainer.storage import TrainerStorage as TStorage
from dragonfly2_torch.utils import idgen as t_idgen
from dragonfly2_torch.weights import deserialize_params_auto, gru_from_numpy, module_tree, serialize_params
from dragonfly2_tpu.models import gru as j_gru
from dragonfly2_tpu.models import mlp as j_mlp
from dragonfly2_tpu.schema import columnar as j_columnar
from dragonfly2_tpu.schema import features as j_features
from dragonfly2_tpu.schema import synth as j_synth
from dragonfly2_tpu.schema import wire as j_wire
from dragonfly2_tpu.trainer import serving as j_serving
from dragonfly2_tpu.trainer import service as j_service
from dragonfly2_tpu.trainer import train as j_train
from dragonfly2_tpu.trainer import training as j_training
from dragonfly2_tpu.trainer.storage import TrainerStorage as JStorage
from dragonfly2_tpu.utils import idgen as j_idgen
from torch_mesh_child import one_rank_world

torch.set_num_threads(1)

FWD_TOL = 2e-5
IP, HOST = "10.9.8.7", "scheduler-g"


def _numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _init(seed=0, in_dim=2, hidden=8, head_hidden=32):
    return _numpy(j_gru.init_gru(jax.random.PRNGKey(seed), in_dim, hidden, head_hidden))


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


def _sequences(n, t=9, f=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, t, f)).astype(np.float32)
    lengths = rng.integers(0, t + 1, n).astype(np.int32)
    lengths[0] = t
    return x, lengths


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_tree_round_trips_and_loads_in_the_reference():
    tree = _init(hidden=16)
    model = gru_from_numpy(tree, device="cpu")
    assert _max_rel(module_tree(model), tree) == 0.0
    back = j_serving.deserialize_params_auto(serialize_params(model))
    assert _max_rel(back, tree) == 0.0
    assert _max_rel(deserialize_params_auto(j_serving.serialize_params(tree)), tree) == 0.0


def test_init_follows_the_reference_scheme():
    model = t_gru.init_gru(torch.Generator().manual_seed(0), 2, 64, head_hidden=32)
    ref = _init(hidden=64)
    got = module_tree(model)
    assert _flat(got).keys() == _flat(ref).keys()
    for name in ("wz", "uz", "bz", "wh", "bh"):
        assert got[name].shape == ref[name].shape, name
    assert np.all(got["bz"] == 0) and np.all(got["head"]["layers"][0]["b"] == 0)
    # N(0, 1/fan_in): the spread of the hidden-to-hidden weights
    assert got["uz"].std() == pytest.approx(1 / 8, rel=0.1)


def test_cell_is_the_references_not_torch_nn_grus():
    tree = _init(hidden=8)
    model = gru_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(1)
    h, x = rng.normal(size=(4, 8)).astype(np.float32), rng.random((4, 2)).astype(np.float32)
    want = np.asarray(j_gru.gru_cell(tree, jnp.asarray(h), jnp.asarray(x)))
    with torch.no_grad():
        got = t_gru.gru_cell(model, torch.tensor(h), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)
    # torch.nn.GRUCell applies the reset gate after the hidden product,
    # with a hidden bias of its own: another function of the same weights
    cell = torch.nn.GRUCell(2, 8)
    with torch.no_grad():
        cell.weight_ih.copy_(torch.tensor(np.concatenate([tree["wr"], tree["wz"], tree["wh"]], 1).T))
        cell.weight_hh.copy_(torch.tensor(np.concatenate([tree["ur"], tree["uz"], tree["uh"]], 1).T))
        cell.bias_ih.copy_(torch.tensor(np.concatenate([tree["br"], tree["bz"], tree["bh"]])))
        cell.bias_hh.zero_()
        other = cell(torch.tensor(x), torch.tensor(h)).numpy()
    assert np.abs(other - want).max() > 1e-3


@pytest.mark.parametrize("n,t,hidden", [(5, 9, 8), (33, 9, 32), (3, 64, 16), (1, 1, 4)])
def test_apply_gru_and_predict_next_cost_match(n, t, hidden):
    tree = _init(seed=n, hidden=hidden)
    model = gru_from_numpy(tree, device="cpu")
    x, lengths = _sequences(n, t, seed=t)
    hs_want, final_want = j_gru.apply_gru(tree, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        hs, final = t_gru.apply_gru(model, torch.tensor(x), torch.tensor(lengths))
        pred = t_gru.predict_next_cost(model, torch.tensor(x), torch.tensor(lengths)).numpy()
    np.testing.assert_allclose(hs.numpy(), np.asarray(hs_want), atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(final.numpy(), np.asarray(final_want), atol=FWD_TOL, rtol=0)
    want = np.asarray(j_gru.predict_next_cost(tree, jnp.asarray(x), jnp.asarray(lengths)))
    np.testing.assert_allclose(pred, want, atol=FWD_TOL, rtol=0)
    # the plain numpy version, both packages'
    np.testing.assert_allclose(t_serving.np_predict_next_cost(tree, x, lengths), want, atol=FWD_TOL, rtol=0)
    np.testing.assert_array_equal(
        t_serving.np_predict_next_cost(tree, x, lengths), j_serving.np_predict_next_cost(tree, x, lengths)
    )
    # a zero-length row keeps h0: its prediction is the head of zeros
    zero = t_serving.np_predict_next_cost(tree, x[:1], np.zeros(1, np.int32))
    np.testing.assert_allclose(
        zero, j_serving.np_predict_next_cost(tree, np.zeros_like(x[:1]), np.zeros(1, np.int32)), atol=FWD_TOL
    )


def test_no_lengths_means_every_step():
    tree = _init(hidden=8)
    x, _ = _sequences(6)
    want = np.asarray(j_gru.predict_next_cost(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = t_gru.predict_next_cost(gru_from_numpy(tree, device="cpu"), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)


def _histories(rng, b):
    """Piece-cost histories in ms: short, exactly GRU_MAX_SEQ, longer than
    it (tail-truncated, positions capped), one cost."""
    lens = [3, j_features.GRU_MAX_SEQ, j_features.GRU_MAX_SEQ + 7, 1, 40, 2]
    return [list(rng.lognormal(np.log(40.0), 0.6, lens[i % len(lens)])) for i in range(b)]


@pytest.mark.parametrize("b", [1, 6, 9, 20, 70])
def test_gru_scorer_matches_the_reference(b):
    """Histories longer than GRU_MAX_SEQ and the zero-length pad rows of
    each bucket rung, ≤ 2e-5 absolute."""
    tree = _init(seed=3, hidden=32)
    hists = _histories(np.random.default_rng(b), b)
    want = np.asarray(j_serving.GRUScorer(tree).predict_next_log_cost(hists))
    got = t_serving.GRUScorer(tree, device="cpu").predict_next_log_cost(hists)
    assert got.shape == (b,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)
    # a module works as well as its tree
    again = t_serving.GRUScorer(gru_from_numpy(tree, device="cpu"), device="cpu")
    np.testing.assert_array_equal(again.predict_next_log_cost(hists), got)


def test_gru_scorer_defaults_to_the_card():
    if torch.cuda.is_available():
        assert t_serving.GRUScorer(_init()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            t_serving.GRUScorer(_init())


# ---------------------------------------------------------------------------
# the fit
# ---------------------------------------------------------------------------


def _piece_sequences(n_records=160, seed=5):
    cols = j_columnar.records_to_columns(j_synth.make_download_records(n_records, seed=seed))
    return j_features.extract_piece_sequences(cols)


@pytest.mark.parametrize("batch,epochs,hidden", [(32, 3, 8), (500, 2, 16), (64, 1, 32)])
def test_train_gru_matches_reference(batch, epochs, hidden):
    """Float32 on both sides: the sums run in another order, a few ulps a
    step. The losses and the holdout metrics are held to the MLP fit's
    limits (test_torch_train): rtol 1e-5 and rel 1e-4. The parameters get
    a looser limit: where a gate bias's gradient sits near zero, Adam's
    normalized step m/√v turns an ulp of gradient into a visible share of
    a step, so such an entry drifts by up to ~6e-4 of its leaf's largest
    entry after 3 epochs."""
    seqs = _piece_sequences()
    cfg = dict(hidden_dims=(hidden,), batch_size=batch, epochs=epochs, seed=2)
    want = j_train.train_gru(seqs.sequences, seqs.labels, lengths=seqs.lengths, config=j_train.FitConfig(**cfg))
    init = _init(seed=2, hidden=hidden)
    got = t_train.train_gru(
        seqs.sequences, seqs.labels, lengths=seqs.lengths,
        config=t_train.FitConfig(init=init, **cfg), device="cpu",
    )
    np.testing.assert_allclose(got.history, want.history, rtol=1e-5)
    assert _max_rel(module_tree(got.params), _numpy(want.params)) <= 2e-3
    assert got.metrics.keys() == want.metrics.keys() == {"mse", "mae"}
    for k in got.metrics:
        assert got.metrics[k] == pytest.approx(want.metrics[k], rel=1e-4)


def test_train_gru_without_init_warm_starts_and_learns():
    seqs = _piece_sequences(300, seed=1)
    got = t_train.train_gru(
        seqs.sequences, seqs.labels, lengths=seqs.lengths,
        config=t_train.FitConfig(hidden_dims=(16,), batch_size=64, epochs=6), device="cpu",
    )
    assert got.history[-1] < got.history[0]
    mean = float(np.mean((seqs.labels - seqs.labels.mean()) ** 2))
    assert np.isfinite(got.metrics["mse"]) and got.metrics["mse"] < mean
    assert got.params.head.layers[-1].b.shape == (1,)


def test_train_gru_without_lengths_uses_every_step():
    x, _ = _sequences(90, seed=4)
    y = x[:, -1, 0].copy()
    cfg = dict(hidden_dims=(8,), batch_size=16, epochs=2, seed=0)
    want = j_train.train_gru(x, y, config=j_train.FitConfig(**cfg))
    got = t_train.train_gru(x, y, config=t_train.FitConfig(init=_init(0, hidden=8), **cfg), device="cpu")
    np.testing.assert_allclose(got.history, want.history, rtol=1e-5)


@pytest.mark.parametrize("what,item", [("mesh", "item 11")])
def test_train_gru_parts_not_ported_yet_raise(what, item, tmp_path):
    """Ported since (item 11): a dp mesh of one rank fits exactly as
    without one (worlds of 2 and 4: tests/test_torch_mesh.py)."""
    x, lengths = _sequences(20)
    cfg = t_train.FitConfig(init=_init(), hidden_dims=(8,), batch_size=8, epochs=2)
    with one_rank_world():
        got = t_train.train_gru(x, x[:, 0, 0], lengths=lengths, device="cpu", mesh=make_mesh(dp=1), config=cfg)
    want = t_train.train_gru(x, x[:, 0, 0], lengths=lengths, device="cpu", config=cfg)
    assert got.history == want.history
    for a, b in zip(got.params.state_dict().values(), want.params.state_dict().values()):
        assert torch.equal(a, b)


def test_train_gru_with_checkpoint_dir_matches_reference_and_writes_nothing(tmp_path):
    """The reference's GRU fit takes no snapshot even with a
    ``checkpoint_dir`` (its shuffle runs one generator across epochs), and
    neither does the port's: the same fit as without one, no file written."""
    seqs = _piece_sequences()
    cfg = dict(hidden_dims=(8,), batch_size=32, epochs=3, seed=0)
    j_dir, t_dir = tmp_path / "jax", tmp_path / "torch"
    want = j_train.train_gru(seqs.sequences, seqs.labels, lengths=seqs.lengths,
                             config=j_train.FitConfig(checkpoint_dir=str(j_dir), **cfg))
    got = t_train.train_gru(seqs.sequences, seqs.labels, lengths=seqs.lengths,
                            config=t_train.FitConfig(init=_init(0, hidden=8), checkpoint_dir=str(t_dir), **cfg),
                            device="cpu")
    np.testing.assert_allclose(got.history, want.history, rtol=1e-5)
    assert not t_dir.exists() and not j_dir.exists()


# ---------------------------------------------------------------------------
# the wire read and the ids
# ---------------------------------------------------------------------------


def test_stream_gru_sequences_matches_reference(tmp_path):
    recs = j_synth.make_download_records(200, seed=7)
    path = tmp_path / "train.dfb"
    blocks = [j_wire.encode_train_block(recs[i : i + 64]) for i in range(0, 200, 64)]
    topo = j_wire.encode_topology_block(j_synth.make_topology_records(10, num_hosts=8, seed=1))
    path.write_bytes(blocks[0] + topo + b"".join(blocks[1:]))  # a topology block is skipped
    for offset, end in ((0, None), (len(blocks[0]) + len(topo), None), (0, len(blocks[0]))):
        got = list(t_wire.stream_gru_sequences(path, offset=offset, end=end))
        want = list(j_wire.stream_gru_sequences(path, offset=offset, end=end))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for f in ("sequences", "labels", "lengths"):
                a, b = getattr(g, f), getattr(w, f)
                assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize(
    "url,meta",
    [
        ("http://o/blob", None),
        ("http://o/blob?sig=abc&keep=1", dict(filter="sig", tag="t", application="app")),
        ("http://o/blob?sig=abc&x=2", dict(filter="sig&x", digest="sha256:ab", range="0-99")),
        ("http://o/b", dict()),
    ],
)
def test_task_ids_match_the_reference(url, meta):
    t_meta = None if meta is None else t_idgen.URLMeta(**meta)
    j_meta = None if meta is None else j_idgen.URLMeta(**meta)
    assert t_idgen.task_id_v1(url, t_meta) == j_idgen.task_id_v1(url, j_meta)
    assert t_idgen.URL_FILTER_SEPARATOR == j_idgen.URL_FILTER_SEPARATOR
    assert t_idgen.gru_model_id_v1("1.2.3.4", "h") == j_idgen.gru_model_id_v1("1.2.3.4", "h")


# ---------------------------------------------------------------------------
# the GRU leg of a training round
# ---------------------------------------------------------------------------


class _Uploads:
    def __init__(self):
        self.models = []

    def create_model(self, model_id, model_type, ip, hostname, params, evaluation):
        self.models.append(dict(model_id=model_id, type=model_type, params=_numpy(params),
                                evaluation=dict(evaluation)))


class _Stub:
    def __init__(self):
        self.requests = []

    def CreateModel(self, request):
        self.requests.append(request)


def _round_messages(payload):
    """One upload round as the reference's ``trainer_pb2`` Train messages:
    download records as CSV or binary blocks, and a probe graph."""
    import tempfile
    from pathlib import Path

    from dragonfly2_tpu.rpc import gen  # noqa: F401

    import trainer_pb2  # noqa: E402  (the reference's generated module)

    downloads = j_synth.make_download_records(200, seed=21)
    topology = j_synth.make_topology_records(120, num_hosts=24, seed=22)
    if payload == "csv":
        with tempfile.TemporaryDirectory() as tmp:
            d, t = Path(tmp) / "d.csv", Path(tmp) / "t.csv"
            j_columnar.write_csv(d, downloads)
            j_columnar.write_csv(t, topology)
            parts = (("train_mlp", d.read_bytes()), ("train_gnn", t.read_bytes()))
    else:
        parts = (
            ("train_mlp_binary", b"".join(j_wire.encode_train_block(downloads[i : i + 50]) for i in range(0, 200, 50))),
            ("train_gnn_binary", j_wire.encode_topology_block(topology)),
        )
    cls = {
        "train_mlp": trainer_pb2.TrainMlpRequest,
        "train_gnn": trainer_pb2.TrainGnnRequest,
        "train_mlp_binary": trainer_pb2.TrainMlpBinaryRequest,
        "train_gnn_binary": trainer_pb2.TrainGnnBinaryRequest,
    }
    msgs = [
        trainer_pb2.TrainRequest(ip=IP, hostname=HOST, **{kind: cls[kind](dataset=data[off : off + 30_000])})
        for kind, data in parts
        for off in range(0, len(data), 30_000)
    ]
    return msgs, topology


class _NoFit:
    def train(self, ip, hostname):
        pass


@pytest.mark.parametrize("payload", ["binary", "csv"])
def test_round_with_gru_uploads_three_models_like_the_reference(tmp_path, payload):
    """``TrainingConfig(gru=True)``: MLP, GNN and GRU upload under the
    reference's three model ids; the GRU, fit from the reference's init on
    the sequences both packages read up to the round boundary, matches it
    at the fit's tolerance."""
    msgs, topology = _round_messages(payload)
    small = dict(hidden_dims=(8,), batch_size=64, epochs=2, seed=0)
    gru_fit = dict(hidden_dims=(8,), batch_size=32, epochs=2, seed=0)
    common = dict(gru=True, streaming_workers=1, clear_after_train=False, gru_min_sequences=8)
    want_cfg = j_training.TrainingConfig(
        mlp=j_train.FitConfig(**small), gnn=j_train.GNNFitConfig(**small),
        gru_config=j_train.FitConfig(**gru_fit), auto_mesh=False, **common,
    )
    graph = j_features.build_probe_graph(j_columnar.records_to_columns(topology), max_degree=16)
    mlp_init = _numpy(j_mlp.init_mlp(jax.random.PRNGKey(0), [j_features.MLP_FEATURE_DIM, 8, 1]))
    got_cfg = t_training.TrainingConfig(
        mlp=t_train.FitConfig(init=mlp_init, **small),
        gnn=t_train.GNNFitConfig(init=_numpy(j_train._init_gnn(graph, j_train.GNNFitConfig(**small))), **small),
        gru_config=t_train.FitConfig(init=_init(0, hidden=8), **gru_fit),
        **common,
    )
    j_storage, t_storage = JStorage(tmp_path / "jax"), TStorage(tmp_path / "torch")
    uploads, stub = _Uploads(), _Stub()
    j_service.TrainerService(
        j_storage, j_training.Training(j_storage, uploads, want_cfg), synchronous=True
    ).Train(iter(msgs), None)
    t_service.TrainerService(
        t_storage,
        t_training.Training(t_storage, ManagerUploader(stub, PlainRequests()), got_cfg, device="cpu"),
        synchronous=True,
    ).Train(iter(msgs), None)

    got = {r.type: r for r in stub.requests}
    want = {m["type"]: m for m in uploads.models}
    assert got.keys() == want.keys() == {"mlp", "gnn", "gru"}
    ids = {
        "mlp": t_idgen.mlp_model_id_v1(IP, HOST),
        "gnn": t_idgen.gnn_model_id_v1(IP, HOST),
        "gru": t_idgen.gru_model_id_v1(IP, HOST),
    }
    for kind, request in got.items():
        assert request.model_id == want[kind]["model_id"] == ids[kind], kind
    g, w = got["gru"], want["gru"]
    assert _max_rel(deserialize_params_auto(g.weights), w["params"]) <= 2e-3  # as in the fit test
    for k in ("mse", "mae"):
        assert getattr(g.evaluation, k) == pytest.approx(w["evaluation"][k], rel=1e-4), k


def test_default_training_config_runs_a_full_round(tmp_path):
    """``TrainingConfig()`` — the reference's defaults, ``gru=True``
    included — builds and runs a whole round: three fits, three uploads,
    the round ``ok``, the consumed dataset cleared."""
    msgs, _ = _round_messages("binary")
    storage = TStorage(tmp_path / "torch")
    stub = _Stub()
    config = t_training.TrainingConfig()
    assert config.gru and config.gru_config.batch_size == 128 and config.gru_config.epochs == 10
    training = t_training.Training(storage, ManagerUploader(stub, PlainRequests()), config, device="cpu")
    t_service.TrainerService(storage, training, synchronous=True).Train(iter(msgs), None)
    assert sorted(r.type for r in stub.requests) == ["gnn", "gru", "mlp"]
    gru = next(r for r in stub.requests if r.type == "gru")
    assert np.isfinite(gru.evaluation.mse) and gru.evaluation.mse > 0
    blocks = storage.download_blocks_path(t_training.host_id_v2(IP, HOST))
    assert not blocks.exists() or blocks.stat().st_size == 0


def test_too_few_sequences_fail_only_the_gru_leg(tmp_path):
    msgs, _ = _round_messages("binary")
    storage = TStorage(tmp_path / "torch")
    stub = _Stub()
    small = dict(hidden_dims=(8,), batch_size=64, epochs=1)
    config = t_training.TrainingConfig(
        mlp=t_train.FitConfig(**small), gnn=t_train.GNNFitConfig(**small), gru_min_sequences=10**9,
    )
    training = t_training.Training(storage, ManagerUploader(stub, PlainRequests()), config, device="cpu")
    t_service.TrainerService(storage, _NoFit(), synchronous=True).Train(iter(msgs), None)
    outcome = training.train(IP, HOST)
    assert outcome.ok and outcome.gru_error and "min" in outcome.gru_error
    assert sorted(r.type for r in stub.requests) == ["gnn", "mlp"]


def test_gru_max_sequences_keeps_the_newest(tmp_path, monkeypatch):
    """The cap trims from the front: the sequences kept are the dataset's
    last ones, the same as the reference's."""
    import dragonfly2_tpu.trainer.train as jt

    msgs, _ = _round_messages("binary")
    cap = 100
    seen = {}

    def spy(name):
        def fit(sequences, labels, lengths=None, **kwargs):
            seen[name] = (sequences.copy(), labels.copy(), lengths.copy())
            raise RuntimeError("stop after the read")

        return fit

    monkeypatch.setattr(t_training, "train_gru", spy("torch"))
    monkeypatch.setattr(jt, "train_gru", spy("jax"))
    for name, storage, training in (
        ("torch", TStorage(tmp_path / "torch"), None),
        ("jax", JStorage(tmp_path / "jax"), None),
    ):
        service_mod = t_service if name == "torch" else j_service
        service_mod.TrainerService(storage, _NoFit(), synchronous=True).Train(iter(msgs), None)
        if name == "torch":
            training = t_training.Training(
                storage, None, t_training.TrainingConfig(gru_max_sequences=cap), device="cpu"
            )
        else:
            training = j_training.Training(
                storage, None, j_training.TrainingConfig(gru_max_sequences=cap, auto_mesh=False)
            )
        with pytest.raises(RuntimeError, match="stop after the read"):
            training._train_gru(j_training.host_id_v2(IP, HOST), IP, HOST)
    total = sum(s.sequences.shape[0] for s in j_wire.stream_gru_sequences(
        TStorage(tmp_path / "torch").download_blocks_path(j_training.host_id_v2(IP, HOST))))
    assert total > cap
    for a, b in zip(seen["torch"], seen["jax"]):
        assert a.shape[0] == cap and np.array_equal(a, b)
