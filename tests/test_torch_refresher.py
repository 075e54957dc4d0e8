"""The port's ``ModelRefresher`` (dragonfly2_torch.scheduler.model_refresher)
against the JAX package's real manager over gRPC, and beside the
reference's refresher on the same registry: it installs the active MLP
into the port's evaluator and serving slot, withdraws it on deactivation,
keeps the previous model on a bad blob and refuses a model of another
feature width. Its device is resolved once, at construction: asked for
CUDA on a machine without a card it raises there."""

import numpy as np
import pytest
import torch

from dragonfly2_torch.scheduler import model_refresher as t_refresher
from dragonfly2_torch.scheduler.evaluator import MLEvaluator as TEvaluator
from dragonfly2_torch.scheduler.serving import ScoringService as TService
from dragonfly2_torch.trainer.serving import MLPScorer as TScorer
from dragonfly2_tpu.manager.database import Database
from dragonfly2_tpu.manager.models_registry import ModelRegistry
from dragonfly2_tpu.manager.objectstorage import FSObjectStorage
from dragonfly2_tpu.manager.service import SERVICE_NAME, ManagerService
from dragonfly2_tpu.rpc import gen  # noqa: F401
from dragonfly2_tpu.rpc.glue import ServiceClient, dial, serve
from dragonfly2_tpu.scheduler.evaluator import MLEvaluator as JEvaluator
from dragonfly2_tpu.scheduler.model_refresher import ModelRefresher as JRefresher
from dragonfly2_tpu.schema.features import MLP_FEATURE_DIM
from dragonfly2_tpu.trainer.serving import serialize_params

import manager_pb2  # noqa: E402  (the reference's generated module)

torch.set_num_threads(1)


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


def _params(seed=0, dims=(MLP_FEATURE_DIM, 16, 1)):
    rng = np.random.default_rng(seed)
    return {
        "layers": [
            {"w": rng.normal(0, 0.4, (i, o)).astype(np.float32), "b": rng.normal(0, 0.1, o).astype(np.float32)}
            for i, o in zip(dims[:-1], dims[1:])
        ]
    }


def _upload(client, weights, model_id="mlp-model"):
    client.CreateModel(
        manager_pb2.CreateModelRequest(
            model_id=model_id,
            type="mlp",
            ip="10.0.0.1",
            hostname="trainer-host",
            weights=weights,
            evaluation=manager_pb2.ModelEvaluation(mse=0.1, mae=0.2),
            scheduler_cluster_id=1,
        )
    )


def _activate(client, version, state="active", model_id="mlp-model"):
    client.UpdateModel(
        manager_pb2.UpdateModelRequest(model_id=model_id, version=version, state=state)
    )


def _pair(client):
    """The port's refresher (with a started scoring service) and the
    reference's, polling one manager → (port refresher, port service,
    reference refresher)."""
    svc = TService()
    svc.start()
    port = t_refresher.ModelRefresher(client, TEvaluator(), serving=svc, device="cpu")
    ref = JRefresher(client, JEvaluator())
    return port, svc, ref


def test_manager_pb2_copy_is_the_reference_module():
    """The port's copy is byte-identical (its proto package is the RPCs'
    wire name) and hands out the reference's own message classes."""
    from pathlib import Path

    import dragonfly2_tpu.rpc.gen as ref_gen

    ours = Path(t_refresher.__file__).parents[1] / "rpc" / "gen" / "manager_pb2.py"
    assert ours.read_bytes() == (Path(ref_gen.__file__).parent / "manager_pb2.py").read_bytes()
    pb2 = t_refresher.load_manager_pb2()
    assert pb2.ListModelsRequest is manager_pb2.ListModelsRequest
    req = t_refresher.ProtoRequests().get_model("m", 3)
    assert req == manager_pb2.GetModelRequest(model_id="m", version=3)
    plain = t_refresher.PlainRequests()
    assert plain.list_models(7).scheduler_cluster_id == 7
    assert (plain.get_model("m", 3).model_id, plain.get_model("m", 3).version) == ("m", 3)


def test_installs_the_active_model_over_grpc(manager):
    port, svc, ref = _pair(manager)
    try:
        params = _params(0)
        _upload(manager, serialize_params(params))
        assert not port.refresh_once() and not ref.refresh_once()  # not active yet
        assert port.evaluator._model is None and not svc.available()

        _activate(manager, 1)
        assert port.refresh_once() and ref.refresh_once()
        assert port.loaded_version == ref.loaded_version == ("mlp-model", 1)
        scorer = port.evaluator._model
        assert isinstance(scorer, TScorer) and scorer.device.type == "cpu"
        assert svc.model_kind() == "mlp" and svc.snapshot()["model_version"] == "mlp-model/v1"
        feats = np.random.default_rng(1).random((6, MLP_FEATURE_DIM)).astype(np.float32)
        np.testing.assert_allclose(
            scorer.predict(feats), ref.evaluator._model.predict(feats), atol=1e-5, rtol=1e-5
        )
        np.testing.assert_allclose(svc.score(feats), scorer.predict(feats), atol=0)
        assert not port.refresh_once()  # same version: no reinstall
    finally:
        svc.stop()


def test_withdraws_on_deactivation(manager):
    port, svc, ref = _pair(manager)
    try:
        _upload(manager, serialize_params(_params(0)))
        _activate(manager, 1)
        assert port.refresh_once() and ref.refresh_once()
        _activate(manager, 1, state="inactive")
        assert not port.refresh_once() and not ref.refresh_once()
        assert port.loaded_version is ref.loaded_version is None
        assert port.evaluator._model is None and ref.evaluator._model is None
        assert not svc.available()
    finally:
        svc.stop()


def test_keeps_the_previous_model_on_a_bad_blob(manager):
    port, svc, ref = _pair(manager)
    try:
        _upload(manager, serialize_params(_params(0)))
        _activate(manager, 1)
        assert port.refresh_once() and ref.refresh_once()
        installed = port.evaluator._model
        _upload(manager, b"not-an-npz")
        _activate(manager, 2)
        assert not port.refresh_once() and not ref.refresh_once()
        assert port.loaded_version == ref.loaded_version == ("mlp-model", 1)
        assert port.evaluator._model is installed
        assert svc.snapshot()["model_version"] == "mlp-model/v1"
    finally:
        svc.stop()


def test_refuses_a_model_of_another_feature_width(manager):
    port, svc, ref = _pair(manager)
    try:
        _upload(manager, serialize_params(_params(0, dims=(12, 16, 1))))
        _activate(manager, 1)
        assert not port.refresh_once() and not ref.refresh_once()
        assert port.loaded_version is ref.loaded_version is None
        assert port.evaluator._model is None and not svc.available()
    finally:
        svc.stop()


def test_cuda_refresher_without_a_card_raises_at_construction(manager):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only machine")
    _upload(manager, serialize_params(_params(0)))
    _activate(manager, 1)
    evaluator = TEvaluator()
    with pytest.raises(RuntimeError, match="cuda"):
        t_refresher.ModelRefresher(manager, evaluator)  # device defaults to cuda
    assert evaluator._model is None and evaluator._rung == ""  # nothing ran, no base install
