"""Model refresher: the last hop of the train→serve loop (counterpart of
the reference's ``scheduler/model_refresher.py``).

Polls the manager for the *active* MLP model version, downloads the
weights once on version change, builds the port's ``MLPScorer`` on the
refresher's device, checks it with one forward, and installs it into the
running ``MLEvaluator`` (and the batched serving slot). Each poll also
installs the newest active GNN as the batched serving model — its node
embeddings computed here, at swap time, over the probe graph that
``networktopology`` exports — and the newest active GRU into the
evaluator's bad-node detection. A bad blob leaves the previous scorer (or
the base fallback) serving; an explicit deactivation withdraws it, and a
withdrawn GNN hands the serving slot back to the loaded MLP.

The device is resolved once, in the constructor: a refresher asked for
``cuda`` on a machine without a card raises there, and is never mistaken
for a bad blob inside the poll.

The manager's request messages come from a request factory. The default,
:class:`ProtoRequests`, builds the manager's protobuf messages from an
identical copy of the reference's generated ``manager_pb2`` module,
loaded on first use; :class:`PlainRequests` builds plain records for a
manager stand-in that needs no protobuf. The same factories build the
trainer's ``CreateModel`` upload (:class:`ManagerUploader`) and the preheat
planner's ``CreateJob``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.scheduler.evaluator import MLEvaluator
from dragonfly2_torch.scheduler.serving import GNNServed, MLPServed
from dragonfly2_torch.schema.columnar import records_to_columns
from dragonfly2_torch.schema.features import MLP_FEATURE_DIM, build_probe_graph
from dragonfly2_torch.trainer.serving import (
    GNNScorer,
    GRUScorer,
    MLPScorer,
    deserialize_params_auto,
    serialize_params,
)
from dragonfly2_torch.utils import dflog

logger = dflog.get("scheduler.model_refresher")


def load_manager_pb2():
    """The manager's generated protobuf module (``rpc/gen/manager_pb2.py``,
    byte-identical to the reference's)."""
    return protos.load("manager_pb2")


class ProtoRequests:
    """Builds the manager's protobuf request messages."""

    def __init__(self):
        self._pb2 = None

    def _messages(self):
        if self._pb2 is None:
            self._pb2 = load_manager_pb2()
        return self._pb2

    def list_models(self, scheduler_cluster_id: int):
        return self._messages().ListModelsRequest(scheduler_cluster_id=scheduler_cluster_id)

    def get_model(self, model_id: str, version: int):
        return self._messages().GetModelRequest(model_id=model_id, version=version)

    def create_model(self, model_id, model_type, ip, hostname, weights, evaluation):
        pb2 = self._messages()
        return pb2.CreateModelRequest(
            model_id=model_id,
            type=model_type,
            ip=ip,
            hostname=hostname,
            weights=weights,
            evaluation=pb2.ModelEvaluation(**evaluation_fields(evaluation)),
        )

    def create_job(self, job_type: str, args_json: str, scheduler_cluster_id: int):
        return self._messages().CreateJobRequest(
            type=job_type, args_json=args_json, scheduler_cluster_id=scheduler_cluster_id
        )


@dataclass
class ListModelsRequest:
    scheduler_cluster_id: int


@dataclass
class GetModelRequest:
    model_id: str
    version: int


@dataclass
class ModelEvaluation:
    precision: float = 0.0
    recall: float = 0.0
    f1: float = 0.0
    mse: float = 0.0
    mae: float = 0.0


@dataclass
class CreateModelRequest:
    model_id: str
    type: str
    ip: str
    hostname: str
    weights: bytes
    evaluation: ModelEvaluation


@dataclass
class CreateJobRequest:
    type: str
    args_json: str
    scheduler_cluster_id: int


def evaluation_fields(evaluation: "dict[str, float]") -> "dict[str, float]":
    """The five evaluation numbers the manager stores with a model, 0.0
    where the fit reported none (an MLP upload has no precision)."""
    return {k: float(evaluation.get(k, 0.0)) for k in ("precision", "recall", "f1", "mse", "mae")}


class PlainRequests:
    """Builds the same requests as plain records."""

    def list_models(self, scheduler_cluster_id: int) -> ListModelsRequest:
        return ListModelsRequest(scheduler_cluster_id)

    def get_model(self, model_id: str, version: int) -> GetModelRequest:
        return GetModelRequest(model_id, version)

    def create_model(
        self, model_id, model_type, ip, hostname, weights, evaluation
    ) -> CreateModelRequest:
        return CreateModelRequest(
            model_id, model_type, ip, hostname, weights,
            ModelEvaluation(**evaluation_fields(evaluation)),
        )

    def create_job(self, job_type: str, args_json: str, scheduler_cluster_id: int) -> CreateJobRequest:
        return CreateJobRequest(job_type, args_json, scheduler_cluster_id)


class ManagerUploader:
    """The trainer's side of the manager client (``trainer.training.
    ManagerClient``): serializes a fitted model with
    ``weights.serialize_params`` (the reference's npz bytes) and sends
    ``CreateModel`` through ``stub`` — the manager's gRPC client, or a
    stand-in with a ``CreateModel`` method — with requests from a
    factory (``ProtoRequests`` by default)."""

    def __init__(self, stub, requests=None):
        self.stub = stub
        self.requests = requests if requests is not None else ProtoRequests()

    def create_model(self, model_id, model_type, ip, hostname, params, evaluation):
        self.stub.CreateModel(
            self.requests.create_model(
                model_id, model_type, ip, hostname, serialize_params(params), evaluation
            )
        )


class ModelRefresher:
    """Polls the manager model registry and installs the active MLP model
    into the evaluator; keeps serving the previous model on any error.

    With a :class:`~dragonfly2_torch.scheduler.serving.ScoringService`
    attached, every install also hot-swaps the BATCHED serving slot
    (in-flight batches finish on the model they snapshotted): the active
    GNN occupies it when one is activated, the MLP otherwise; the per-call
    MLP stays installed in the evaluator as the next rung down the
    degradation ladder."""

    def __init__(
        self,
        manager_client,
        evaluator: MLEvaluator,
        scheduler_cluster_id: int = 1,
        interval: float = 60.0,
        serving=None,  # scheduler.serving.ScoringService
        networktopology=None,  # probe-graph source for GNN embeddings
        device="cuda",
        requests=None,  # ProtoRequests (default) or PlainRequests
    ):
        self.device = resolve_device(device)
        self.manager = manager_client
        self.evaluator = evaluator
        self.cluster_id = scheduler_cluster_id
        self.interval = interval
        self.serving = serving
        self.networktopology = networktopology
        self.requests = requests if requests is not None else ProtoRequests()
        self.loaded_version: tuple[str, int] | None = None  # (model_id, version)
        self.loaded_gru_version: tuple[str, int] | None = None
        self.loaded_gnn_version: tuple[str, int] | None = None
        # the installed per-call scorer, kept so a GNN withdrawal can
        # re-occupy the serving slot through the one install path
        self._mlp_scorer = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def refresh_once(self) -> bool:
        """One poll round; returns True when a new model was installed."""
        try:
            resp = self.manager.ListModels(self.requests.list_models(self.cluster_id))
        except Exception as e:
            logger.warning("model list poll failed: %s", e)
            return False

        # GRU + GNN refresh ride every poll, independent of the MLP's
        # install state (each is best-effort and never blocks the MLP)
        gru_installed = self._refresh_gru(resp)
        gnn_installed = self._refresh_gnn(resp)

        active = [
            m for m in resp.models if m.state == "active" and m.type == "mlp"
        ]
        if not active:
            # no active model → serve the base fallback (never uninstall a
            # model *on error*, but an explicit deactivation is an operator
            # decision and must take effect)
            if self.loaded_version is not None:
                logger.info("active model withdrawn; falling back to base evaluator")
                self.evaluator.set_model(None)
                self.loaded_version = None
                self._mlp_scorer = None
                if self.serving is not None and self.serving.model_kind() == "mlp":
                    self.serving.clear()
            return gru_installed or gnn_installed

        # newest ACTIVATION wins if several MLP models are active —
        # updated_at_ns is stamped by the manager's activate flip, so
        # re-activating an older model takes effect; created_at_ns breaks
        # ties for rows that predate it
        m = max(active, key=lambda m: (m.updated_at_ns, m.created_at_ns))
        key = (m.model_id, m.version)
        if key == self.loaded_version:
            return gru_installed or gnn_installed

        try:
            w = self.manager.GetModelWeights(self.requests.get_model(m.model_id, m.version))
            scorer = MLPScorer(deserialize_params_auto(w.weights), device=self.device)
            # one forward before install: a scorer that cannot run must
            # never reach the scheduling hot path
            scorer.predict(np.zeros((1, MLP_FEATURE_DIM), np.float32))
        except Exception as e:
            logger.warning(
                "loading model %s v%d failed (%s); keeping previous", m.model_id, m.version, e
            )
            return gru_installed or gnn_installed

        self.evaluator.set_model(scorer)
        self.loaded_version = key
        self._mlp_scorer = scorer
        self._serve_mlp(scorer, key)
        logger.info("installed model %s v%d into ml evaluator", m.model_id, m.version)
        return True

    def _serve_mlp(self, scorer, key) -> None:
        """Hot-swap the batched serving slot to this MLP — unless a GNN
        holds it (the GNN is the higher rung; the per-call MLP remains the
        fallback under it either way)."""
        if self.serving is None or self.serving.model_kind() == "gnn":
            return
        self.serving.install(MLPServed(scorer), version=f"{key[0]}/v{key[1]}")

    def _refresh_gnn(self, resp) -> bool:
        """Install the newest active GNN as the batched serving model:
        weights from the registry, embeddings computed HERE (swap time)
        from the live probe graph and kept on the device. Best-effort — a
        broken GNN (or a probe graph too small to embed) leaves the MLP
        serving. Returns True when a GNN was (re)installed."""
        if self.serving is None:
            return False
        active = [m for m in resp.models if m.state == "active" and m.type == "gnn"]
        if not active:
            if self.loaded_gnn_version is not None:
                logger.info("active gnn withdrawn; serving falls back to mlp")
                self.loaded_gnn_version = None
                if self.serving.model_kind() == "gnn":
                    self.serving.clear()
                    # re-occupy the slot with the loaded MLP, if any —
                    # through the one install path
                    if self.loaded_version is not None and self._mlp_scorer is not None:
                        self._serve_mlp(self._mlp_scorer, self.loaded_version)
            return False
        m = max(active, key=lambda m: (m.updated_at_ns, m.created_at_ns))
        key = (m.model_id, m.version)
        if key == self.loaded_gnn_version:
            return False
        try:
            w = self.manager.GetModelWeights(self.requests.get_model(m.model_id, m.version))
            scorer = self._build_gnn_scorer(deserialize_params_auto(w.weights))
            if scorer is None:
                return False
            self.serving.install(GNNServed(scorer), version=f"{key[0]}/v{key[1]}")
        except Exception as e:
            logger.warning(
                "loading gnn %s v%d failed (%s); keeping previous serving model",
                m.model_id,
                m.version,
                e,
            )
            return False
        self.loaded_gnn_version = key
        logger.info(
            "installed gnn %s v%d as the batched serving model", m.model_id, m.version
        )
        return True

    def _build_gnn_scorer(self, params):
        """Probe graph → swap-time-embedded ``GNNScorer`` (None when the
        graph cannot embed yet: no topology source or < 2 hosts)."""
        if self.networktopology is None:
            logger.info("gnn active but no probe-graph source; not serving it")
            return None
        records = self.networktopology.export_records()
        graph = build_probe_graph(records_to_columns(records)) if records else None
        if graph is None or graph.num_nodes < 2:
            logger.info("probe graph too small to embed; not serving the gnn")
            return None
        scorer = GNNScorer(params, graph, device=self.device)
        # one forward at swap time, like the MLP install
        scorer.predict_rtt_log_ms([graph.node_ids[0]], [graph.node_ids[1]])
        return scorer

    def _refresh_gru(self, resp) -> bool:
        """Install the newest active GRU alongside the MLP (model-based
        bad-node detection); best-effort — a broken GRU never blocks the
        MLP install or scheduling. Returns True when a GRU was
        (re)installed."""
        if not hasattr(self.evaluator, "set_gru"):
            return False
        active = [m for m in resp.models if m.state == "active" and m.type == "gru"]
        if not active:
            if self.loaded_gru_version is not None:
                logger.info("active gru withdrawn; bad-node falls back to statistics")
                self.evaluator.set_gru(None)
                self.loaded_gru_version = None
            return False
        m = max(active, key=lambda m: (m.updated_at_ns, m.created_at_ns))
        key = (m.model_id, m.version)
        if key == self.loaded_gru_version:
            return False
        try:
            w = self.manager.GetModelWeights(self.requests.get_model(m.model_id, m.version))
            scorer = GRUScorer(deserialize_params_auto(w.weights), device=self.device)
            scorer.predict_next_log_cost([[5.0, 6.0, 7.0]])  # one forward before install
        except Exception as e:
            logger.warning(
                "loading gru %s v%d failed (%s); keeping previous", m.model_id, m.version, e
            )
            return False
        self.evaluator.set_gru(scorer)
        self.loaded_gru_version = key
        logger.info("installed gru %s v%d for bad-node detection", m.model_id, m.version)
        return True

    # ------------------------------------------------------------------
    def start(self) -> None:
        self.refresh_once()
        self._thread = threading.Thread(
            target=self._loop, name="scheduler.model-refresher", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.refresh_once()
            except Exception:
                logger.exception("model refresh round failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
