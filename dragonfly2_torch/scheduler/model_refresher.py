"""Model refresher: the last hop of the train→serve loop (counterpart of
the reference's ``scheduler/model_refresher.py``).

Polls the manager for the *active* MLP model version, downloads the
weights once on version change, builds the port's ``MLPScorer`` on the
refresher's device, checks it with one forward, and installs it into the
running ``MLEvaluator`` (and the batched serving slot). A bad blob leaves
the previous scorer (or the base fallback) serving; an explicit
deactivation withdraws it. The GNN and GRU refreshes come with their
slices: each poll counts them as not installed.

The device is resolved once, in the constructor: a refresher asked for
``cuda`` on a machine without a card raises there, and is never mistaken
for a bad blob inside the poll.

The manager's request messages come from a request factory. The default,
:class:`ProtoRequests`, builds the manager's protobuf messages from an
identical copy of the reference's generated ``manager_pb2`` module,
loaded on first use; :class:`PlainRequests` builds plain records for a
manager stand-in that needs no protobuf.
"""

from __future__ import annotations

import importlib.util
import sys
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.scheduler.evaluator import MLEvaluator
from dragonfly2_torch.scheduler.serving import MLPServed
from dragonfly2_torch.schema.features import MLP_FEATURE_DIM
from dragonfly2_torch.trainer.serving import MLPScorer, deserialize_params_auto
from dragonfly2_torch.utils import dflog

logger = dflog.get("scheduler.model_refresher")

_MANAGER_PB2 = Path(__file__).resolve().parents[1] / "rpc" / "gen" / "manager_pb2.py"


def load_manager_pb2():
    """The manager's generated protobuf module (``rpc/gen/manager_pb2.py``,
    byte-identical to the reference's: its proto package is the RPCs' wire
    name, and the descriptor pool accepts the identical file twice)."""
    name = "dragonfly2_torch.rpc.gen.manager_pb2"
    module = sys.modules.get(name)
    if module is None:
        spec = importlib.util.spec_from_file_location(name, _MANAGER_PB2)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[name] = module
    return module


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


@dataclass
class ListModelsRequest:
    scheduler_cluster_id: int


@dataclass
class GetModelRequest:
    model_id: str
    version: int


class PlainRequests:
    """Builds the same requests as plain records."""

    def list_models(self, scheduler_cluster_id: int) -> ListModelsRequest:
        return ListModelsRequest(scheduler_cluster_id)

    def get_model(self, model_id: str, version: int) -> GetModelRequest:
        return GetModelRequest(model_id, version)


class ModelRefresher:
    """Polls the manager model registry and installs the active MLP model
    into the evaluator; keeps serving the previous model on any error.

    With a :class:`~dragonfly2_torch.scheduler.serving.ScoringService`
    attached, every install also hot-swaps the BATCHED serving slot
    (unless a GNN holds it); the per-call scorer stays installed in the
    evaluator as the next rung down the degradation ladder."""

    def __init__(
        self,
        manager_client,
        evaluator: MLEvaluator,
        scheduler_cluster_id: int = 1,
        interval: float = 60.0,
        serving=None,  # scheduler.serving.ScoringService
        device="cuda",
        requests=None,  # ProtoRequests (default) or PlainRequests
    ):
        self.device = resolve_device(device)
        self.manager = manager_client
        self.evaluator = evaluator
        self.cluster_id = scheduler_cluster_id
        self.interval = interval
        self.serving = serving
        self.requests = requests if requests is not None else ProtoRequests()
        self.loaded_version: tuple[str, int] | None = None  # (model_id, version)
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
                if self.serving is not None and self.serving.model_kind() == "mlp":
                    self.serving.clear()
            return False

        # newest ACTIVATION wins if several MLP models are active —
        # updated_at_ns is stamped by the manager's activate flip, so
        # re-activating an older model takes effect; created_at_ns breaks
        # ties for rows that predate it
        m = max(active, key=lambda m: (m.updated_at_ns, m.created_at_ns))
        key = (m.model_id, m.version)
        if key == self.loaded_version:
            return False

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
            return False

        self.evaluator.set_model(scorer)
        self.loaded_version = key
        if self.serving is not None and self.serving.model_kind() != "gnn":
            self.serving.install(MLPServed(scorer), version=f"{key[0]}/v{key[1]}")
        logger.info("installed model %s v%d into ml evaluator", m.model_id, m.version)
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
