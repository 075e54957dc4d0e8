"""Trainer RPC service: the ``Train`` client-stream endpoint and payload
format negotiation (counterpart of the reference's ``trainer/service.py``;
upstream trainer/service/service_v1.go).

The first message keys the uploading scheduler (hostID = sha256(ip,
hostname)); each chunk appends to that host's dataset file — CSV chunks
to ``*.csv``, binary columnar chunks (``schema/wire.py``) to ``*.dfb`` —
and on EOF the fit runs, inline with ``synchronous=True``, else on a
thread so the stream's ack isn't held for the fit.

``Capabilities`` advertises the payload formats this trainer accepts: the
reference's two. CSV payloads train through the reference's own numpy
fallback (its C++ decoder is not ported).

Messages come from a factory: :class:`ProtoMessages` (default) builds the
trainer's protobuf messages from an identical copy of the reference's
``trainer_pb2``, loaded on first use; :class:`PlainMessages` builds plain
records, so a caller in the same process needs no protobuf. The gRPC
server around the service comes with the server slice.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from dragonfly2_torch.rpc import protos
from dragonfly2_torch.schema import wire
from dragonfly2_torch.trainer import metrics as M
from dragonfly2_torch.trainer.storage import TrainerStorage
from dragonfly2_torch.trainer.training import Training
from dragonfly2_torch.utils import dflog, tracing
from dragonfly2_torch.utils.idgen import host_id_v2

logger = dflog.get("trainer.rpc")

# payload kind of a Train message → its oneof field
TRAIN_KINDS = ("train_mlp", "train_gnn", "train_mlp_binary", "train_gnn_binary")


class ProtoMessages:
    """The trainer's protobuf messages."""

    _PAYLOADS = {
        "train_mlp": "TrainMlpRequest",
        "train_gnn": "TrainGnnRequest",
        "train_mlp_binary": "TrainMlpBinaryRequest",
        "train_gnn_binary": "TrainGnnBinaryRequest",
    }

    def __init__(self):
        self._pb2 = None

    def _messages(self):
        if self._pb2 is None:
            self._pb2 = protos.load("trainer_pb2")
        return self._pb2

    def train_request(self, ip: str, hostname: str, kind: str, dataset: bytes):
        pb2 = self._messages()
        payload = getattr(pb2, self._PAYLOADS[kind])(dataset=dataset)
        return pb2.TrainRequest(ip=ip, hostname=hostname, **{kind: payload})

    def train_response(self):
        return self._messages().TrainResponse()

    def capabilities_response(self, formats):
        return self._messages().CapabilitiesResponse(train_formats=list(formats))


@dataclass
class Dataset:
    dataset: bytes


@dataclass
class TrainRequest:
    """A plain ``TrainRequest``: one payload field set, as in the oneof."""

    ip: str
    hostname: str
    train_mlp: "Dataset | None" = None
    train_gnn: "Dataset | None" = None
    train_mlp_binary: "Dataset | None" = None
    train_gnn_binary: "Dataset | None" = None

    def WhichOneof(self, group: str) -> "str | None":
        return next((k for k in TRAIN_KINDS if getattr(self, k) is not None), None)


@dataclass
class TrainResponse:
    pass


@dataclass
class CapabilitiesResponse:
    train_formats: list


class PlainMessages:
    """The same messages as plain records."""

    def train_request(self, ip: str, hostname: str, kind: str, dataset: bytes) -> TrainRequest:
        if kind not in TRAIN_KINDS:
            raise ValueError(f"unknown Train payload kind {kind!r}")
        return TrainRequest(ip, hostname, **{kind: Dataset(dataset)})

    def train_response(self) -> TrainResponse:
        return TrainResponse()

    def capabilities_response(self, formats) -> CapabilitiesResponse:
        return CapabilitiesResponse(list(formats))


class TrainerService:
    # newest-preferred order; Capabilities returns it verbatim
    TRAIN_FORMATS = (wire.FORMAT_NAME, wire.CSV_FORMAT_NAME)

    def __init__(
        self,
        storage: TrainerStorage,
        training: Training,
        synchronous: bool = False,
        messages=None,  # ProtoMessages (default) or PlainMessages
    ):
        self.storage = storage
        self.training = training
        # synchronous=True runs the fit inline (tests, the smoke run)
        self.synchronous = synchronous
        self.messages = messages if messages is not None else ProtoMessages()
        self.train_total = 0
        self.train_failure_total = 0  # mirrored into the metrics registry

    def Capabilities(self, request, context):
        return self.messages.capabilities_response(self.TRAIN_FORMATS)

    def Train(self, request_iterator, context):
        ip = hostname = None
        host_id = None
        self.train_total += 1
        M.TRAIN_TOTAL.inc()
        try:
            for req in request_iterator:
                if host_id is None:
                    ip, hostname = req.ip, req.hostname
                    host_id = host_id_v2(ip, hostname)
                which = req.WhichOneof("request")
                if which == "train_mlp":
                    M.DATASET_BYTES_TOTAL.labels("download").inc(len(req.train_mlp.dataset))
                    self.storage.append_download(host_id, req.train_mlp.dataset)
                elif which == "train_gnn":
                    M.DATASET_BYTES_TOTAL.labels("topology").inc(len(req.train_gnn.dataset))
                    self.storage.append_network_topology(host_id, req.train_gnn.dataset)
                elif which == "train_mlp_binary":
                    M.DATASET_BYTES_TOTAL.labels("download_binary").inc(
                        len(req.train_mlp_binary.dataset)
                    )
                    self.storage.append_download_blocks(host_id, req.train_mlp_binary.dataset)
                elif which == "train_gnn_binary":
                    M.DATASET_BYTES_TOTAL.labels("topology_binary").inc(
                        len(req.train_gnn_binary.dataset)
                    )
                    self.storage.append_network_topology_blocks(
                        host_id, req.train_gnn_binary.dataset
                    )
        except Exception:
            self.train_failure_total += 1
            M.TRAIN_FAILURE_TOTAL.inc()
            if host_id is not None:
                # a broken stream may have landed half an upload round:
                # cut every file back to its last complete round before
                # the announcer retries (a torn block would poison every
                # later append)
                self.storage.truncate_to_round(host_id)
            raise

        if host_id is not None:
            # stream complete: everything appended so far is whole rounds
            self.storage.mark_download_round(host_id)
            if self.synchronous:
                self.training.train(ip, hostname)
            else:
                threading.Thread(
                    target=self._train_safely,
                    args=(ip, hostname, tracing.current_span()),
                    name="trainer.fit",
                    daemon=True,
                ).start()
        return self.messages.train_response()

    def _train_safely(self, ip: str, hostname: str, parent_span=None) -> None:
        try:
            with tracing.use_span(parent_span):
                outcome = self.training.train(ip, hostname)
            if not outcome.ok:
                self.train_failure_total += 1
        except Exception:
            self.train_failure_total += 1
            logger.exception("training run failed for %s/%s", ip, hostname)
