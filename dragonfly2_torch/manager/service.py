"""The manager's gRPC surface as its clients see it (counterpart of the
reference's ``manager/service.py``, the client half only): the service
name and ``ManagerGrpcClientAdapter``, the scheduler's ``manager_client``
(announcer keepalives) and the trainer's uploader over gRPC. The manager
itself — registry, database, job queue — is not ported; the port's
servers talk to any manager that speaks the reference's wire."""

from __future__ import annotations

from dragonfly2_torch.rpc import protos
from dragonfly2_torch.rpc.glue import MANAGER_SERVICE as SERVICE_NAME  # noqa: F401

manager_pb2 = protos.load("manager_pb2")


class ManagerGrpcClientAdapter:
    """Adapts the trainer's ManagerClient protocol onto the gRPC client —
    serializes params (the reference's npz bytes) and fills
    CreateModelRequest."""

    def __init__(self, channel):
        from dragonfly2_torch.rpc.glue import ServiceClient

        self._client = ServiceClient(channel, SERVICE_NAME)

    def create_model(self, model_id, model_type, ip, hostname, params, evaluation):
        from dragonfly2_torch.weights import serialize_params

        self._client.CreateModel(
            manager_pb2.CreateModelRequest(
                model_id=model_id,
                type=model_type,
                ip=ip,
                hostname=hostname,
                weights=serialize_params(params),
                evaluation=manager_pb2.ModelEvaluation(
                    precision=evaluation.get("precision", 0.0),
                    recall=evaluation.get("recall", 0.0),
                    f1=evaluation.get("f1", 0.0),
                    mse=evaluation.get("mse", 0.0),
                    mae=evaluation.get("mae", 0.0),
                ),
            )
        )

    def keepalive(self, source_type, hostname, ip, cluster_id=0):
        self._client.KeepAlive(
            iter(
                [
                    manager_pb2.KeepAliveRequest(
                        source_type=source_type,
                        hostname=hostname,
                        ip=ip,
                        cluster_id=int(cluster_id or 0),
                    )
                ]
            )
        )
