"""Model registry: versioned, state-gated storage of trained models
(counterpart of the reference's ``manager/models_registry.py``; upstream
manager/rpcserver/manager_server_v1.go:800-899 CreateModel,
manager/service/model.go:35-190, manager/models/model.go:19-46).

Every upload creates a new *inactive* version with its weights blob in
object storage under ``models/<model_id>/<version>/model.npz`` (the
upstream's `models/<id>/<ver>/model.graphdef` + Triton config, minus the
Triton detour — the scheduler serves in-process). Activation flips one
version to active and deactivates the rest; serving only ever loads the
active version, so a failed fit can never poison serving.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from dragonfly2_torch.manager.database import Database
from dragonfly2_torch.manager.objectstorage import ObjectStorage

MODELS_BUCKET = "models"

STATE_INACTIVE = "inactive"
STATE_ACTIVE = "active"


@dataclass
class ModelRow:
    model_id: str
    type: str
    version: int
    state: str
    evaluation: dict
    object_key: str
    ip: str = ""
    hostname: str = ""
    scheduler_cluster_id: int = 0
    created_at: float = 0.0
    updated_at: float = 0.0  # last state flip (activation recency)


class ModelRegistry:
    def __init__(self, db: Database, storage: ObjectStorage):
        self.db = db
        self.storage = storage
        self.storage.create_bucket(MODELS_BUCKET)
        import threading

        self._lock = threading.Lock()  # version allocation + state flips
        self._reserved: dict[str, int] = {}  # model_id → highest reserved version

    def create(
        self,
        model_id: str,
        model_type: str,
        weights: bytes,
        evaluation: dict,
        ip: str = "",
        hostname: str = "",
        scheduler_cluster_id: int = 0,
    ) -> ModelRow:
        """New inactive version: weights → object storage, row → DB.
        The version number is *reserved* under the lock, but the (possibly
        slow) weight upload happens outside it so concurrent uploads of
        unrelated models don't serialize behind the slowest put_object;
        the row is only inserted once the blob exists, so an inserted
        version is always loadable. A failed upload just skips a version
        number."""
        with self._lock:
            row = self.db.query_one(
                "SELECT MAX(version) AS v FROM models WHERE model_id = ?", (model_id,)
            )
            version = max(row["v"] or 0, self._reserved.get(model_id, 0)) + 1
            self._reserved[model_id] = version
        key = f"{model_id}/{version}/model.npz"
        self.storage.put_object(MODELS_BUCKET, key, weights)
        with self._lock:
            self.db.execute(
                "INSERT INTO models (model_id, type, version, state, evaluation,"
                " object_key, ip, hostname, scheduler_cluster_id, created_at,"
                " updated_at)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (
                    model_id,
                    model_type,
                    version,
                    STATE_INACTIVE,
                    Database.dumps(evaluation),
                    key,
                    ip,
                    hostname,
                    scheduler_cluster_id,
                    time.time(),
                    time.time(),
                ),
            )
        return self.get(model_id, version)

    def get(self, model_id: str, version: int = 0) -> ModelRow | None:
        """version 0 → the active version."""
        if version == 0:
            r = self.db.query_one(
                "SELECT * FROM models WHERE model_id = ? AND state = ?",
                (model_id, STATE_ACTIVE),
            )
        else:
            r = self.db.query_one(
                "SELECT * FROM models WHERE model_id = ? AND version = ?",
                (model_id, version),
            )
        return self._row(r) if r else None

    def list(self, scheduler_cluster_id: int | None = None) -> list[ModelRow]:
        if scheduler_cluster_id:
            rows = self.db.query(
                "SELECT * FROM models WHERE scheduler_cluster_id = ? ORDER BY model_id, version",
                (scheduler_cluster_id,),
            )
        else:
            rows = self.db.query("SELECT * FROM models ORDER BY model_id, version")
        return [self._row(r) for r in rows]

    def activate(self, model_id: str, version: int) -> ModelRow:
        """Flip one version active, everything else inactive (upstream
        manager/service/model.go:109 updateModelStateToActive).
        ``version=0`` (proto3 default for an unset field) means "the
        currently active version" — resolve it to a concrete version
        first, else the deactivate-all would strand the model with no
        active version."""
        target = self.get(model_id, version)
        if target is None:
            raise KeyError(f"model {model_id} version {version} not found")
        version = target.version
        now = time.time()
        with self._lock:
            self.db.execute(
                "UPDATE models SET state = ? WHERE model_id = ?", (STATE_INACTIVE, model_id)
            )
            # updated_at records ACTIVATION recency: the model refresher
            # must install "most recently activated", not "most recently
            # created" — re-activating an older model is an operator
            # decision that has to take effect
            self.db.execute(
                "UPDATE models SET state = ?, updated_at = ? WHERE model_id = ? AND version = ?",
                (STATE_ACTIVE, now, model_id, version),
            )
        return self.get(model_id, version)

    def deactivate(self, model_id: str, version: int) -> ModelRow:
        """Explicit operator deactivation; stamps updated_at (the 'last
        state flip' the proto documents) under the same lock as
        activate."""
        target = self.get(model_id, version)
        if target is None:
            raise KeyError(f"model {model_id} version {version} not found")
        with self._lock:
            self.db.execute(
                "UPDATE models SET state = ?, updated_at = ? WHERE model_id = ? AND version = ?",
                (STATE_INACTIVE, time.time(), model_id, target.version),
            )
        return self.get(model_id, target.version)

    def delete(self, model_id: str, version: int) -> None:
        row = self.get(model_id, version)
        if row is None:
            return
        self.storage.delete_object(MODELS_BUCKET, row.object_key)
        self.db.execute(
            "DELETE FROM models WHERE model_id = ? AND version = ?", (model_id, version)
        )

    def load_weights(self, model_id: str, version: int = 0) -> bytes:
        row = self.get(model_id, version)
        if row is None:
            raise KeyError(f"model {model_id} v{version} not found")
        return self.storage.get_object(MODELS_BUCKET, row.object_key)

    @staticmethod
    def _row(r: dict) -> ModelRow:
        return ModelRow(
            model_id=r["model_id"],
            type=r["type"],
            version=r["version"],
            state=r["state"],
            evaluation=Database.loads(r["evaluation"]),
            object_key=r["object_key"],
            ip=r["ip"],
            hostname=r["hostname"],
            scheduler_cluster_id=r["scheduler_cluster_id"],
            created_at=r["created_at"],
            updated_at=r.get("updated_at", 0.0),
        )
