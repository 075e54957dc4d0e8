"""Scheduler announcer: keepalive to the manager + periodic dataset upload
to the trainer (upstream scheduler/announcer/announcer.go:44-235).

Every train interval (default 7 days, upstream
scheduler/config/constants.go:196-197) the announcer opens a `Train`
client-stream and ships both datasets in chunks (default 128 MiB,
upstream announcer.go:39-41).

Payload format is negotiated once per trainer connection via the
Capabilities RPC: a trainer advertising ``columnar-v1`` gets the binary
columnar block files (schema/wire.py — the zero-parse ingest path);
anything else — including an old trainer that answers Capabilities with
UNIMPLEMENTED — gets the CSV files, byte-compatible with the reference.
Both forms carry the same records (the scheduler's dual sink), so ONE
format ships per round and the whole snapshot is discarded on success.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import grpc

from dragonfly2_torch.rpc import protos

trainer_pb2 = protos.load("trainer_pb2")

from dragonfly2_torch.rpc.glue import TRAINER_SERVICE, ServiceClient
from dragonfly2_torch.schema import wire
from dragonfly2_torch.scheduler.storage import Storage
from dragonfly2_torch.scheduler import metrics as M
from dragonfly2_torch.utils import dflog

logger = dflog.get("announcer")

DEFAULT_TRAIN_INTERVAL = 7 * 24 * 3600.0
DEFAULT_UPLOAD_CHUNK = 128 * 1024 * 1024


class Announcer:
    def __init__(
        self,
        storage: Storage,
        ip: str,
        hostname: str,
        trainer_channel: grpc.Channel | None = None,
        manager_client=None,
        cluster_id: str = "",
        train_interval: float = DEFAULT_TRAIN_INTERVAL,
        upload_chunk: int = DEFAULT_UPLOAD_CHUNK,
        keepalive_interval: float = 30.0,
    ):
        self.storage = storage
        self.ip = ip
        self.hostname = hostname
        self.cluster_id = cluster_id
        self.train_interval = train_interval
        self.upload_chunk = upload_chunk
        self.keepalive_interval = keepalive_interval
        self.manager_client = manager_client
        self._trainer = (
            ServiceClient(trainer_channel, TRAINER_SERVICE)
            if trainer_channel is not None
            else None
        )
        # negotiated train payload format; None until the first probe.
        # Re-probed at the start of every upload round (one cheap unary
        # per train interval): a trainer upgraded to binary mid-flight
        # starts receiving binary at the NEXT round, and a rolled-back
        # one degrades to CSV instead of receiving blocks it can't read.
        self._train_format: str | None = None
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- format negotiation ------------------------------------------------
    def negotiated_format(self) -> str:
        """The train payload format for this trainer connection
        (cached). ``columnar-v1`` when the trainer advertises it via
        Capabilities; ``csv`` otherwise — old trainers answer
        UNIMPLEMENTED, which is the designed fallback signal, and ANY
        RPC failure degrades to the format every trainer accepts."""
        if self._train_format is not None:
            return self._train_format
        fmt = wire.CSV_FORMAT_NAME
        try:
            resp = self._trainer.Capabilities(
                trainer_pb2.CapabilitiesRequest(), timeout=30
            )
            if wire.FORMAT_NAME in list(resp.train_formats):
                fmt = wire.FORMAT_NAME
        except grpc.RpcError as e:
            code = e.code() if hasattr(e, "code") else None
            logger.info(
                "capabilities probe failed (%s); falling back to csv payload", code
            )
        self._train_format = fmt
        logger.info("train payload format negotiated: %s", fmt)
        return fmt

    # -- trainer upload ----------------------------------------------------
    def train_once(self) -> bool:
        """One upload round: stream both datasets, EOF triggers the fit.
        Returns False when there's no trainer or no data."""
        if self._trainer is None:
            return False
        # snapshot moves the files aside: records that arrive during the
        # (potentially long) Train stream keep accumulating in fresh
        # files and are uploaded next round instead of being destroyed
        snap = self.storage.snapshot_for_upload()
        if not snap:
            logger.info("no datasets to upload")
            return False

        # fresh probe each round — the peer's capabilities are allowed
        # to change between (week-long) train intervals
        self._train_format = None
        binary = self.negotiated_format() == wire.FORMAT_NAME

        def arm(field: str, msg_cls):
            """One TrainRequest constructor per oneof arm — a single
            envelope definition, not four copies."""
            return lambda chunk: trainer_pb2.TrainRequest(
                ip=self.ip,
                hostname=self.hostname,
                cluster_id=self.cluster_id,
                **{field: msg_cls(dataset=chunk)},
            )

        # per-dataset format decision: binary only when negotiated AND
        # block files exist (a scheduler running with write_blocks=False
        # still uploads CSV on a binary-capable trainer) AND the CSV
        # files aren't a superset of the blocks (a blocks-off era from a
        # previous process — the blocks would ship an incomplete history
        # while the discard below destroyed the rest)
        def plan(
            csv_files: list[Path],
            block_files: list[Path],
            csv_superset: bool,
            csv_arm,
            bin_arm,
        ):
            if binary and block_files and not csv_superset:
                return block_files, bin_arm
            return csv_files, csv_arm

        mlp_files, mlp_arm = plan(
            snap.download_csv,
            snap.download_blocks,
            snap.csv_superset_download,
            arm("train_mlp", trainer_pb2.TrainMlpRequest),
            arm("train_mlp_binary", trainer_pb2.TrainMlpBinaryRequest),
        )
        gnn_files, gnn_arm = plan(
            snap.topology_csv,
            snap.topology_blocks,
            snap.csv_superset_topology,
            arm("train_gnn", trainer_pb2.TrainGnnRequest),
            arm("train_gnn_binary", trainer_pb2.TrainGnnBinaryRequest),
        )

        def requests():
            for path in mlp_files:
                for chunk in self._chunks(path):
                    yield mlp_arm(chunk)
            for path in gnn_files:
                for chunk in self._chunks(path):
                    yield gnn_arm(chunk)

        from dragonfly2_torch.utils import tracing

        try:
            # the upload span is current for the Train call, so the
            # trainer's rpc.Train span (and the async fit under it)
            # lands in this round's trace
            with tracing.get("scheduler").span(
                "train_upload",
                format=wire.FORMAT_NAME if binary else wire.CSV_FORMAT_NAME,
                files=len(mlp_files) + len(gnn_files),
            ):
                self._trainer.Train(requests(), timeout=3600)
        except Exception:
            # no negotiation reset needed: every round re-probes anyway,
            # so a retry after a rolled-back trainer degrades to CSV
            M.TRAIN_UPLOAD_TOTAL.labels("failure").inc()
            raise
        M.TRAIN_UPLOAD_TOTAL.labels("success").inc()
        # uploaded datasets are consumed — including the snapshot files of
        # the format that did NOT ship (same records, other encoding); on
        # failure everything stays in the pending dir and rides along
        # with the next round
        self.storage.discard_uploaded(snap.all_files())
        return True

    def _chunks(self, path: Path):
        with open(path, "rb") as f:
            while True:
                chunk = f.read(self.upload_chunk)
                if not chunk:
                    return
                yield chunk

    # -- background loops --------------------------------------------------
    def serve(self) -> None:
        t = threading.Thread(
            target=self._train_loop, name="scheduler.announcer-train", daemon=True
        )
        t.start()
        self._threads.append(t)
        if self.manager_client is not None:
            k = threading.Thread(
                target=self._keepalive_loop,
                name="scheduler.announcer-keepalive",
                daemon=True,
            )
            k.start()
            self._threads.append(k)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)

    def _train_loop(self) -> None:
        while not self._stop.wait(self.train_interval):
            try:
                self.train_once()
            except Exception:
                logger.exception("dataset upload failed")

    def _keepalive_loop(self) -> None:
        while not self._stop.wait(self.keepalive_interval):
            try:
                self.manager_client.keepalive(
                    source_type="scheduler",
                    hostname=self.hostname,
                    ip=self.ip,
                    cluster_id=self.cluster_id,
                )
            except Exception:
                logger.exception("manager keepalive failed")
