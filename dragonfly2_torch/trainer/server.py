"""Trainer server assembly (counterpart of the reference's
``trainer/server.py``; upstream Dragonfly2's trainer/trainer.go): manager
client + storage + training core + gRPC server, Serve/Stop lifecycle.

The fits run on ``device`` (``"cuda"`` by default; a machine without a
card raises unless ``"cpu"`` is asked for). With a manager the server
pushes its ``dragonfly_trainer_*`` series to the manager's
``ReportTelemetry`` every ``telemetry_interval`` seconds; with
``metrics_port >= 0`` it serves ``/metrics``, ``/healthz`` and
``/debug/*``; with a ``checkpoint_dir`` the MLP and GNN fits snapshot
every epoch and a restarted round resumes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from dragonfly2_torch.rpc import glue
from dragonfly2_torch.rpc.glue import TRAINER_SERVICE as SERVICE_NAME
from dragonfly2_torch.trainer.service import TrainerService
from dragonfly2_torch.trainer.storage import TrainerStorage
from dragonfly2_torch.trainer.train import FitConfig, GNNFitConfig
from dragonfly2_torch.trainer.training import Training, TrainingConfig
from dragonfly2_torch.utils import dflog, flight, profiling

logger = dflog.get("trainer.server")


@dataclass
class TrainerServerConfig:
    data_dir: str = "/tmp/dragonfly2-trainer"
    # where the fits run: "cuda" (the card) or "cpu" when the caller asks
    device: str = "cuda"
    listen: str = "127.0.0.1:0"
    manager_address: str = ""
    # fit knobs (subset; full control through TrainingConfig in-process)
    mlp_epochs: int = 3
    mlp_batch_size: int = 8192
    gnn_epochs: int = 60
    min_download_records: int = 1
    min_topology_records: int = 1
    # third model family: GRU over per-(task,parent) piece-cost
    # sequences extracted from the same download records. On by default,
    # matching TrainingConfig.gru: the ml evaluator's model-based
    # bad-node detection must train under production defaults.
    gru: bool = True
    gru_min_sequences: int = 8
    incremental: bool = False
    streaming: bool = True
    streaming_workers: int = 1
    # data-parallel fit over every card of the host when more than one is
    # present (TrainingConfig.auto_mesh); on a one-card host the fit is
    # single-device, and the multi-card mesh is not ported (raises)
    auto_mesh: bool = True
    # torch.profiler trace per round ("" = off)
    profile_dir: str = ""
    # per-(model, host) fit snapshots: a crashed fit resumes from its
    # newest epoch ("" = off)
    checkpoint_dir: str = ""
    # run fits inline with the Train RPC (tests/debug) instead of async
    synchronous: bool = False
    # Prometheus /metrics endpoint (upstream :8000): -1 = disabled
    metrics_port: int = -1
    metrics_host: str = "127.0.0.1"
    # cluster telemetry push cadence (utils/telemetry.py); <= 0 disables
    telemetry_interval: float = 15.0
    # gRPC TLS: PEM file paths; tls_client_ca_file enforces mTLS
    tls_cert_file: str = ""
    tls_key_file: str = ""
    tls_client_ca_file: str = ""
    # client-side root (and optional mTLS client pair) for the manager
    manager_tls_ca_file: str = ""
    manager_tls_server_name: str = ""
    manager_tls_client_cert_file: str = ""
    manager_tls_client_key_file: str = ""


class TrainerServer:
    def __init__(self, config: TrainerServerConfig):
        self.cfg = config
        Path(config.data_dir).mkdir(parents=True, exist_ok=True)
        self.storage = TrainerStorage(config.data_dir)

        self._manager_channel = None
        manager_client = None
        if config.manager_address:
            self._manager_channel = glue.dial(
                config.manager_address,
                **glue.dial_tls_args(
                    config.manager_tls_ca_file,
                    config.manager_tls_server_name,
                    config.manager_tls_client_cert_file,
                    config.manager_tls_client_key_file,
                ),
            )
            from dragonfly2_torch.manager.service import ManagerGrpcClientAdapter

            manager_client = ManagerGrpcClientAdapter(self._manager_channel)

        self.training = Training(
            self.storage,
            manager_client=manager_client,
            config=TrainingConfig(
                mlp=FitConfig(
                    epochs=config.mlp_epochs, batch_size=config.mlp_batch_size
                ),
                gnn=GNNFitConfig(epochs=config.gnn_epochs),
                min_download_records=config.min_download_records,
                min_topology_records=config.min_topology_records,
                gru=config.gru,
                gru_min_sequences=config.gru_min_sequences,
                incremental=config.incremental,
                clear_after_train=not config.incremental,
                streaming=config.streaming,
                streaming_workers=config.streaming_workers,
                auto_mesh=config.auto_mesh,
                profile_dir=config.profile_dir,
                checkpoint_dir=config.checkpoint_dir,
            ),
            device=config.device,
        )
        self.service = TrainerService(
            self.storage, self.training, synchronous=config.synchronous
        )
        self._grpc = None
        self.telemetry_reporter = None
        self._metrics = None
        self.metrics_addr = ""

    def serve(self) -> str:
        # flight recorder: stall/crash dumps + the Diagnose snapshot RPC
        flight.install("trainer")
        # continuous profiler: always-on sampler + phase ledger
        # (/debug/prof, Diagnose profile section, dump windows)
        profiling.install("trainer")
        flight.register_probe(
            "trainer.storage",
            lambda: {"host_ids": self.storage.host_ids()},
        )
        from dragonfly2_torch.rpc.diagnose import DiagnoseService

        self._grpc, port = glue.serve(
            {SERVICE_NAME: self.service, glue.DIAGNOSE_SERVICE: DiagnoseService()},
            self.cfg.listen,
            **glue.serve_tls_args(
                self.cfg.tls_cert_file, self.cfg.tls_key_file, self.cfg.tls_client_ca_file
            ),
        )
        addr = f"{self.cfg.listen.rsplit(':', 1)[0]}:{port}"
        from dragonfly2_torch.utils.metrics import set_build_info

        set_build_info("trainer")
        if self._manager_channel is not None and self.cfg.telemetry_interval > 0:
            # cluster telemetry: ingest throughput + fit freshness to the
            # manager over the channel already dialed for CreateModel
            from dragonfly2_torch.utils.telemetry import TelemetryReporter
            from dragonfly2_torch.version import __version__

            def sections():
                return {
                    "build": {"service": "trainer", "version": __version__},
                    "endpoints": {"rpc": addr, "metrics": self.metrics_addr},
                }

            self.telemetry_reporter = TelemetryReporter(
                glue.ServiceClient(self._manager_channel, glue.TELEMETRY_SERVICE),
                service="trainer",
                instance=addr,
                prefixes=("dragonfly_trainer_",),
                interval=self.cfg.telemetry_interval,
                collect_sections=sections,
            )
            self.telemetry_reporter.start()
        if self.cfg.metrics_port >= 0:
            from dragonfly2_torch.trainer import metrics  # noqa: F401
            from dragonfly2_torch.utils.metrics import MetricsServer, default_registry

            self._metrics = MetricsServer(default_registry, host=self.cfg.metrics_host, port=self.cfg.metrics_port)
            # liveness on the scrape port (/healthz): the gRPC plane up
            self._metrics.register_health("trainer", lambda: self._grpc is not None)
            self.metrics_addr = self._metrics.start()
            logger.info("trainer metrics on %s", self.metrics_addr)
        logger.info("trainer gRPC on %s", addr)
        return addr

    def stop(self) -> None:
        if self.telemetry_reporter is not None:
            self.telemetry_reporter.stop()
        if self._metrics is not None:
            self._metrics.stop()
        if self._grpc is not None:
            self._grpc.stop(grace=2).wait(5)
        if self._manager_channel is not None:
            self._manager_channel.close()
        # the reference clears trainer storage on shutdown
        # (upstream trainer/trainer.go:156-161) unless running incremental
        # rounds
        if not self.cfg.incremental:
            self.storage.clear()


def build(config_path, overrides):
    from dragonfly2_torch.cli.config import load_config

    cfg = load_config(
        TrainerServerConfig, config_path, env_prefix="DF_TRAINER", overrides=overrides
    )
    return TrainerServer(cfg)
