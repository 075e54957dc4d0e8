"""Manager server assembly (counterpart of the reference's
``manager/server.py``; upstream manager/manager.go:87-330): the sqlite
registry behind its read-through cache, the object-storage-backed model
registry, the gRPC service with the telemetry plane and the Diagnose RPC
on one port, the REST API and web console when ``rest_port >= 0``,
``/metrics`` with the SLO section on ``/healthz``, the embedded RESP KV
server when ``kv_port >= 0`` (``utils/kvserver.KVServer``: the shared
store of the scheduler fleet, whose leases scope ``ListSchedulers``),
and the Serve/Stop lifecycle.

The config keeps the reference's every key and default. The manager
holds no tensors: it has no device argument, and neither it nor its REST
front imports torch."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from dragonfly2_torch.manager.database import Database
from dragonfly2_torch.manager.models_registry import ModelRegistry
from dragonfly2_torch.manager.objectstorage import new_object_storage
from dragonfly2_torch.manager.service import ManagerService
from dragonfly2_torch.rpc import glue
from dragonfly2_torch.utils import dflog, flight, profiling

logger = dflog.get("manager.server")


@dataclass
class ManagerServerConfig:
    data_dir: str = "/tmp/dragonfly2-manager"
    listen: str = "127.0.0.1:0"
    # REST API (manager/router): -1 = disabled, 0 = ephemeral port
    rest_port: int = -1
    rest_host: str = "127.0.0.1"
    # bearer tokens accepted by the REST API, role per token
    # ({token: "admin"|"guest"}); empty = unauthenticated (dev mode)
    rest_tokens: dict = field(default_factory=dict)
    # Prometheus /metrics endpoint (upstream :8000): -1 = disabled
    metrics_port: int = -1
    metrics_host: str = "127.0.0.1"
    # gRPC TLS: PEM file paths; tls_client_ca_file enforces mTLS
    tls_cert_file: str = ""
    tls_key_file: str = ""
    tls_client_ca_file: str = ""
    # read-through DB cache TTL in seconds (upstream manager/cache Redis
    # TTLs); 0 disables caching
    db_cache_ttl: float = 30.0
    # dynamic certificate issuance (IssueCertificate RPC): CA persisted
    # under data_dir/ca; False = static cert files only. The token gates
    # who may obtain signed identities ('' = open — dev only)
    issue_certs: bool = True
    issue_certs_token: str = ""
    # embedded RESP KV server (the Redis role): schedulers point their
    # kv_address here to share one probe-graph/counter store across
    # processes (upstream deploys Redis alongside the manager for the
    # same purpose). -1 = disabled, 0 = ephemeral port. The bind host
    # and the ADVERTISED host are distinct (same pattern as the gRPC
    # listen/advertise split): 0.0.0.0 binds everywhere but is not a
    # dialable address, so kv_advertise_ip is what lands in kv_addr /
    # the runner's KV line. Loopback bind by default — exposing the KV
    # on the network is an explicit opt-in, and should come with
    # kv_secret so every connection must AUTH (requirepass semantics;
    # schedulers pass the same value as their kv_secret).
    kv_port: int = -1
    kv_host: str = "127.0.0.1"
    kv_advertise_ip: str = "127.0.0.1"
    kv_secret: str = ""
    # object storage for model weights: fs (default, under data_dir) or
    # s3 (any S3-compatible endpoint; upstream pkg/objectstorage)
    object_storage_driver: str = "fs"
    object_storage_endpoint: str = ""
    object_storage_access_key: str = ""
    object_storage_secret_key: str = ""
    object_storage_region: str = "us-east-1"


class ManagerServer:
    def __init__(self, config: ManagerServerConfig):
        self.cfg = config
        Path(config.data_dir).mkdir(parents=True, exist_ok=True)
        self.db = Database(str(Path(config.data_dir) / "manager.db"))
        if config.db_cache_ttl > 0:
            from dragonfly2_torch.manager.cache import CachedDatabase

            self.db = CachedDatabase(self.db, ttl=config.db_cache_ttl)
        self.object_storage = new_object_storage(
            driver=config.object_storage_driver,
            root=str(Path(config.data_dir) / "objects"),
            endpoint=config.object_storage_endpoint,
            access_key=config.object_storage_access_key,
            secret_key=config.object_storage_secret_key,
            region=config.object_storage_region,
        )
        self.models = ModelRegistry(self.db, self.object_storage)
        self.service = ManagerService(
            self.db,
            self.models,
            ca=self._load_ca(config),
            ca_token=config.issue_certs_token,
        )
        # cluster telemetry plane (manager/telemetry.py): in-memory by
        # design — reporters re-register and re-baseline after a manager
        # restart, so the aggregates and the dedup state die together
        from dragonfly2_torch.manager.telemetry import TelemetryPlane

        self.telemetry = TelemetryPlane()
        self.service.telemetry = self.telemetry
        self._grpc = None
        self._rest = None
        self.rest_addr: str | None = None
        self._metrics = None
        self._kv = None
        self.kv_addr: str | None = None

    @staticmethod
    def _load_ca(config):
        """The cluster CA behind IssueCertificate, persisted under
        data_dir/ca so restarts keep issuing from the same root
        (upstream pkg/issuer + securityv1). ``issue_certs=False``
        disables dynamic issuance entirely."""
        if not config.issue_certs:
            return None
        from dragonfly2_torch.utils.issuer import CertificateAuthority

        ca_dir = Path(config.data_dir) / "ca"
        cert_p, key_p = ca_dir / "ca.crt", ca_dir / "ca.key"
        if cert_p.exists() and key_p.exists():
            return CertificateAuthority.load(cert_p.read_bytes(), key_p.read_bytes())
        ca = CertificateAuthority(common_name="dragonfly2-tpu manager CA")
        ca_dir.mkdir(parents=True, exist_ok=True)
        cert_p.write_bytes(ca.cert_pem)
        # the key file is born 0600 — a chmod-after-write leaves a window
        # where any local user can open (and keep) a readable fd to the
        # cluster root key
        import os as _os

        fd = _os.open(str(key_p), _os.O_WRONLY | _os.O_CREAT | _os.O_EXCL, 0o600)
        with _os.fdopen(fd, "wb") as f:
            f.write(ca.key_pem)
        return ca

    def serve(self) -> str:
        from dragonfly2_torch.manager.service import SERVICE_NAME

        # flight recorder: crash dumps + the Diagnose snapshot RPC
        flight.install("manager")
        # continuous profiler: always-on sampler + phase ledger
        profiling.install("manager")
        from dragonfly2_torch.manager.telemetry import TelemetryService
        from dragonfly2_torch.rpc.diagnose import DiagnoseService
        from dragonfly2_torch.utils.metrics import set_build_info

        set_build_info("manager")
        self._grpc, port = glue.serve(
            {
                SERVICE_NAME: self.service,
                glue.DIAGNOSE_SERVICE: DiagnoseService(),
                # telemetry rides the same channel every service already
                # dials for KeepAlive/dynconfig
                glue.TELEMETRY_SERVICE: TelemetryService(self.telemetry),
            },
            self.cfg.listen,
            **glue.serve_tls_args(
                self.cfg.tls_cert_file, self.cfg.tls_key_file, self.cfg.tls_client_ca_file
            ),
        )
        host = self.cfg.listen.rsplit(":", 1)[0]
        addr = f"{host}:{port}"
        if self.cfg.rest_port >= 0:
            from dragonfly2_torch.manager.rest import RestServer

            self._rest = RestServer(
                self.service,
                host=self.cfg.rest_host,
                port=self.cfg.rest_port,
                tokens=self.cfg.rest_tokens,
            )
            self.rest_addr = self._rest.start()
            logger.info("manager REST on %s", self.rest_addr)
        if self.cfg.metrics_port >= 0:
            from dragonfly2_torch.manager import metrics  # noqa: F401 — register series
            from dragonfly2_torch.utils.metrics import MetricsServer, default_registry

            self._metrics = MetricsServer(default_registry, host=self.cfg.metrics_host, port=self.cfg.metrics_port)
            # liveness on the scrape port (/healthz): the gRPC plane up
            self._metrics.register_health("manager", lambda: self._grpc is not None)
            # SLO state rides the liveness body next to the resilience
            # map — a burning SLO is degraded, never a 503
            self._metrics.register_status_section(
                "slo", self.telemetry.health_section
            )
            self.metrics_addr = self._metrics.start()
            logger.info("manager metrics on %s", self.metrics_addr)
        if self.cfg.kv_port >= 0:
            from dragonfly2_torch.utils.kvserver import KVServer

            self._kv = KVServer(
                host=self.cfg.kv_host, port=self.cfg.kv_port, secret=self.cfg.kv_secret
            )
            kv_port = self._kv.serve()
            advertise = (
                self.cfg.kv_advertise_ip
                if self.cfg.kv_host in ("0.0.0.0", "::")
                else self.cfg.kv_host
            )
            self.kv_addr = f"{advertise}:{kv_port}"
            # scheduler-fleet view: the embedded KV is where fleet
            # leases live, so the dynconfig scheduler list can scope to
            # live members (ManagerService._fleet_members)
            self.service.fleet_kv = self._kv.store
            logger.info(
                "manager kv (RESP) bound %s:%d, advertising %s",
                self.cfg.kv_host, kv_port, self.kv_addr,
            )
        logger.info("manager gRPC on %s", addr)
        return addr

    def stop(self) -> None:
        if self._kv is not None:
            self._kv.stop()
        if self._metrics is not None:
            self._metrics.stop()
        if self._rest is not None:
            self._rest.stop()
        if self._grpc is not None:
            self._grpc.stop(grace=2).wait(5)
        self.db.close()


def build(config_path, overrides):
    from dragonfly2_torch.cli.config import load_config

    cfg = load_config(
        ManagerServerConfig, config_path, env_prefix="DF_MANAGER", overrides=overrides
    )
    return ManagerServer(cfg)
