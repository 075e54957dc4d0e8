"""Scheduler server assembly (counterpart of the reference's
``scheduler/server.py``; upstream Dragonfly2's scheduler/scheduler.go):
wires storage → manager client → trainer client → announcer → resource →
networktopology → scheduling/evaluator (+ model refresher) → job worker →
gRPC server, with the Serve/Stop lifecycle in the reference's order.

The topology engine, the scorers the refresher installs and the preheat
forecaster run on ``device`` (``"cuda"`` by default; a machine without a
card raises unless ``"cpu"`` is asked for). With a manager the server
pushes its series to the manager's ``ReportTelemetry`` every
``telemetry_interval`` seconds (``utils/telemetry.py``), and with
``metrics_port >= 0`` it serves ``/metrics``, ``/healthz`` and
``/debug/*`` (``utils/metrics.MetricsServer``). Left out of the port:
fleet membership and swarm replication (``fleet_enabled`` raises
``NotImplementedError``; ROADMAP queue A item 5h).
"""

from __future__ import annotations

import gc
import socket
from dataclasses import dataclass
from pathlib import Path

from dragonfly2_torch.rpc import glue
from dragonfly2_torch.scheduler import resource as res
from dragonfly2_torch.scheduler.announcer import Announcer
from dragonfly2_torch.scheduler.evaluator import BaseEvaluator, MLEvaluator
from dragonfly2_torch.scheduler.networktopology import NetworkTopology
from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
from dragonfly2_torch.scheduler.service import SERVICE_NAME, SchedulerService
from dragonfly2_torch.scheduler.storage import Storage
from dragonfly2_torch.cli.config import check_ported
from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.utils import dflog, flight, profiling
from dragonfly2_torch.utils.gc import GC, GCTask
from dragonfly2_torch.utils import kvstore
from dragonfly2_torch.utils.kvstore import KVStore

logger = dflog.get("scheduler.server")

# CPython's full collection walks every object the collector tracks and
# stops every thread while it does. A scheduler at cluster size holds
# about a million (hosts, peers and their pieces): a full collection then
# takes most of a second on a 2 GHz Xeon core (PERF.md, the server leg),
# and a decision waiting on the scoring service past its 1 s grace drops
# a rung. The server freezes what it holds once set up and then every
# HEAP_FREEZE_INTERVAL_S (after a young collection), so a full
# collection walks only what arrived since. A frozen object still dies
# when its last reference goes (peers, tasks and hosts do, and so does a
# stream's state); one that dies only through a reference cycle is kept.
HEAP_FREEZE_INTERVAL_S = 10.0


def _freeze_heap() -> None:
    gc.collect(1)
    gc.freeze()

@dataclass
class SchedulerServerConfig:
    data_dir: str = "/tmp/dragonfly2-scheduler"
    # where the topology engine, the installed scorers and the preheat
    # forecaster run: "cuda" (the card) or "cpu" when the caller asks
    device: str = "cuda"
    listen: str = "127.0.0.1:0"
    advertise_ip: str = "127.0.0.1"
    hostname: str = ""
    cluster_id: int = 1
    idc: str = ""
    location: str = ""
    # upstream services; empty = run standalone (upstream allows both)
    manager_address: str = ""
    trainer_address: str = ""
    # evaluator algorithm: "default" (linear) or "ml" (the trained model
    # via the manager registry, base fallback; upstream evaluator.go:53)
    algorithm: str = "default"
    model_refresh_interval: float = 60.0
    # batched scoring service (scheduler/serving.py, docs/serving.md):
    # concurrent schedule ops micro-batch their model forwards through
    # one device-resident scorer. Only meaningful with algorithm="ml".
    serving_enabled: bool = True
    serving_batch_window_ms: float = 2.0
    serving_queue_depth: int = 256
    # dataset upload cadence (reference default is 7 DAYS; operators
    # shorten it for fast feedback loops)
    train_interval: float = 7 * 24 * 3600.0
    keepalive_interval: float = 30.0
    job_poll_interval: float = 5.0
    # predictive preheat plane (preheat/):
    # fold download records into per-task demand series, GRU-forecast the
    # next horizon, and seed forecast-hot tasks ahead of the rush
    preheat: bool = False
    preheat_interval: float = 30.0
    preheat_bucket_s: float = 10.0
    preheat_window_buckets: int = 32
    preheat_horizon: int = 3
    preheat_budget: int = 4
    preheat_max_tasks: int = 1024
    # cluster telemetry push cadence (utils/telemetry.py → the manager's
    # ReportTelemetry; docs/telemetry.md); <= 0 disables the reporter
    telemetry_interval: float = 15.0
    # record sink rotation
    storage_max_size: int = 100 * 1024 * 1024
    storage_buffer_size: int = 64
    # scheduling knobs (reference scheduling config)
    retry_limit: int = 5
    retry_back_to_source_limit: int = 5
    retry_interval: float = 0.05
    candidate_parent_limit: int = 4
    # a cold task's first peer with no parent asks a seed peer of the
    # cluster to fetch it, and its peers wait for the seed instead of each
    # going back to source (upstream seedPeer.enable; the reference's
    # server leaves it out, so False keeps its behavior)
    seed_peer_enabled: bool = False
    # probe-graph CSV snapshot cadence (reference CollectInterval, 2h)
    topology_snapshot_interval: float = 2 * 3600.0
    # device-resident topology engine (topology/): the probe graph as a
    # sparse adjacency on the card with landmark RTT inference. Any
    # value but "off" builds it on ``device`` (the reference's
    # "auto"/"jax"/"numpy" pick its backend); "off" disables the engine
    # (KV-walk snapshots, no rtt feature).
    topology_backend: str = "auto"
    topology_landmarks: int = 8
    topology_flush_threshold: int = 256
    topology_half_life_s: float = 30 * 60.0
    topology_max_age_s: float = 4 * 3600.0
    # shared KV backend for the Redis role (probe graph, probed counts):
    # "host:port" of utils.kvserver.KVServer (the manager embeds one) or
    # an actual Redis; empty = process-local store (single-scheduler).
    # Matches upstream network_topology.go:88-89 taking a redis client.
    kv_address: str = ""
    # AUTH secret for the shared KV (KVServer requirepass / Redis AUTH);
    # empty = unauthenticated (loopback/dev deployments)
    kv_secret: str = ""
    # scheduler-fleet membership (not ported: True raises):
    # register this scheduler under a heartbeat-renewed lease in the
    # shared KV so daemons/the manager follow LIVE membership and each
    # member refuses announces for shards it doesn't own (WRONG_SHARD).
    # Needs a shared kv_address to mean anything across processes.
    fleet_enabled: bool = False
    fleet_lease_ttl: float = 3.0
    fleet_renew_interval: float = 1.0
    fleet_poll_interval: float = 1.0
    fleet_grace_s: float = 10.0
    # swarm replication plane (scheduler/swarm_replication.py,
    # docs/fleet.md failover section): journal per-task swarm snapshots
    # through the shared KV so a successor shard ADOPTS a dead member's
    # swarms — peers resume with state intact — instead of rebuilding
    # them from re-registration. Starts with the fleet (fleet_enabled);
    # replication without sharding has no successor to hand to.
    swarm_replication: bool = True
    swarm_replication_interval: float = 0.25
    swarm_replication_max_tasks: int = 64
    swarm_replication_backlog_cap: int = 1024
    swarm_replication_ttl_s: float = 600.0
    # address other fleet members/daemons reach this scheduler at;
    # 0 = advertise_ip:<bound port>
    advertise_port: int = 0
    # Prometheus /metrics endpoint (upstream :8000): -1 = disabled
    metrics_port: int = -1
    # df_plugin_*.py modules loaded at startup (upstream internal/dfplugin)
    plugin_dir: str = ""
    # gRPC TLS: PEM file paths; tls_client_ca_file enforces mTLS
    tls_cert_file: str = ""
    tls_key_file: str = ""
    tls_client_ca_file: str = ""
    # client-side roots (and optional mTLS client pair) for upstream dials
    manager_tls_ca_file: str = ""
    manager_tls_server_name: str = ""
    manager_tls_client_cert_file: str = ""
    manager_tls_client_key_file: str = ""
    trainer_tls_ca_file: str = ""
    trainer_tls_server_name: str = ""
    trainer_tls_client_cert_file: str = ""
    trainer_tls_client_key_file: str = ""
    metrics_host: str = "127.0.0.1"


class SchedulerServer:
    def __init__(self, config: SchedulerServerConfig):
        self.cfg = config
        check_ported(config)
        # resolved first: a scheduler asked for the card on a machine
        # without one raises here, before any thread or socket exists
        self.device = resolve_device(config.device)
        if not config.hostname:
            config.hostname = socket.gethostname()
        Path(config.data_dir).mkdir(parents=True, exist_ok=True)

        if config.plugin_dir:
            from dragonfly2_torch.utils.dfplugin import load_plugins

            load_plugins(config.plugin_dir)
        self.gc = GC()
        self.resource = res.Resource(gc=self.gc)
        self.storage = Storage(
            Path(config.data_dir) / "records",
            max_size=config.storage_max_size,
            buffer_size=config.storage_buffer_size,
        )
        # kv_address set → RESP client to the shared store (manager-embedded
        # KVServer or real Redis): N schedulers then see one probe graph,
        # like the reference's redis.UniversalClient wiring. Unset → an
        # isolated in-process store (NOT the process-wide singleton: two
        # SchedulerServers in one test process must not silently share
        # topology state through a global).
        self.kvstore = (
            kvstore.RemoteKVStore(config.kv_address, secret=config.kv_secret)
            if config.kv_address
            else KVStore()
        )
        self.topology_engine = None
        if config.topology_backend != "off":
            from dragonfly2_torch.topology import TopologyConfig, TopologyEngine

            self.topology_engine = TopologyEngine(
                TopologyConfig(
                    num_landmarks=config.topology_landmarks,
                    flush_threshold=config.topology_flush_threshold,
                    half_life_s=config.topology_half_life_s,
                    max_age_s=config.topology_max_age_s,
                ),
                device=self.device,
            )
        if self.topology_engine is not None:
            # block-encode-time rtt_affinity join: training data carries
            # the same live feature distribution the evaluator feeds
            self.storage.rtt_lookup = self.topology_engine.rtt_affinity_batch
        self.networktopology = NetworkTopology(
            self.kvstore,
            self.resource.host_manager,
            self.storage,
            engine=self.topology_engine,
        )
        self.gc.add(
            GCTask(
                "topology-snapshot",
                config.topology_snapshot_interval,
                config.topology_snapshot_interval,
                self.networktopology.snapshot,
            )
        )
        if self.topology_engine is not None:
            # periodic flush: drains sub-threshold delta batches and
            # advances staleness decay even on a quiet probe plane
            self.gc.add(
                GCTask("topology-flush", 30.0, 30.0, self.topology_engine.flush)
            )
        from dragonfly2_torch.scheduler import metrics as _M

        _M.set_version_info()
        self.gc.add(
            GCTask(
                "metrics-refresh",
                15.0,
                15.0,
                lambda: _M.refresh_resource_gauges(self.resource),
            )
        )

        # upstream clients
        self._manager_channel = None
        self._trainer_channel = None
        self.manager_client = None
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

            self.manager_client = ManagerGrpcClientAdapter(self._manager_channel)
        if config.trainer_address:
            self._trainer_channel = glue.dial(
                config.trainer_address,
                **glue.dial_tls_args(
                    config.trainer_tls_ca_file,
                    config.trainer_tls_server_name,
                    config.trainer_tls_client_cert_file,
                    config.trainer_tls_client_key_file,
                ),
            )

        # evaluator (+ live model refresh when the manager serves models)
        self.model_refresher = None
        self.scoring_service = None
        if config.algorithm == "ml":
            if config.serving_enabled:
                from dragonfly2_torch.scheduler.serving import (
                    ScoringService,
                    ServingConfig,
                )

                self.scoring_service = ScoringService(
                    ServingConfig(
                        window_s=config.serving_batch_window_ms / 1e3,
                        queue_depth=config.serving_queue_depth,
                    )
                )
            evaluator = MLEvaluator(
                topology=self.topology_engine, serving=self.scoring_service
            )
            if self._manager_channel is not None:
                from dragonfly2_torch.manager.service import (
                    SERVICE_NAME as MANAGER_SERVICE,
                )
                from dragonfly2_torch.scheduler.model_refresher import ModelRefresher

                self.model_refresher = ModelRefresher(
                    glue.ServiceClient(self._manager_channel, MANAGER_SERVICE),
                    evaluator,
                    scheduler_cluster_id=config.cluster_id,
                    interval=config.model_refresh_interval,
                    serving=self.scoring_service,
                    networktopology=self.networktopology,
                    device=self.device,
                )
        else:
            from dragonfly2_torch.scheduler.evaluator import new_evaluator

            evaluator = new_evaluator(config.algorithm)
        self.evaluator = evaluator

        # one seed-peer client for scheduling, jobs and preheat, so a seed
        # download any of them started holds the others' peers alike
        from dragonfly2_torch.scheduler.resource.seed_peer import SeedPeerClient

        self.seed_client = SeedPeerClient(self.resource.host_manager)
        self.scheduling = Scheduling(
            evaluator,
            SchedulingConfig(
                retry_limit=config.retry_limit,
                retry_back_to_source_limit=config.retry_back_to_source_limit,
                retry_interval=config.retry_interval,
                candidate_parent_limit=config.candidate_parent_limit,
            ),
            seed_client=self.seed_client if config.seed_peer_enabled else None,
        )
        self.service = SchedulerService(
            self.resource,
            self.scheduling,
            storage=self.storage,
            networktopology=self.networktopology,
        )
        # v1 wire shape bound alongside v2, sharing domain state
        # (upstream scheduler/rpcserver/rpcserver.go:31-44 binds both
        # generations into one grpc.Server)
        from dragonfly2_torch.scheduler.service_v1 import SchedulerServiceV1

        self.service_v1 = SchedulerServiceV1(
            self.resource,
            self.scheduling,
            storage=self.storage,
            networktopology=self.networktopology,
        )

        self.announcer = Announcer(
            self.storage,
            ip=config.advertise_ip,
            hostname=config.hostname,
            trainer_channel=self._trainer_channel,
            manager_client=self.manager_client,
            cluster_id=str(config.cluster_id),
            train_interval=config.train_interval,
            keepalive_interval=config.keepalive_interval,
        )

        self.job_worker = None
        if self._manager_channel is not None:
            from dragonfly2_torch.manager.service import SERVICE_NAME as MANAGER_SERVICE
            from dragonfly2_torch.scheduler.job import JobWorker

            self.job_worker = JobWorker(
                glue.ServiceClient(self._manager_channel, MANAGER_SERVICE),
                self.resource,
                seed_client=self.seed_client,
                networktopology=self.networktopology,
                hostname=config.hostname,
                ip=config.advertise_ip,
                cluster_id=config.cluster_id,
                poll_interval=config.job_poll_interval,
                device=self.device,
            )

        # predictive preheat plane: demand window fed off the record sink,
        # GRU forecaster, and the planner closing the forecast→place loop
        self.preheat_planner = None
        if config.preheat:
            from dragonfly2_torch.preheat.demand import DemandWindow
            from dragonfly2_torch.preheat.forecast import DemandForecaster
            from dragonfly2_torch.preheat.planner import PreheatPlanner

            demand = DemandWindow(
                bucket_s=config.preheat_bucket_s,
                window_buckets=config.preheat_window_buckets,
                max_tasks=config.preheat_max_tasks,
            )
            # fold with the live task resolved so the series captures the
            # demanded task's full URLMeta context (tag/application/
            # filter/range/digest) — the preheat job replays it to seed
            # the exact swarm demanded clients join
            def _observe_download(rec, _demand=demand, _resource=self.resource):
                _demand.observe_record(
                    rec, task=_resource.task_manager.load(rec.task.id)
                )

            self.storage.on_download = _observe_download
            forecaster = DemandForecaster(
                window_buckets=config.preheat_window_buckets,
                horizon=config.preheat_horizon,
                device=self.device,
            )
            if self.job_worker is not None:
                seed_client = self.job_worker.seed_client
                job_worker = self.job_worker
                manager_client = self.job_worker.manager
            else:
                # standalone scheduler: an unstarted worker executes
                # planner jobs inline (execute_now), no manager queue
                from dragonfly2_torch.scheduler.job import JobWorker

                seed_client = self.seed_client
                job_worker = JobWorker(
                    None,
                    self.resource,
                    seed_client=seed_client,
                    networktopology=self.networktopology,
                    hostname=config.hostname,
                    ip=config.advertise_ip,
                    cluster_id=config.cluster_id,
                    device=self.device,
                )
                manager_client = None
            self.preheat_planner = PreheatPlanner(
                demand,
                forecaster,
                resource=self.resource,
                job_worker=job_worker,
                manager_client=manager_client,
                topology=self.networktopology,
                seed_client=seed_client,
                cluster_id=config.cluster_id,
                interval_s=config.preheat_interval,
                budget_per_sweep=config.preheat_budget,
            )

        self._grpc = None
        self.port: int | None = None
        self.telemetry_reporter = None
        self._metrics = None
        self.metrics_addr = ""

    # ------------------------------------------------------------------
    def serve(self) -> str:
        cfg = self.cfg
        from dragonfly2_torch.scheduler.service_v1 import SCHEDULER_V1_SERVICE

        services = {SERVICE_NAME: self.service, SCHEDULER_V1_SERVICE: self.service_v1}
        if self.topology_engine is not None:
            from dragonfly2_torch.rpc.glue import TOPOLOGY_SERVICE
            from dragonfly2_torch.scheduler.topology_service import TopologyService

            services[TOPOLOGY_SERVICE] = TopologyService(self.topology_engine)
        # flight recorder: crash dumps on SIGTERM/fatal, live snapshots
        # via the Diagnose RPC on the same gRPC plane
        flight.install("scheduler")
        # continuous profiler: always-on sampler + phase ledger
        profiling.install("scheduler")
        if self.topology_engine is not None:
            flight.register_probe("scheduler.topology", self.topology_engine.stats)
        flight.register_probe(
            "scheduler.resource",
            lambda: {
                "peers": len(self.resource.peer_manager.all()),
                "tasks": len(self.resource.task_manager.all()),
                "hosts": len(self.resource.host_manager.all()),
            },
        )
        # swarm shape at crash time: dfdoctor timelines carry the
        # observatory rollup next to the resource counts
        from dragonfly2_torch.scheduler import swarm as _swarm

        flight.register_probe("scheduler.swarm", _swarm.summary)
        from dragonfly2_torch.rpc.diagnose import DiagnoseService
        from dragonfly2_torch.rpc.glue import DIAGNOSE_SERVICE

        services[DIAGNOSE_SERVICE] = DiagnoseService()
        self._grpc, self.port = glue.serve(
            services,
            cfg.listen,
            **glue.serve_tls_args(
                cfg.tls_cert_file, cfg.tls_key_file, cfg.tls_client_ca_file
            ),
        )
        addr = f"{cfg.listen.rsplit(':', 1)[0]}:{self.port}"
        if self.topology_engine is not None:
            try:
                # restart recovery: adopt the durable KV graph into the
                # device adjacency before serving queries against it
                adopted = self.networktopology.hydrate_engine()
                if adopted:
                    logger.info("topology engine hydrated %d edges from kv", adopted)
            except Exception:
                logger.warning("topology engine kv hydration failed", exc_info=True)
        if self.manager_client is not None:
            self._register_with_manager()
        if self._manager_channel is not None and cfg.telemetry_interval > 0:
            # cluster telemetry: periodic registry snapshot + live swarm
            # table to the manager, riding the channel just dialed
            from dragonfly2_torch.utils.telemetry import TelemetryReporter

            self.telemetry_reporter = TelemetryReporter(
                glue.ServiceClient(self._manager_channel, glue.TELEMETRY_SERVICE),
                service="scheduler",
                instance=f"{cfg.advertise_ip}:{cfg.advertise_port or self.port}",
                shard=f"{cfg.advertise_ip}:{cfg.advertise_port or self.port}",
                prefixes=(
                    "dragonfly_scheduler_",
                    "dragonfly_fleet_",
                    "dragonfly_swarm_",
                ),
                interval=cfg.telemetry_interval,
                collect_sections=self._telemetry_sections,
            )
            self.telemetry_reporter.start()
        self.announcer.serve()
        if self.scoring_service is not None:
            # the serving thread must be consuming BEFORE the refresher's
            # first poll can install a model into it
            self.scoring_service.start()
            flight.register_probe(
                "scheduler.serving", self.scoring_service.snapshot
            )
        if self.model_refresher is not None:
            self.model_refresher.start()
        if self.job_worker is not None:
            self.job_worker.start()
        if self.preheat_planner is not None:
            # after the job worker: the planner's first sweep may submit
            # through it the moment demand warrants
            self.preheat_planner.start()
            flight.register_probe("preheat", self.preheat_planner.stats)
        self.gc.add(GCTask("heap-freeze", HEAP_FREEZE_INTERVAL_S, HEAP_FREEZE_INTERVAL_S, _freeze_heap))
        self.gc.start()
        from dragonfly2_torch.utils.metrics import set_build_info

        set_build_info("scheduler")
        if cfg.metrics_port >= 0:
            from dragonfly2_torch.scheduler import metrics  # noqa: F401
            from dragonfly2_torch.utils.metrics import MetricsServer, default_registry

            self._metrics = MetricsServer(default_registry, host=cfg.metrics_host, port=cfg.metrics_port)
            # liveness on the scrape port (/healthz): the gRPC plane up
            self._metrics.register_health("scheduler", lambda: self._grpc is not None)
            self.metrics_addr = self._metrics.start()
            logger.info("scheduler metrics on %s", self.metrics_addr)
        # the set-up heap (modules, models, the engine hydrated from the
        # KV) leaves the collector's walk at once, after one full
        # collection
        gc.collect()
        gc.freeze()
        logger.info("scheduler gRPC on %s", addr)
        return addr

    def _telemetry_sections(self) -> dict:
        """The scheduler's structured telemetry sections: the live
        per-task swarm table and the shard-wide observatory rollup
        (both from scheduler/swarm — the same ledger /debug/swarm and
        the flight probe read) plus identity/endpoints. Gauges are
        refreshed first so the pushed registry snapshot is as current
        as the table."""
        from dragonfly2_torch.scheduler import metrics as _M
        from dragonfly2_torch.scheduler import swarm as _swarm
        from dragonfly2_torch.version import __version__

        _M.refresh_resource_gauges(self.resource)
        sections = {
            "swarms": _swarm.telemetry_section(),
            "build": {"service": "scheduler", "version": __version__},
            "endpoints": {
                "rpc": f"{self.cfg.advertise_ip}:{self.cfg.advertise_port or self.port}",
                "metrics": self.metrics_addr,
            },
        }
        rollup = _swarm.telemetry_rollup()
        if rollup:
            sections["swarm_rollup"] = rollup
        return sections

    def _register_with_manager(self) -> None:
        """Register with the manager before serving traffic (upstream
        announcer.go:85-124 UpdateScheduler at startup)."""
        from dragonfly2_torch.manager.service import SERVICE_NAME as MANAGER_SERVICE
        from dragonfly2_torch.rpc import protos

        manager_pb2 = protos.load("manager_pb2")

        client = glue.ServiceClient(self._manager_channel, MANAGER_SERVICE)
        client.UpdateScheduler(
            manager_pb2.UpdateSchedulerRequest(
                hostname=self.cfg.hostname,
                ip=self.cfg.advertise_ip,
                # the DIALABLE port — must match the fleet lease address
                # (advertise_ip:advertise_port) or the manager's
                # lease-scoped dynconfig can never match this row
                port=int(self.cfg.advertise_port or self.port or 0),
                idc=self.cfg.idc,
                location=self.cfg.location,
                scheduler_cluster_id=self.cfg.cluster_id,
            )
        )

    def stop(self) -> None:
        # upstream Stop order scheduler.go:368: dynconfig → resource →
        # storage → gc → announcer → clients → graceful grpc stop
        if self._metrics is not None:
            self._metrics.stop()
        if self.telemetry_reporter is not None:
            self.telemetry_reporter.stop()
        if self.preheat_planner is not None:
            # before the job worker (reverse of start): no sweep may
            # submit into a worker already torn down
            self.preheat_planner.stop()
        if self.job_worker is not None:
            self.job_worker.stop()
        if self.model_refresher is not None:
            self.model_refresher.stop()
        if self.scoring_service is not None:
            # after the refresher (no further installs) and before the
            # grpc drain completes: stop() releases every queued waiter,
            # so an in-flight schedule op falls back a rung, never hangs
            self.scoring_service.stop()
        self.gc.stop()
        self.announcer.stop()
        if self._grpc is not None:
            self._grpc.stop(grace=2).wait(5)
        self.storage.flush()
        self.kvstore.close()  # releases the RESP socket when remote
        for ch in (self._manager_channel, self._trainer_channel):
            if ch is not None:
                ch.close()
        gc.unfreeze()


def build(config_path, overrides):
    from dragonfly2_torch.cli.config import load_config

    cfg = load_config(
        SchedulerServerConfig,
        config_path,
        env_prefix="DF_SCHEDULER",
        overrides=overrides,
    )
    return SchedulerServer(cfg)
