"""Peer daemon assembly: wires storage, piece pipeline, upload server,
gRPC surface, announcer, prober, and GC into one process (counterpart of
the reference's ``client/daemon.py``).

Role parity: upstream client/daemon/daemon.go:86-899 (assembly),
client/daemon/announcer/announcer.go:45-337 (host announce),
client/daemon/networktopology/network_topology.go:39-203 (prober),
client/daemon/gc/gc.go (storage GC runner).

The config keeps the reference's every key, so one YAML file starts
either daemon. With ``manager_address`` the daemon takes its schedulers
from the manager (``utils/dynconfig.DaemonDynconfig``, searcher-scoped,
with a disk cache under ``data_dir``), follows the list as it changes,
pushes its telemetry there, and a seed peer (``host_type="super"``)
registers and keeps itself alive with ``UpdateSeedPeer``. With
``proxy_port >= 0`` the daemon serves the registry proxy
(``client/proxy.py`` over ``client/transport.py``), as the reference
does. Two options enable planes this package does not port yet, and
``Daemon.start`` raises ``NotImplementedError`` naming the ROADMAP item
when one is set (:data:`NOT_PORTED`): the object storage gateway (A-D2
(b)) and fleet membership over the shared KV (5h). The cloud source
clients (A-D2 (a)) raise where ``client/source.py`` is asked for one.
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from dragonfly2_torch.rpc import glue, protos
from dragonfly2_torch.client import hostinfo
from dragonfly2_torch.client.conductor import ConductorOptions
from dragonfly2_torch.client.peertask import TaskManager
from dragonfly2_torch.client.piece_manager import PieceManager
from dragonfly2_torch.client.rpcserver import SERVICE_NAME as DFDAEMON_SERVICE, DfdaemonService
from dragonfly2_torch.client.storage import StorageManager
from dragonfly2_torch.client.uploader import UploadServer
from dragonfly2_torch.manager.service import SERVICE_NAME as MANAGER_SERVICE
from dragonfly2_torch.utils import dflog
from dragonfly2_torch.utils.gc import GC, GCTask
from dragonfly2_torch.utils.idgen import host_id_v2

common_pb2 = protos.load("common_pb2")
manager_pb2 = protos.load("manager_pb2")
scheduler_pb2 = protos.load("scheduler_pb2")

logger = dflog.get("client.daemon")

# (option, the value test that enables it, what it is, the ROADMAP item)
NOT_PORTED = (
    ("object_storage_port", lambda v: v >= 0,
     "the object storage gateway (objectstorage.py, dfstore.py)", "queue A item A-D2 (b)"),
    ("kv_address", bool, "scheduler-fleet membership (scheduler/fleet.py)",
     "queue A item 5h"),
)


@dataclass
class DaemonConfig:
    data_dir: str
    scheduler_address: str
    hostname: str = field(default_factory=socket.gethostname)
    ip: str = "127.0.0.1"
    listen: str = "127.0.0.1:0"  # daemon gRPC
    # also serve the dfdaemon gRPC on this unix socket (local CLI path,
    # upstream pkg/rpc/mux.go); empty = TCP only
    unix_socket: str = ""
    # manager to fetch the scheduler list from (dynconfig-fed, searcher-
    # scoped); empty = static scheduler_address only
    manager_address: str = ""
    dynconfig_interval: float = 300.0
    # shared KV for scheduler-fleet membership (scheduler/fleet.py,
    # docs/fleet.md): when set, the daemon follows the fleet's leased
    # member set directly — the ring reconciles within one poll of a
    # join/leave/death instead of waiting out a dynconfig interval
    kv_address: str = ""
    kv_secret: str = ""
    fleet_poll_interval: float = 1.0
    # client-side roots (and optional mTLS pair) for the manager dial —
    # same shape as the scheduler/trainer manager clients
    manager_tls_ca_file: str = ""
    manager_tls_server_name: str = ""
    manager_tls_client_cert_file: str = ""
    manager_tls_client_key_file: str = ""
    upload_host: str = "127.0.0.1"
    upload_port: int = 0
    host_type: str = "normal"  # "normal" | "super" (seed peer)
    location: str = ""
    idc: str = ""
    storage_max_bytes: int = 0
    gc_interval: float = 60.0
    announce_interval: float = 30.0
    probe_interval: float = 0.0  # 0 = prober disabled
    piece_workers: int = 4
    piece_length: int = 0  # 0 = derive from content length
    schedule_timeout: float = 10.0
    concurrent_upload_limit: int = 50
    scheduler_cluster_id: int = 1
    # HTTP proxy (registry acceleration): -1 = disabled, 0 = ephemeral
    # port; rules are transport.ProxyRule instances or kwargs dicts
    # ({"regex": ..., "direct": ..., "use_https": ..., "redirect": ...})
    proxy_port: int = -1
    proxy_host: str = "127.0.0.1"  # bind address (0.0.0.0 in containers)
    proxy_rules: list = field(default_factory=list)
    registry_mirror: str = ""
    # HTTPS interception: spoof per-host certs signed by a local CA
    # persisted under data_dir/ca (clients trust ca.crt once); hosts
    # matching proxy_mitm_hosts regexes are intercepted (empty = all)
    proxy_mitm: bool = False
    proxy_mitm_hosts: list = field(default_factory=list)
    object_storage_host: str = "127.0.0.1"  # bind address (0.0.0.0 in containers)
    # object-storage gateway: -1 = disabled, 0 = ephemeral port; the
    # backend dir is the bucket store (shared across daemons — NFS/S3
    # mount in production, a shared tmp dir in tests)
    object_storage_port: int = -1
    object_storage_dir: str = ""
    # host stat collection (upstream announcer.go:158-303). Overrides
    # replace sampled values — the A/B harness and tests use them to model
    # synthetic hosts; keys are dotted stat paths ("cpu.percent": 90.0)
    collect_host_stats: bool = True
    host_stats_override: dict = field(default_factory=dict)
    # synthetic per-piece upload latency (A/B harness models slow hosts)
    upload_delay_s: float = 0.0
    # extra serving latency on piece 0 only (benign cold-piece pattern:
    # TCP slow start / cold cache — the GRU bad-node A/B scenario)
    upload_cold_piece_delay_s: float = 0.0
    # synthetic receive-side per-piece latency, inside the measured cost
    # window (fault injection: a loaded host's own downloads slow down)
    download_delay_s: float = 0.0
    # global upload bandwidth budget in bytes/s shared by all child peers
    # (upstream upload totalRateLimit); 0 = unlimited
    upload_rate_limit: float = 0.0
    # zero-copy data plane (docs/data-plane.md): serve piece bodies via
    # os.sendfile from the piece store (False = buffered fallback, same
    # event loop — the bench's comparison arm)
    upload_sendfile: bool = True
    # content-addressed cross-task piece dedup in the store (same
    # digest → one physical copy, refcounted); DF_PIECE_DEDUP=0 is the
    # process-wide kill switch
    piece_dedup: bool = True
    # bound on concurrent P2P stream tasks through the proxy/gateway
    # transport; past it requests shed to direct fetches. 0 = unbounded
    p2p_max_inflight: int = 512
    # Prometheus /metrics endpoint: -1 = disabled
    metrics_port: int = -1
    metrics_host: str = "127.0.0.1"
    # cluster telemetry push cadence over the manager channel
    # (utils/telemetry.py, docs/telemetry.md); <= 0 disables
    telemetry_interval: float = 15.0
    # global download budget in bytes/s shared across tasks (cross-task
    # sampling traffic shaper, upstream traffic_shaper.go); 0 = off
    total_download_rate: float = 0.0
    # client-side root (and optional mTLS client pair) for schedulers
    scheduler_tls_ca_file: str = ""
    scheduler_tls_server_name: str = ""
    scheduler_tls_client_cert_file: str = ""
    scheduler_tls_client_key_file: str = ""


def _apply_stat_overrides(stats: "hostinfo.HostStats", overrides: dict) -> None:
    """Apply dotted-path overrides onto a HostStats, raising on unknown
    paths — a typo silently keeping the sampled value would poison every
    announced record. Shared by the constructor's
    fail-fast validation and the per-announce application."""
    for path, value in overrides.items():
        group, _, attr = path.partition(".")
        target = getattr(stats, group, None)
        if target is None or not attr or not hasattr(target, attr):
            raise ValueError(
                f"host_stats_override: unknown stat path {path!r}"
                f" (expected '<group>.<field>' on HostStats)"
            )
        setattr(target, attr, value)


class Daemon:
    """One peer host: piece store + upload server + dfdaemon gRPC +
    scheduler announce/probe loops."""

    def __init__(self, config: DaemonConfig):
        self.cfg = config
        # fail fast on typo'd stat paths — don't wait for the first
        # announce to discover a bad config
        _apply_stat_overrides(hostinfo.HostStats(), config.host_stats_override)
        self.host_id = host_id_v2(config.ip, config.hostname)
        self.storage = StorageManager(
            config.data_dir,
            max_bytes=config.storage_max_bytes,
            dedup=config.piece_dedup,
        )
        self.upload = UploadServer(
            self.storage,
            host=config.upload_host,
            port=config.upload_port,
            delay_s=config.upload_delay_s,
            cold_piece_delay_s=config.upload_cold_piece_delay_s,
            rate_limit_bps=config.upload_rate_limit,
            use_sendfile=config.upload_sendfile,
        )
        self._selector = None
        self._server = None
        self.port = 0
        self._stop = threading.Event()
        self._dynconfig = None
        self._manager_channel = None
        self._telemetry_reporter = None
        self._threads: list[threading.Thread] = []
        self.gc = GC()
        self.task_manager: TaskManager | None = None
        self.proxy = None
        # constructed here, not in start(): probe_once() is a public
        # single-round entry point and must work without a running
        # probe loop (per-host echo budget tied to the probe cadence —
        # concurrent probes of one host within a round reuse the cached
        # RTT instead of multiplying echoes)
        from dragonfly2_torch.utils.ping import Pinger

        self._pinger = Pinger(
            min_interval=min(1.0, config.probe_interval / 2)
            if config.probe_interval > 0
            else 1.0
        )

    # ------------------------------------------------------------------
    def _make_scheduler_dynconfig(self):
        """Searcher-scoped DaemonDynconfig over the manager, with a disk
        cache fallback under data_dir (utils/dynconfig.DaemonDynconfig;
        upstream client/config/dynconfig_manager.go)."""
        from dragonfly2_torch.utils.dynconfig import DaemonDynconfig

        self._manager_channel = glue.dial(
            self.cfg.manager_address,
            **glue.dial_tls_args(
                self.cfg.manager_tls_ca_file,
                self.cfg.manager_tls_server_name,
                self.cfg.manager_tls_client_cert_file,
                self.cfg.manager_tls_client_key_file,
            ),
        )
        return DaemonDynconfig(
            glue.ServiceClient(self._manager_channel, MANAGER_SERVICE),
            cache_path=Path(self.cfg.data_dir) / "dynconfig.json",
            refresh_interval=self.cfg.dynconfig_interval,
            hostname=self.cfg.hostname,
            ip=self.cfg.ip,
            idc=self.cfg.idc,
            location=self.cfg.location,
        )

    def start(self) -> None:
        for option, enabled, what, item in NOT_PORTED:
            value = getattr(self.cfg, option)
            if enabled(value):
                raise NotImplementedError(
                    f"DaemonConfig.{option}={value!r} enables {what}, which this"
                    f" package does not port yet (ROADMAP {item})"
                )
        self.upload.start()
        addresses = [a for a in self.cfg.scheduler_address.split(",") if a.strip()]
        if self.cfg.manager_address:
            # dynconfig-fed scheduler list: the manager's view of the
            # cluster (searcher-scoped to this daemon's location) is the
            # source of truth, refreshed on an interval; the static list
            # is the bootstrap/fallback (upstream client dynconfig)
            self._dynconfig = self._make_scheduler_dynconfig()
            fetched = self._dynconfig.scheduler_addresses()
            if fetched:
                addresses = fetched
            elif not addresses:
                # surface the real cause: get() swallows fetch failures
                # into {}, which reads as "manager has no schedulers" —
                # an unreachable/TLS-mismatched manager is a different bug
                try:
                    self._dynconfig.fetch_once()
                except Exception as e:
                    raise RuntimeError(
                        f"manager dynconfig fetch failed ({e}) and no static"
                        " scheduler_address fallback is configured"
                    ) from e
                raise RuntimeError(
                    "manager returned no schedulers and no static"
                    " scheduler_address fallback is configured"
                )
        self._selector = glue.SchedulerSelector(
            addresses,
            dial_kwargs=glue.dial_tls_args(
                self.cfg.scheduler_tls_ca_file,
                self.cfg.scheduler_tls_server_name,
                self.cfg.scheduler_tls_client_cert_file,
                self.cfg.scheduler_tls_client_key_file,
            ),
        )
        if self._dynconfig is not None:
            self._dynconfig.register(
                lambda data: self._selector.update_addresses(
                    self._dynconfig.addresses_of(data)
                )
            )
            self._dynconfig.start()
        # fail fast when no scheduler is reachable; NOT pinned — the
        # probe loop re-resolves the primary per round because dynconfig
        # membership changes can close any cached channel
        self._selector.primary()

        from dragonfly2_torch.client.piece_manager import TrafficShaper

        self.shaper = TrafficShaper(self.cfg.total_download_rate)
        self.shaper.start()
        self.task_manager = TaskManager(
            host_id=self.host_id,
            storage=self.storage,
            scheduler_client=self._selector,
            piece_manager=PieceManager(
                concurrent_pieces=self.cfg.piece_workers,
                shaper=self.shaper,
                download_delay_s=self.cfg.download_delay_s,
            ),
            options=ConductorOptions(
                piece_workers=self.cfg.piece_workers,
                schedule_timeout=self.cfg.schedule_timeout,
                piece_length=self.cfg.piece_length,
            ),
            host_info_fn=self.host_info,
        )
        service = DfdaemonService(
            task_manager=self.task_manager,
            storage=self.storage,
            upload_addr=self.upload.address,
        )
        extra = []
        if self.cfg.unix_socket:
            # local CLIs (dfget/dfcache/dfstore) reach the daemon through
            # the socket without touching the TCP stack (upstream
            # pkg/rpc/mux.go unix listener; dfget root.go:279 dials it)
            sock = Path(self.cfg.unix_socket)
            sock.parent.mkdir(parents=True, exist_ok=True)
            if sock.exists():
                # connect-before-unlink: only a DEAD socket is stale. A
                # spawn race must not unbind a healthy daemon and orphan
                # it on a deleted inode
                probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    probe.settimeout(1.0)
                    probe.connect(str(sock))
                    probe.close()
                    raise RuntimeError(
                        f"another daemon is serving {sock}; refusing to unbind it"
                    )
                except socket.timeout:
                    # a connect TIMEOUT is a live-but-stalled daemon (GC
                    # pause, loaded host) — unbinding it would orphan a
                    # healthy server on a deleted inode
                    probe.close()
                    raise RuntimeError(
                        f"a daemon appears to be serving {sock} (slow to"
                        " accept); refusing to unbind it"
                    )
                except (ConnectionRefusedError, FileNotFoundError, OSError):
                    probe.close()
                    try:
                        sock.unlink()  # stale socket from an unclean shutdown
                    except FileNotFoundError:
                        pass  # raced: its owner already removed it
            extra.append(f"unix:{sock}")
        # flight recorder: crash dumps on SIGTERM/fatal + the Diagnose
        # snapshot RPC on the daemon's gRPC plane
        from dragonfly2_torch.rpc.diagnose import DiagnoseService
        from dragonfly2_torch.utils import flight, profiling

        flight.install("daemon")
        # continuous profiler: always-on sampler + phase ledger
        profiling.install("daemon")
        flight.register_probe(
            "daemon.tasks",
            lambda: {"conductors": len(self.task_manager.conductors)},
        )
        self._server, self.port = glue.serve(
            {DFDAEMON_SERVICE: service, glue.DIAGNOSE_SERVICE: DiagnoseService()},
            address=self.cfg.listen,
            extra_addresses=extra,
        )
        from dragonfly2_torch.utils.metrics import set_build_info

        set_build_info("daemon")
        if self._manager_channel is not None and self.cfg.telemetry_interval > 0:
            # cluster telemetry: the daemon's data-plane rates to the
            # manager over the dynconfig channel it already holds
            from dragonfly2_torch.utils.telemetry import TelemetryReporter
            from dragonfly2_torch.version import __version__

            def _sections():
                return {
                    "build": {"service": "daemon", "version": __version__},
                    "endpoints": {
                        "rpc": f"{self.cfg.ip}:{self.port}",
                        "metrics": getattr(self, "metrics_addr", "") or "",
                    },
                }

            self._telemetry_reporter = TelemetryReporter(
                glue.ServiceClient(self._manager_channel, glue.TELEMETRY_SERVICE),
                service="daemon",
                instance=f"{self.cfg.ip}:{self.port}",
                prefixes=("dragonfly_daemon_", "dragonfly_flow_"),
                interval=self.cfg.telemetry_interval,
                collect_sections=_sections,
            )
            self._telemetry_reporter.start()
        # announce before the proxy opens for business: a request through
        # it may register a peer task at once, which requires a known host
        self.announce_host()

        if self.cfg.proxy_port >= 0:
            from dragonfly2_torch.client.proxy import ProxyServer, RegistryMirror
            from dragonfly2_torch.client.transport import P2PTransport, ProxyRule

            rules = [
                r if isinstance(r, ProxyRule) else ProxyRule(**r)
                for r in self.cfg.proxy_rules
            ]
            issuer = None
            if self.cfg.proxy_mitm:
                issuer = self._load_spoofing_issuer()
            self.proxy = ProxyServer(
                P2PTransport(
                    self.task_manager,
                    rules=rules,
                    max_inflight=self.cfg.p2p_max_inflight,
                ),
                mirror=RegistryMirror(self.cfg.registry_mirror),
                address=self.cfg.proxy_host,
                port=self.cfg.proxy_port,
                issuer=issuer,
                intercept=self.cfg.proxy_mitm_hosts or None,
            )
            self.proxy.start()

        if self.cfg.metrics_port >= 0:
            from dragonfly2_torch.client import metrics  # noqa: F401
            from dragonfly2_torch.utils.metrics import MetricsServer, default_registry

            self._metrics = MetricsServer(default_registry, host=self.cfg.metrics_host, port=self.cfg.metrics_port)
            # liveness on the scrape port (/healthz): the gRPC plane up
            self._metrics.register_health("dfdaemon", lambda: self._server is not None)
            self.metrics_addr = self._metrics.start()
            logger.info("daemon metrics on %s", self.metrics_addr)

        self._spawn(self._announce_loop, "announcer")
        if self.cfg.probe_interval > 0:
            self._spawn(self._probe_loop, "prober")
        if self.cfg.host_type == "super" and self._manager_channel is not None:
            # seed peers are manager-visible infrastructure: register and
            # keep alive so preheat targeting and the console's seed-peer
            # view reflect them (upstream seed-peer manager registration;
            # normal daemons stay scheduler-only). Registration is
            # best-effort here — the keepalive loop re-registers, so a
            # transient manager outage never kills a booting daemon
            try:
                self._register_seed_peer()
            except Exception as e:
                logger.warning("initial seed-peer registration failed: %s", e)
            self._spawn(self._seed_keepalive_loop, "seed-keepalive")
        self.gc.add(
            GCTask(
                "storage",
                interval=self.cfg.gc_interval,
                timeout=30.0,
                runner=self.storage.reclaim,
            )
        )
        self.gc.start()
        logger.info(
            "daemon up: host=%s grpc=:%d upload=%s", self.host_id, self.port, self.upload.address
        )

    def stop(self) -> None:
        self._stop.set()
        if self._telemetry_reporter is not None:
            self._telemetry_reporter.stop()
        if self._dynconfig is not None:
            self._dynconfig.stop()
        if self._manager_channel is not None:
            self._manager_channel.close()
        selector = getattr(self, "_selector", None)
        if selector is not None:
            for client in selector.all():
                try:
                    client.LeaveHost(
                        scheduler_pb2.LeaveHostRequest(host_id=self.host_id)
                    )
                except Exception as e:
                    # best-effort; TTL GC reaps the host eventually
                    logger.debug("LeaveHost on shutdown failed: %s", e)
        if getattr(self, "_metrics", None) is not None:
            self._metrics.stop()
        if getattr(self, "shaper", None) is not None:
            self.shaper.stop()
        self.gc.stop()
        if self.proxy is not None:
            self.proxy.stop()
        if self._server is not None:
            self._server.stop(grace=1).wait()
        self.upload.stop()
        if getattr(self, "_selector", None) is not None:
            self._selector.close()

    def _register_seed_peer(self) -> None:
        client = glue.ServiceClient(self._manager_channel, MANAGER_SERVICE)
        client.UpdateSeedPeer(
            manager_pb2.UpdateSeedPeerRequest(
                hostname=self.cfg.hostname,
                ip=self.cfg.ip,
                port=int(self.port),
                download_port=int(self.upload.port),
                type="super",
                idc=self.cfg.idc,
                location=self.cfg.location,
                seed_peer_cluster_id=self.cfg.scheduler_cluster_id,
            )
        )
        logger.info("registered as seed peer with manager")

    def _seed_keepalive_loop(self) -> None:
        # UpdateSeedPeer is an idempotent upsert stamping last_keepalive,
        # so re-registering IS the keepalive — and it self-heals when the
        # manager-side row vanished (DB recreated, operator delete),
        # which a bare UPDATE-style keepalive would silently miss
        while not self._stop.wait(self.cfg.announce_interval):
            try:
                self._register_seed_peer()
            except Exception as e:
                logger.warning("seed-peer keepalive failed: %s", e)

    def _spawn(self, fn, name: str) -> None:
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    # ------------------------------------------------------------------
    # host announce (upstream client/daemon/announcer/announcer.go:158-303)
    # ------------------------------------------------------------------
    def host_stats(self) -> hostinfo.HostStats:
        """Sample live host stats, then apply configured overrides (the
        harness models synthetic hosts; production runs sample-only)."""
        if self.cfg.collect_host_stats:
            stats = hostinfo.collect(
                data_dir=self.cfg.data_dir,
                upload_ports=(self.upload.port, self.port),
            )
        else:
            stats = hostinfo.HostStats()
        _apply_stat_overrides(stats, self.cfg.host_stats_override)
        return stats

    def host_info(self) -> common_pb2.HostInfo:
        s = self.host_stats()
        return common_pb2.HostInfo(
            id=self.host_id,
            type=self.cfg.host_type,
            hostname=self.cfg.hostname,
            ip=self.cfg.ip,
            port=self.port,
            download_port=self.upload.port,
            os="linux",
            concurrent_upload_limit=self.cfg.concurrent_upload_limit,
            cpu=common_pb2.CpuStat(
                logical_count=s.cpu.logical_count,
                physical_count=s.cpu.physical_count,
                percent=s.cpu.percent,
                process_percent=s.cpu.process_percent,
            ),
            memory=common_pb2.MemoryStat(
                total=s.memory.total,
                available=s.memory.available,
                used=s.memory.used,
                used_percent=s.memory.used_percent,
                process_used_percent=s.memory.process_used_percent,
                free=s.memory.free,
            ),
            network=common_pb2.NetworkStat(
                tcp_connection_count=s.network.tcp_connection_count,
                upload_tcp_connection_count=s.network.upload_tcp_connection_count,
                location=self.cfg.location,
                idc=self.cfg.idc,
            ),
            disk=common_pb2.DiskStat(
                total=s.disk.total,
                free=s.disk.free,
                used=s.disk.used,
                used_percent=s.disk.used_percent,
                inodes_total=s.disk.inodes_total,
                inodes_used=s.disk.inodes_used,
                inodes_used_percent=s.disk.inodes_used_percent,
            ),
            scheduler_cluster_id=self.cfg.scheduler_cluster_id,
        )

    def _load_spoofing_issuer(self):
        """CA for HTTPS interception, persisted across restarts so
        clients only provision trust once (reference proxy CA cert
        config)."""
        import os

        from dragonfly2_torch.utils.issuer import CertificateAuthority, SpoofingIssuer

        ca_dir = os.path.join(self.cfg.data_dir, "ca")
        crt, key = os.path.join(ca_dir, "ca.crt"), os.path.join(ca_dir, "ca.key")
        if os.path.exists(crt) and os.path.exists(key):
            with open(crt, "rb") as f1, open(key, "rb") as f2:
                ca = CertificateAuthority.load(f1.read(), f2.read())
        else:
            os.makedirs(ca_dir, exist_ok=True)
            ca = CertificateAuthority(f"dragonfly2 proxy CA ({self.cfg.hostname})")
            with open(crt, "wb") as f:
                f.write(ca.cert_pem)
            # the CA key must never be world-readable, not even between
            # create and chmod — open with the final mode
            fd = os.open(key, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
            with os.fdopen(fd, "wb") as f:
                f.write(ca.key_pem)
        logger.info("proxy MITM enabled; CA at %s", crt)
        return SpoofingIssuer(ca)

    def announce_host(self) -> None:
        # every scheduler must know this host: tasks pin to different
        # schedulers by consistent hash, and any of them may hand this
        # host out as a candidate parent
        info = self.host_info()
        for client in self._selector.all():
            try:
                client.AnnounceHost(scheduler_pb2.AnnounceHostRequest(host=info))
            except Exception as e:
                # one dead scheduler must not starve the others of
                # announcements — they'd expire this host and stop
                # offering it as a parent
                logger.warning("announce to one scheduler failed: %s", e)

    def _announce_loop(self) -> None:
        while not self._stop.wait(self.cfg.announce_interval):
            try:
                self.announce_host()
            except Exception as e:
                logger.warning("announce host failed: %s", e)

    # ------------------------------------------------------------------
    # prober (upstream client/daemon/networktopology/network_topology.go:71-203)
    #
    # RTT measurement is ICMP echo first (upstream pkg/net/ping/ping.go:
    # privileged pinger, 1 echo, 1s timeout) with a per-host rate limit,
    # falling back to a TCP connect round-trip to the target's upload
    # port when ICMP is unavailable (no CAP_NET_RAW and no unprivileged
    # ping range) — same latency signal, needs an open port instead of
    # privileges. utils/ping.py implements both ICMP modes.
    # ------------------------------------------------------------------
    def probe_once(self) -> int:
        """One SyncProbes round; returns number of hosts probed. The
        request side is queue-fed so the response iterator is only read
        from this thread (reading it from inside the request generator
        races gRPC's send loop)."""
        import queue as _queue

        me = self.host_info()
        q: "_queue.Queue[scheduler_pb2.SyncProbesRequest | None]" = _queue.Queue()
        q.put(
            scheduler_pb2.SyncProbesRequest(
                host=me, probe_started=scheduler_pb2.ProbeStartedRequest()
            )
        )
        responses = self._selector.primary().SyncProbes(iter(q.get, None))
        probed = 0
        try:
            resp = next(responses, None)
            if resp is not None and resp.hosts:
                probes, failed = [], []
                for ph in resp.hosts:
                    port = ph.host.download_port or ph.host.port
                    rtt = self._pinger.rtt(
                        ph.host.ip,
                        fallback=lambda ip, p=port: self._tcp_ping(ip, p),
                    )
                    if rtt is None:
                        failed.append(
                            scheduler_pb2.FailedProbeResult(
                                host_id=ph.host.id, description="unreachable"
                            )
                        )
                    else:
                        probes.append(
                            scheduler_pb2.ProbeResult(
                                host_id=ph.host.id,
                                rtt_ns=int(rtt * 1e9),
                                created_at_ns=time.time_ns(),
                            )
                        )
                if probes:
                    q.put(
                        scheduler_pb2.SyncProbesRequest(
                            host=me,
                            probe_finished=scheduler_pb2.ProbeFinishedRequest(probes=probes),
                        )
                    )
                if failed:
                    q.put(
                        scheduler_pb2.SyncProbesRequest(
                            host=me,
                            probe_failed=scheduler_pb2.ProbeFailedRequest(probes=failed),
                        )
                    )
                probed = len(probes)
        finally:
            q.put(None)
            for _ in responses:  # drain until the server closes
                pass
        return probed

    @staticmethod
    def _tcp_ping(ip: str, port: int, timeout: float = 2.0) -> float | None:
        t0 = time.monotonic()
        try:
            with socket.create_connection((ip, port), timeout=timeout):
                return time.monotonic() - t0
        except OSError:
            return None

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.cfg.probe_interval):
            try:
                self.probe_once()
            except Exception as e:
                logger.warning("probe round failed: %s", e)


# ---------------------------------------------------------------------------
# `python -m dragonfly2_torch.client.daemon` — the dfdaemon binary
# (upstream cmd/dfdaemon; daemon assembly client/daemon/daemon.go:114,524)
# ---------------------------------------------------------------------------


class _DaemonRunAdapter:
    """Adapts Daemon.start/stop onto the runner's serve/stop contract."""

    def __init__(self, daemon: "Daemon"):
        self.daemon = daemon

    def serve(self) -> str:
        self.daemon.start()
        host = self.daemon.cfg.listen.rsplit(":", 1)[0]
        return f"{host}:{self.daemon.port}"

    def stop(self) -> None:
        self.daemon.stop()


def main(argv=None) -> int:
    from dragonfly2_torch.cli.runner import main_with_config

    def build(config_path, overrides):
        from dragonfly2_torch.cli.config import load_config

        cfg = load_config(
            DaemonConfig, config_path, env_prefix="DF_DAEMON", overrides=overrides
        )
        return _DaemonRunAdapter(Daemon(cfg))

    return main_with_config("daemon", build, argv)


if __name__ == "__main__":
    import sys

    sys.exit(main())
