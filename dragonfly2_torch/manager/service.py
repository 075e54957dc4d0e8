"""The manager's gRPC service (counterpart of the reference's
``manager/service.py``; upstream manager/rpcserver/manager_server_v1.go +
v2): the scheduler and seed-peer registry, keepalive, dynconfig serving,
the job queue, the model registry RPCs the trainer and the scheduler
consume, and certificate issuance — ``ManagerService``, the server half —
and ``ManagerGrpcClientAdapter``, the trainer's uploader over gRPC.

With ``fleet_kv`` (the manager's embedded RESP store, where the
scheduler fleet keeps its leases) ``ListSchedulers`` is scoped to the
schedulers that hold a live lease (``scheduler/fleet.read_members``)."""

from __future__ import annotations

import json
import time

import grpc

from dragonfly2_torch.manager import metrics as M
from dragonfly2_torch.manager.database import Database
from dragonfly2_torch.manager.models_registry import ModelRegistry
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.rpc.glue import MANAGER_SERVICE as SERVICE_NAME  # noqa: F401
from dragonfly2_torch.utils import dflog

manager_pb2 = protos.load("manager_pb2")

logger = dflog.get("manager.rpc")

# schedulers silent longer than this flip to inactive (upstream keepalive)
KEEPALIVE_TIMEOUT = 60.0


class ManagerService:
    def __init__(
        self,
        db: Database,
        models: ModelRegistry,
        ca=None,
        ca_token: str = "",
        fleet_kv=None,
    ):
        from dragonfly2_torch.manager.searcher import new_searcher

        self.db = db
        self.models = models
        self.searcher = new_searcher()  # plugin seam (utils/dfplugin)
        self.default_cluster_id = db.ensure_default_cluster()
        # utils.issuer.CertificateAuthority for IssueCertificate; None =
        # dynamic issuance disabled (static cert files only). ca_token:
        # cluster registration secret required from requesters ('' = open
        # — dev mode only; production sets one)
        self.ca = ca
        self.ca_token = ca_token
        # scheduler-fleet view (scheduler/fleet.py): a KV store holding
        # the fleet's leased member set — when live leases exist, the
        # dynconfig scheduler list is scoped to them, so daemons polling
        # the manager also converge within one lease TTL of a member
        # death instead of the 60s keepalive timeout. None/empty fleet →
        # the keepalive-based registry stands alone (compat).
        self.fleet_kv = fleet_kv

    # -- scheduler registry ------------------------------------------------
    def UpdateScheduler(self, request, context):
        now = time.time()
        cluster_id = request.scheduler_cluster_id or self.default_cluster_id
        self.db.execute(
            "INSERT INTO schedulers (hostname, ip, port, idc, location, state,"
            " scheduler_cluster_id, last_keepalive, created_at, updated_at)"
            " VALUES (?, ?, ?, ?, ?, 'active', ?, ?, ?, ?)"
            " ON CONFLICT(hostname, ip, scheduler_cluster_id) DO UPDATE SET"
            " port = excluded.port, idc = excluded.idc, location = excluded.location,"
            " state = 'active', last_keepalive = excluded.last_keepalive,"
            " updated_at = excluded.updated_at",
            (request.hostname, request.ip, request.port, request.idc,
             request.location, cluster_id, now, now, now),
        )
        return self._scheduler(request.hostname, request.ip, cluster_id, context)

    def GetScheduler(self, request, context):
        cluster_id = request.scheduler_cluster_id or self.default_cluster_id
        return self._scheduler(request.hostname, request.ip, cluster_id, context)

    def _scheduler(self, hostname, ip, cluster_id, context):
        r = self.db.query_one(
            "SELECT * FROM schedulers WHERE hostname = ? AND ip = ? AND scheduler_cluster_id = ?",
            (hostname, ip, cluster_id),
        )
        if r is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"scheduler {hostname}/{ip} not found")
        return manager_pb2.Scheduler(
            id=r["id"], hostname=r["hostname"], ip=r["ip"], port=r["port"],
            idc=r["idc"], location=r["location"], state=r["state"],
            scheduler_cluster_id=r["scheduler_cluster_id"],
        )

    def ListSchedulers(self, request, context):
        """Active schedulers for a joining peer. When the peer carries
        location hints and several clusters exist, the searcher picks the
        best-matching cluster and only its schedulers are returned
        (upstream searcher.go find-matching-cluster in ListSchedulers)."""
        self._expire_stale()
        rows = self.db.query("SELECT * FROM schedulers WHERE state = 'active'")
        cluster = self._match_cluster(request)
        if cluster is not None:
            scoped = [r for r in rows if r["scheduler_cluster_id"] == cluster.id]
            if scoped:
                rows = scoped
        live = self._fleet_members()
        if live:
            # fleet view in dynconfig: only members holding a live lease
            # are handed to daemons. An empty/unreadable lease plane
            # falls through to the keepalive registry — a KV outage must
            # not strand every daemon schedulerless.
            leased = [r for r in rows if f"{r['ip']}:{r['port']}" in live]
            if leased:
                rows = leased
            elif rows:
                # leases exist but match NO registered row: an
                # address-mismatch misconfiguration (lease advertises a
                # port the registration didn't carry) that silently
                # disables fast convergence — say so instead
                logger.warning(
                    "fleet leases %s match no registered scheduler %s;"
                    " serving the keepalive registry unscoped",
                    sorted(live),
                    sorted(f"{r['ip']}:{r['port']}" for r in rows),
                )
        return manager_pb2.ListSchedulersResponse(
            schedulers=[
                manager_pb2.Scheduler(
                    id=r["id"], hostname=r["hostname"], ip=r["ip"], port=r["port"],
                    idc=r["idc"], location=r["location"], state=r["state"],
                    scheduler_cluster_id=r["scheduler_cluster_id"],
                )
                for r in rows
            ]
        )

    def _fleet_members(self) -> "set[str] | None":
        if self.fleet_kv is None:
            return None
        try:
            from dragonfly2_torch.scheduler.fleet import read_members

            return set(read_members(self.fleet_kv))
        except Exception as e:
            logger.warning("fleet membership read failed: %s", e)
            return None

    def _match_cluster(self, request):
        if not (request.ip or request.idc or request.location):
            return None
        from dragonfly2_torch.manager.searcher import Cluster, ClusterScope, PeerInfo

        crows = self.db.query("SELECT * FROM scheduler_clusters ORDER BY id")
        if len(crows) < 2:
            return None
        clusters = []
        for r in crows:
            scopes = Database.loads(r["scopes"]) or {}
            clusters.append(
                Cluster(
                    id=r["id"],
                    name=r["name"],
                    scopes=ClusterScope(
                        idc=scopes.get("idc", ""),
                        location=scopes.get("location", ""),
                        cidrs=scopes.get("cidrs", []),
                    ),
                    is_default=bool(r["is_default"]),
                )
            )
        return self.searcher.find_matching_cluster(
            clusters,
            PeerInfo(ip=request.ip, idc=request.idc, location=request.location),
        )

    def _expire_stale(self) -> None:
        cutoff = time.time() - KEEPALIVE_TIMEOUT
        self.db.execute(
            "UPDATE schedulers SET state = 'inactive' WHERE last_keepalive < ? AND state = 'active'",
            (cutoff,),
        )
        self.db.execute(
            "UPDATE seed_peers SET state = 'inactive' WHERE last_keepalive < ? AND state = 'active'",
            (cutoff,),
        )

    # -- seed peers --------------------------------------------------------
    def UpdateSeedPeer(self, request, context):
        now = time.time()
        cluster_id = request.seed_peer_cluster_id or 1
        self.db.execute(
            "INSERT OR IGNORE INTO seed_peer_clusters (id, name, created_at, updated_at)"
            " VALUES (?, ?, ?, ?)",
            (cluster_id, f"cluster-{cluster_id}", now, now),
        )
        self.db.execute(
            "INSERT INTO seed_peers (hostname, ip, port, download_port, type, idc,"
            " location, state, seed_peer_cluster_id, last_keepalive, created_at, updated_at)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, 'active', ?, ?, ?, ?)"
            " ON CONFLICT(hostname, ip, seed_peer_cluster_id) DO UPDATE SET"
            " port = excluded.port, download_port = excluded.download_port,"
            " type = excluded.type, state = 'active',"
            " last_keepalive = excluded.last_keepalive, updated_at = excluded.updated_at",
            (request.hostname, request.ip, request.port, request.download_port,
             request.type or "super", request.idc, request.location, cluster_id, now, now, now),
        )
        r = self.db.query_one(
            "SELECT * FROM seed_peers WHERE hostname = ? AND ip = ? AND seed_peer_cluster_id = ?",
            (request.hostname, request.ip, cluster_id),
        )
        return manager_pb2.SeedPeer(
            id=r["id"], hostname=r["hostname"], ip=r["ip"], port=r["port"],
            download_port=r["download_port"], type=r["type"], idc=r["idc"],
            location=r["location"], seed_peer_cluster_id=r["seed_peer_cluster_id"],
        )

    # -- keepalive ---------------------------------------------------------
    def KeepAlive(self, request_iterator, context):
        for req in request_iterator:
            now = time.time()
            # cluster-scoped: the same hostname/ip may be registered in
            # several clusters (UNIQUE(hostname, ip, cluster_id)); a
            # keepalive must only revive its own cluster's row.
            # cluster_id 0 (unset) keeps the legacy any-cluster match.
            if req.source_type == "scheduler":
                sql = (
                    "UPDATE schedulers SET last_keepalive = ?, state = 'active'"
                    " WHERE hostname = ? AND ip = ?"
                )
                args: tuple = (now, req.hostname, req.ip)
                if req.cluster_id:
                    sql += " AND scheduler_cluster_id = ?"
                    args += (req.cluster_id,)
                self.db.execute(sql, args)
            elif req.source_type == "seed_peer":
                sql = (
                    "UPDATE seed_peers SET last_keepalive = ?, state = 'active'"
                    " WHERE hostname = ? AND ip = ?"
                )
                args = (now, req.hostname, req.ip)
                if req.cluster_id:
                    sql += " AND seed_peer_cluster_id = ?"
                    args += (req.cluster_id,)
                self.db.execute(sql, args)
        return manager_pb2.Empty()

    # -- dynconfig ---------------------------------------------------------
    def GetSchedulerClusterConfig(self, request, context):
        cluster_id = request.scheduler_cluster_id or self.default_cluster_id
        r = self.db.query_one(
            "SELECT config FROM scheduler_clusters WHERE id = ?", (cluster_id,)
        )
        if r is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"cluster {cluster_id} not found")
        cfg = Database.loads(r["config"])
        return manager_pb2.SchedulerClusterConfig(
            candidate_parent_limit=int(cfg.get("candidate_parent_limit", 0)),
            filter_parent_limit=int(cfg.get("filter_parent_limit", 0)),
            json=r["config"],
        )

    # -- async jobs (manager is the queue of record; scheduler workers
    # poll ListPendingJobs — upstream internal/job machinery on Redis) --
    def CreateJob(self, request, context):
        if request.type not in ("preheat", "sync_peers", "recommend_seeds"):
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"unknown job type {request.type}")
        now = time.time()
        cur = self.db.execute(
            "INSERT INTO jobs (type, state, args, scheduler_cluster_id, created_at, updated_at)"
            " VALUES (?, 'queued', ?, ?, ?, ?)",
            (
                request.type,
                request.args_json or "{}",
                request.scheduler_cluster_id or self.default_cluster_id,
                now,
                now,
            ),
        )
        return self._job(self.db.query_one("SELECT * FROM jobs WHERE id = ?", (cur.lastrowid,)))

    def GetJob(self, request, context):
        r = self.db.query_one("SELECT * FROM jobs WHERE id = ?", (request.id,))
        if r is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"job {request.id} not found")
        return self._job(r)

    # a worker that leased a job but never posted a result is presumed
    # dead after this long; the job is re-leased to the next poller
    JOB_LEASE_TIMEOUT = 300.0

    def ListPendingJobs(self, request, context):
        """Lease queued jobs (and expired running leases) to the polling
        worker atomically so two workers can't both execute one."""
        cluster_id = request.scheduler_cluster_id or self.default_cluster_id
        worker = f"{request.ip}_{request.hostname}"
        now = time.time()
        stale = now - self.JOB_LEASE_TIMEOUT
        with self.db.transaction():
            rows = self.db.query(
                "SELECT * FROM jobs WHERE scheduler_cluster_id = ? AND"
                " (state = 'queued' OR (state = 'running' AND updated_at < ?))"
                " ORDER BY id LIMIT 16",
                (cluster_id, stale),
            )
            if rows:
                ids = [r["id"] for r in rows]
                self.db.execute(
                    "UPDATE jobs SET state = 'running', leased_by = ?, updated_at = ?"
                    f" WHERE id IN ({','.join('?' * len(ids))})",
                    (worker, now, *ids),
                )
                for r in rows:
                    r["state"] = "running"
        return manager_pb2.ListPendingJobsResponse(jobs=[self._job(r) for r in rows])

    def UpdateJobResult(self, request, context):
        if request.state not in ("succeeded", "failed"):
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"bad job state {request.state}")
        worker = f"{request.ip}_{request.hostname}"
        cur = self.db.execute(
            "UPDATE jobs SET state = ?, result = ?, updated_at = ?"
            " WHERE id = ? AND state = 'running' AND leased_by = ?",
            (request.state, request.result_json or "{}", time.time(), request.id, worker),
        )
        r = self.db.query_one("SELECT * FROM jobs WHERE id = ?", (request.id,))
        if r is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"job {request.id} not found")
        if cur.rowcount == 0:
            # lease lost (timed out and re-leased) — the poster's result
            # is stale; report the authoritative row instead of writing
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                f"job {request.id} lease not held by {worker} (state {r['state']})",
            )
        if r["type"] == "sync_peers" and request.state == "succeeded":
            self._materialize_peers(r)
        return self._job(r)

    def _materialize_peers(self, job_row) -> None:
        """sync_peers result → the peers table the REST surface reads
        (upstream manager/models.Peer refreshed by the sync-peers job,
        handlers/peer.go). Full refresh per cluster: hosts gone from the
        scheduler's view disappear here too.

        The result is WORKER-SUPPLIED data: every row is validated and
        coerced BEFORE the old rows are deleted (execute() auto-commits,
        so a mid-loop crash would otherwise wipe the cluster's peers
        with no rollback), and a malformed result is logged and skipped
        — it must never fail the RPC after the job row committed."""
        try:
            result = json.loads(job_row["result"] or "{}")
            if not isinstance(result, dict):
                raise TypeError(f"result is {type(result).__name__}, not an object")
            # an empty hosts LIST is a legitimate refresh-to-zero (the
            # scheduler sees no hosts); a missing/wrong-shape field is not
            hosts = result.get("hosts")
            if not isinstance(hosts, list):
                raise TypeError("result.hosts is not a list")
            cluster = job_row["scheduler_cluster_id"]
            now = time.time()
            rows = [
                (
                    str(h.get("id", "")), str(h.get("hostname", "")),
                    str(h.get("ip", "")), str(h.get("type", "normal")),
                    int(h.get("peer_count") or 0), int(h.get("upload_count") or 0),
                    cluster, now, now,
                )
                for h in hosts
                if isinstance(h, dict)
            ]
        except (ValueError, TypeError) as e:
            logger.warning(
                "sync_peers job %s result unusable, peers table unchanged: %s",
                job_row["id"], e,
            )
            return
        with self.db.transaction():
            self.db.execute(
                "DELETE FROM peers WHERE scheduler_cluster_id = ?", (cluster,)
            )
            for row in rows:
                self.db.execute(
                    "INSERT OR REPLACE INTO peers (host_id, hostname, ip, type,"
                    " state, peer_count, upload_count, scheduler_cluster_id,"
                    " created_at, updated_at) VALUES (?, ?, ?, ?, 'active', ?, ?, ?, ?, ?)",
                    row,
                )

    @staticmethod
    def _job(r) -> manager_pb2.Job:
        return manager_pb2.Job(
            id=r["id"],
            type=r["type"],
            state=r["state"],
            args_json=r["args"],
            result_json=r["result"],
            scheduler_cluster_id=r["scheduler_cluster_id"],
            created_at_ns=int(r["created_at"] * 1e9),
        )

    # -- model registry ----------------------------------------------------
    def CreateModel(self, request, context):
        M.MODEL_CREATED_TOTAL.labels(request.type or "unknown").inc()
        evaluation = {
            "precision": request.evaluation.precision,
            "recall": request.evaluation.recall,
            "f1": request.evaluation.f1,
            "mse": request.evaluation.mse,
            "mae": request.evaluation.mae,
        }
        row = self.models.create(
            model_id=request.model_id,
            model_type=request.type,
            weights=request.weights,
            evaluation=evaluation,
            ip=request.ip,
            hostname=request.hostname,
            scheduler_cluster_id=request.scheduler_cluster_id or self.default_cluster_id,
        )
        return self._model(row)

    def GetModel(self, request, context):
        row = self.models.get(request.model_id, request.version)
        if row is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"model {request.model_id} v{request.version} not found",
            )
        return self._model(row)

    def GetModelWeights(self, request, context):
        """Weights blob for the serving side (scheduler ml evaluator).
        version 0 = the active version (upstream: the scheduler's
        would-be Triton ModelInfer hop — here weights come down once and
        inference runs in-process, manager/service/model.go:109 activation
        gating applies via the version-0 lookup)."""
        row = self.models.get(request.model_id, request.version)
        if row is None:
            context.abort(
                grpc.StatusCode.NOT_FOUND,
                f"model {request.model_id} v{request.version} not found",
            )
        try:
            weights = self.models.load_weights(request.model_id, row.version)
        except (KeyError, OSError) as e:
            context.abort(grpc.StatusCode.INTERNAL, f"weights load failed: {e}")
        return manager_pb2.ModelWeights(
            model_id=row.model_id,
            version=row.version,
            type=row.type,
            weights=weights,
        )

    def ListModels(self, request, context):
        rows = self.models.list(request.scheduler_cluster_id or None)
        return manager_pb2.ListModelsResponse(models=[self._model(r) for r in rows])

    def UpdateModel(self, request, context):
        if request.state == "active":
            try:
                row = self.models.activate(request.model_id, request.version)
            except KeyError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            return self._model(row)
        if request.state == "inactive":
            # explicit deactivation is an operator decision the serve
            # path must honor (the scheduler's refresher withdraws the
            # model / serving slot on the next poll) — silently ignoring
            # it left "deactivated" models serving forever
            try:
                row = self.models.deactivate(request.model_id, request.version)
            except KeyError as e:
                context.abort(grpc.StatusCode.NOT_FOUND, str(e))
            return self._model(row)
        row = self.models.get(request.model_id, request.version)
        if row is None:
            context.abort(grpc.StatusCode.NOT_FOUND, f"model {request.model_id} not found")
        return self._model(row)

    # -- certificate issuance (upstream securityv1 CertificateService,
    # pkg/rpc/security/client/client_v1.go:99-117) ----------------------
    def IssueCertificate(self, request, context):
        if self.ca is None:
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                "dynamic certificate issuance is not enabled on this manager",
            )
        import hmac as _hmac

        if self.ca_token and not _hmac.compare_digest(request.token, self.ca_token):
            # wrong/missing cluster token: whoever asks gets NOTHING
            # signed — a CA that signs arbitrary identities for anyone
            # with network reach hands out cluster-wide impersonation
            context.abort(
                grpc.StatusCode.PERMISSION_DENIED,
                "certificate issuance requires the cluster registration token",
            )
        days = int(request.validity_days) or 180
        if days > 366:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"validity {days}d exceeds the 366d cap",
            )
        try:
            leaf = self.ca.issue_from_csr(request.csr_pem.encode(), validity_days=days)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except Exception as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"unparsable CSR: {e}")
        return manager_pb2.CertificateResponse(
            certificate_chain=[leaf.decode(), self.ca.cert_pem.decode()]
        )

    @staticmethod
    def _model(row) -> manager_pb2.Model:
        ev = row.evaluation
        return manager_pb2.Model(
            model_id=row.model_id,
            type=row.type,
            version=row.version,
            state=row.state,
            evaluation=manager_pb2.ModelEvaluation(
                precision=ev.get("precision", 0.0),
                recall=ev.get("recall", 0.0),
                f1=ev.get("f1", 0.0),
                mse=ev.get("mse", 0.0),
                mae=ev.get("mae", 0.0),
            ),
            object_key=row.object_key,
            created_at_ns=int(row.created_at * 1e9),
            updated_at_ns=int(row.updated_at * 1e9),
        )


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
