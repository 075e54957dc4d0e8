"""North-star A/B harness: the default evaluator against the ``ml``
evaluator whose models were trained and are served on the port's device
(counterpart of the reference's ``tools/ab_harness.py``).

The e2e quality metric is "beat the default evaluator's p50 piece-RTT on a
P2P cluster". This harness measures it with the REAL pipeline, in-process:
a scheduler + N daemons on localhost where half the hosts are slow
(synthetic upload latency, correlated with announced cpu/memory pressure,
as loaded hosts are in production). Phase 1 runs the workload under the
default linear evaluator and trains an MLP on the Download records it
produced (the production data path: records → announcer → trainer →
manager model registry → activation → ModelRefresher → MLEvaluator).
Phase 2 replays the identical workload under the installed model, scored
through the batched scoring service. Output: p50 piece-RTT per phase; the
ml evaluator wins by steering children away from loaded parents the linear
score cannot see (its weights ignore cpu/memory).

``run_gru_ab`` isolates the GRU's bad-node detection on a degrading-parent
scenario: both arms share the MLP ranking, one with the GRU installed.

The fits, the scorers and the GRU run on ``device`` (the card unless
``cpu`` is asked for); there is no numpy scorer and no fallback.

    python -m dragonfly2_torch.tools.ab_harness [--device cuda|cpu]

prints one JSON line: {"p50_default_ms": ..., "p50_ml_ms": ..., ..., "gru": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import tempfile
from dataclasses import dataclass, field

import numpy as np

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.utils import dflog

logger = dflog.get("tools.ab")


@dataclass
class ABConfig:
    n_daemons: int = 10
    n_slow: int = 5
    n_tasks: int = 6
    piece_length: int = 16 * 1024
    pieces_per_task: int = 4
    slow_delay_s: float = 0.040  # per-piece serving latency on loaded hosts
    fast_delay_s: float = 0.002
    # scheduler hands out this many candidates — small enough that the
    # evaluator's ranking (not the client dispatcher) decides outcomes
    candidate_parent_limit: int = 2
    seed: int = 7
    # phase 2 rides the BATCHED scoring service (scheduler/serving.py)
    # instead of the per-call evaluator — the production serve path.
    # "torch" serves the refresher's MLPScorer on ``device``; "off"
    # keeps the per-call path for ablation.
    serving_backend: str = "torch"
    # the fits', the scorers' and the scoring service's device
    device: str = "cuda"
    # loaded hosts announce this much cpu/memory pressure
    slow_stats: dict = field(
        default_factory=lambda: {"cpu.percent": 92.0, "memory.used_percent": 85.0}
    )
    fast_stats: dict = field(
        default_factory=lambda: {"cpu.percent": 8.0, "memory.used_percent": 22.0}
    )


@dataclass
class PhaseResult:
    p50_ms: float
    p90_ms: float
    mean_ms: float
    piece_count: int
    slow_parent_fraction: float


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def _make_origins(
    workdir: str, tag: str, n: int, piece_length: int, pieces_per_task: int, rng
) -> list[str]:
    """n origin payload files of exactly pieces_per_task pieces; one
    definition so every scenario's "identical workload" premise rests on
    the same generator."""
    d = os.path.join(workdir, f"origin-{tag}")
    os.makedirs(d, exist_ok=True)
    out = []
    for t in range(n):
        path = os.path.join(d, f"task-{t}.bin")
        with open(path, "wb") as f:
            f.write(rng.randbytes(piece_length * pieces_per_task))
        out.append(f"file://{path}")
    return out


class _Cluster:
    """One phase's scheduler + daemons (fresh state, same topology).

    ``daemon_kwargs_fn(i) -> dict`` overrides per-daemon DaemonConfig
    fields; the default models the MLP scenario's slow/fast split. A
    daemon whose kwargs carry ``_slow=True`` lands in ``slow_ids`` (the
    workload's parent-attribution set)."""

    def __init__(self, cfg: ABConfig, evaluator, workdir: str, daemon_kwargs_fn=None):
        from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
        from dragonfly2_torch.rpc.glue import serve
        from dragonfly2_torch.scheduler import resource as res
        from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
        from dragonfly2_torch.scheduler.service import SERVICE_NAME, SchedulerService
        from dragonfly2_torch.scheduler.storage import Storage

        self.cfg = cfg
        self.resource = res.Resource()
        self.storage = Storage(os.path.join(workdir, "sched"), buffer_size=1)
        self.evaluator = evaluator
        self.service = SchedulerService(
            self.resource,
            Scheduling(
                evaluator,
                SchedulingConfig(
                    retry_interval=0.0,
                    retry_back_to_source_limit=1,
                    candidate_parent_limit=cfg.candidate_parent_limit,
                ),
            ),
            storage=self.storage,
        )
        self.server, self.port = serve({SERVICE_NAME: self.service})

        if daemon_kwargs_fn is None:

            def daemon_kwargs_fn(i):
                slow = i < cfg.n_slow
                return {
                    "_slow": slow,
                    "upload_delay_s": cfg.slow_delay_s if slow else cfg.fast_delay_s,
                    "host_stats_override": dict(cfg.slow_stats if slow else cfg.fast_stats),
                }

        self.daemons = []
        self.slow_ids: set[str] = set()
        try:
            for i in range(cfg.n_daemons):
                overrides = dict(daemon_kwargs_fn(i))
                slow = overrides.pop("_slow", False)
                d = Daemon(
                    DaemonConfig(
                        data_dir=os.path.join(workdir, f"daemon-{i}"),
                        scheduler_address=f"127.0.0.1:{self.port}",
                        hostname=f"ab-host-{i}",
                        ip="127.0.0.1",
                        piece_length=cfg.piece_length,
                        schedule_timeout=10.0,
                        announce_interval=60.0,
                        collect_host_stats=False,
                        **overrides,
                    )
                )
                d.start()
                self.daemons.append(d)
                if slow:
                    self.slow_ids.add(d.host_id)
        except BaseException:
            self.stop()
            raise

    def stop(self) -> None:
        for d in self.daemons:
            d.stop()
        self.server.stop(0)


def _remote_piece_costs(cd, task_id: str, peer_host: dict, costs_ms: list, parents_of: "set[str]") -> tuple:
    """Fold one child's finished download into the phase's tallies →
    (pulls from remote peers, of them from a host in ``parents_of``)."""
    from dragonfly2_torch.client.piece_manager import TRAFFIC_REMOTE_PEER

    ts_c = cd.storage.find_completed_task(task_id)
    peer_host[ts_c.meta.peer_id] = cd.host_id
    pulls = hits = 0
    for p in ts_c.meta.pieces.values():
        if p.traffic_type != TRAFFIC_REMOTE_PEER:
            continue
        costs_ms.append(p.cost_ns / 1e6)
        pulls += 1
        if peer_host.get(p.parent_id) in parents_of:
            hits += 1
    return pulls, hits


def _phase_result(costs_ms: list, hits: int, pulls: int) -> PhaseResult:
    return PhaseResult(
        p50_ms=_percentile(costs_ms, 50),
        p90_ms=_percentile(costs_ms, 90),
        mean_ms=float(np.mean(costs_ms)) if costs_ms else 0.0,
        piece_count=len(costs_ms),
        slow_parent_fraction=hits / pulls if pulls else 0.0,
    )


def _run_workload(cluster: _Cluster, cfg: ABConfig, origins: list[str]) -> PhaseResult:
    """Same deterministic workload each phase: for each task, one seeder
    back-sources, then every other daemon downloads in seeded order.
    Measures client-observed remote-peer piece cost."""
    from dragonfly2_torch.client import dfget

    rng = random.Random(cfg.seed)
    peer_host: dict[str, str] = {}  # peer_id -> host_id for parent attribution
    costs_ms: list[float] = []
    slow_pulls = total_pulls = 0

    for t, url in enumerate(origins):
        order = list(range(cfg.n_daemons))
        rng.shuffle(order)
        seeder, children = order[0], order[1:]
        sd = cluster.daemons[seeder]
        dfget.download(f"127.0.0.1:{sd.port}", url, f"{sd.cfg.data_dir}/seed-{t}.bin")
        task_id = sd.task_manager.task_id_for(url, None)
        ts = sd.storage.find_completed_task(task_id)
        peer_host[ts.meta.peer_id] = sd.host_id

        for c in children:
            cd = cluster.daemons[c]
            dfget.download(f"127.0.0.1:{cd.port}", url, f"{cd.cfg.data_dir}/out-{t}.bin")
            pulls, hits = _remote_piece_costs(cd, task_id, peer_host, costs_ms, cluster.slow_ids)
            total_pulls += pulls
            slow_pulls += hits

    return _phase_result(costs_ms, slow_pulls, total_pulls)


def _train_and_activate(cluster: _Cluster, workdir: str, device="cuda"):
    """Records → announcer Train-stream upload → trainer service fit on
    ``device`` → CreateModel → activation — the PRODUCTION train path end
    to end, not an in-process shortcut. Returns the manager client (the
    serving loop's source of truth), its server and channel, and the MLP's
    evaluation."""
    import grpc

    from dragonfly2_torch.manager.database import Database
    from dragonfly2_torch.manager.models_registry import ModelRegistry
    from dragonfly2_torch.manager.objectstorage import FSObjectStorage
    from dragonfly2_torch.manager.service import ManagerGrpcClientAdapter, ManagerService
    from dragonfly2_torch.rpc import protos
    from dragonfly2_torch.rpc.glue import MANAGER_SERVICE, TRAINER_SERVICE, ServiceClient, dial, serve
    from dragonfly2_torch.scheduler.announcer import Announcer
    from dragonfly2_torch.trainer.service import TrainerService
    from dragonfly2_torch.trainer.storage import TrainerStorage
    from dragonfly2_torch.trainer.train import FitConfig
    from dragonfly2_torch.trainer.training import Training, TrainingConfig
    from dragonfly2_torch.utils.idgen import gru_model_id_v1, mlp_model_id_v1

    manager_pb2 = protos.load("manager_pb2")
    os.makedirs(workdir, exist_ok=True)

    # manager (model registry) — the serving side
    db = Database(os.path.join(workdir, "manager.db"))
    registry = ModelRegistry(db, FSObjectStorage(os.path.join(workdir, "objects")))
    server, port = serve({MANAGER_SERVICE: ManagerService(db, registry)})
    channel = dial(f"127.0.0.1:{port}")
    client = ServiceClient(channel, MANAGER_SERVICE)
    try:
        # trainer process surface: Train RPC → Training fit → CreateModel
        trainer_storage = TrainerStorage(os.path.join(workdir, "trainer"))
        training = Training(
            trainer_storage,
            manager_client=ManagerGrpcClientAdapter(channel),
            config=TrainingConfig(
                mlp=FitConfig(hidden_dims=(64, 64), batch_size=256, epochs=60, eval_fraction=0.15),
                # the harness produces no probe topology; the GNN leg is
                # expected to report "below min records" without gating MLP
                min_topology_records=10**9,
            ),
            device=device,
        )
        trainer_service = TrainerService(trainer_storage, training, synchronous=True)
        t_server, t_port = serve({TRAINER_SERVICE: trainer_service})

        # scheduler-side announcer streams the records it collected —
        # the same chunked Train upload production runs on a timer
        ip, hostname = "127.0.0.1", "ab-sched"
        cluster.storage.flush()
        trainer_channel = dial(f"127.0.0.1:{t_port}")
        announcer = Announcer(cluster.storage, ip=ip, hostname=hostname, trainer_channel=trainer_channel)
        try:
            uploaded = announcer.train_once()
        finally:
            trainer_channel.close()
            t_server.stop(0)
        if not uploaded:
            raise RuntimeError("announcer had no records to upload")

        model_id = mlp_model_id_v1(ip, hostname)
        model = client.GetModel(manager_pb2.GetModelRequest(model_id=model_id, version=1))
        metrics = {"mse": model.evaluation.mse, "mae": model.evaluation.mae}
        client.UpdateModel(manager_pb2.UpdateModelRequest(model_id=model_id, version=1, state="active"))
        # the GRU leg trains by default (TrainingConfig.gru); activate it
        # too when it produced a model (the bad-node scenario consumes it —
        # a too-small record set skips the leg without failing the MLP
        # path). ONLY NOT_FOUND is the benign skip; any other failure is a
        # real serving-loop regression and must fail the harness loudly.
        try:
            client.UpdateModel(
                manager_pb2.UpdateModelRequest(model_id=gru_model_id_v1(ip, hostname), version=1, state="active")
            )
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.NOT_FOUND:
                raise
            logger.info("no GRU model to activate (too few sequences)")
    except BaseException:
        channel.close()
        server.stop(0)
        raise
    return client, server, channel, metrics


def _record_installed(installed: "list | None", arm: str, evaluator) -> None:
    """Append ``(arm, kind, scorer)`` for each model the evaluator holds."""
    if installed is None:
        return
    for kind, scorer in (("mlp", evaluator._model), ("gru", evaluator._gru)):
        if scorer is not None:
            installed.append((arm, kind, scorer))


def run_ab(cfg: ABConfig | None = None, workdir: str | None = None, installed: "list | None" = None) -> dict:
    """Phase 1 under the default evaluator, a fit on its records, phase 2
    under the installed model. ``installed``, when a list, receives
    ``(arm, kind, scorer)`` for each model phase 2 runs."""
    from dragonfly2_torch.scheduler.evaluator import BaseEvaluator, MLEvaluator
    from dragonfly2_torch.scheduler.model_refresher import ModelRefresher

    cfg = cfg or ABConfig()
    if cfg.serving_backend not in ("torch", "off"):
        raise ValueError(f"serving_backend {cfg.serving_backend!r}: the port serves 'torch' or 'off'")
    resolve_device(cfg.device)  # a card asked for and missing raises before any phase runs
    workdir = workdir or tempfile.mkdtemp(prefix="dragonfly-ab-")
    rng = random.Random(cfg.seed)

    # shared origin payloads — identical workload in both phases
    origins = _make_origins(workdir, "shared", cfg.n_tasks, cfg.piece_length, cfg.pieces_per_task, rng)

    # ---- phase 1: default evaluator (also produces training data) ----
    logger.info("phase 1: default evaluator, %d daemons", cfg.n_daemons)
    c1 = _Cluster(cfg, BaseEvaluator(), os.path.join(workdir, "phase-default"))
    try:
        default_result = _run_workload(c1, cfg, origins)
        client, mgr_server, mgr_channel, metrics = _train_and_activate(
            c1, os.path.join(workdir, "manager"), device=cfg.device
        )
    finally:
        c1.stop()

    # ---- phase 2: ml evaluator fed through the real serving loop ----
    # The model rides the BATCHED scoring service unless serving_backend
    # == "off": the ModelRefresher installs into BOTH the per-call slot
    # and the serving slot, and the evaluator's top rung scores through
    # the service's micro-batches — the production serve path, measured
    # under real swarm traffic.
    logger.info("phase 2: ml evaluator (model via manager registry, serving=%s)", cfg.serving_backend)
    svc = None
    serving_snap: dict = {}
    # one outer finally owns the serving thread + manager plumbing: a
    # failed refresh (or cluster construction) must not leak the
    # scheduler.serving drain thread or the manager server
    try:
        if cfg.serving_backend != "off":
            from dragonfly2_torch.scheduler.serving import ScoringService, ServingConfig

            svc = ScoringService(ServingConfig())
            svc.start()
        evaluator = MLEvaluator(serving=svc)
        refresher = ModelRefresher(client, evaluator, scheduler_cluster_id=1, serving=svc, device=cfg.device)
        if not refresher.refresh_once():
            raise RuntimeError("model refresh failed — serving loop not closed")
        _record_installed(installed, "ml", evaluator)
        c2 = _Cluster(cfg, evaluator, os.path.join(workdir, "phase-ml"))
        try:
            ml_result = _run_workload(c2, cfg, origins)
        finally:
            c2.stop()
    finally:
        if svc is not None:
            serving_snap = svc.snapshot()
            svc.stop()
        mgr_channel.close()
        mgr_server.stop(0)
    if svc is not None and not serving_snap.get("batches"):
        # an idle service means phase 2 silently fell back to the
        # per-call rung — the comparison would no longer measure the
        # production serve path
        raise RuntimeError(f"batched scoring service unused in phase 2: {serving_snap}")

    out = {
        "p50_default_ms": round(default_result.p50_ms, 3),
        "p50_ml_ms": round(ml_result.p50_ms, 3),
        "p90_default_ms": round(default_result.p90_ms, 3),
        "p90_ml_ms": round(ml_result.p90_ms, 3),
        "slow_parent_fraction_default": round(default_result.slow_parent_fraction, 3),
        "slow_parent_fraction_ml": round(ml_result.slow_parent_fraction, 3),
        "pieces_default": default_result.piece_count,
        "pieces_ml": ml_result.piece_count,
        "mlp_eval_mse": round(metrics.get("mse", 0.0), 4),
        "ml_wins": ml_result.p50_ms < default_result.p50_ms,
    }
    if serving_snap:
        out["serving_backend"] = serving_snap.get("model_kind", "")
        out["serving_batches"] = serving_snap.get("batches", 0)
        out["serving_rows_scored"] = serving_snap.get("rows_scored", 0)
        out["evaluator_batch_occupancy"] = serving_snap.get("batch_occupancy", 0.0)
    return out


@dataclass
class GruABConfig:
    """Degrading-parent scenario: isolates the GRU bad-node leg. Every host
    announces IDENTICAL stats (the MLP ranking cannot separate them) and
    serves a benign cold-piece pattern (piece 0 slow — TCP slow start /
    cold cache). One host then degrades on both sides mid-scenario. The
    statistical bad-node rule is blind here: the benign cold spike
    inflates its per-peer mean, so sustained ~15x degradation stays under
    the 20x-mean threshold; the GRU learned the cold-piece schedule from
    phase-1 records, so off-schedule highs blow past its prediction
    margin and the parent gets filtered."""

    n_daemons: int = 6
    n_train_tasks: int = 8    # phase 1: records the GRU trains on
    n_measure_tasks: int = 5  # phase 2: identical workload per arm
    piece_length: int = 16 * 1024
    pieces_per_task: int = 6
    fast_delay_s: float = 0.002
    cold_piece_delay_s: float = 0.030  # benign: piece 0 only, every host
    degraded_delay_s: float = 0.030    # degradation: EVERY piece + own downloads
    candidate_parent_limit: int = 2
    seed: int = 11
    device: str = "cuda"
    stats: dict = field(
        default_factory=lambda: {"cpu.percent": 30.0, "memory.used_percent": 40.0}
    )


def _gru_run_workload(cluster: _Cluster, cfg: GruABConfig, origins: list[str]) -> PhaseResult:
    """Per task: a healthy seeder back-sources, the DEGRADED host (index
    0) downloads next — giving its peer the degraded cost history the
    detectors read — then the remaining hosts download. Measures the
    children's remote-peer piece costs and the fraction pulled from the
    degraded host."""
    from dragonfly2_torch.client import dfget

    peer_host: dict[str, str] = {}
    costs_ms: list[float] = []
    degraded_pulls = total_pulls = 0
    degraded = cluster.daemons[0]

    for t, url in enumerate(origins):
        seeder = cluster.daemons[1]
        dfget.download(f"127.0.0.1:{seeder.port}", url, f"{seeder.cfg.data_dir}/seed-{t}.bin")
        task_id = seeder.task_manager.task_id_for(url, None)
        ts = seeder.storage.find_completed_task(task_id)
        peer_host[ts.meta.peer_id] = seeder.host_id

        # degraded host downloads second: its peer history carries the
        # sustained-high pattern before any child asks for parents
        dfget.download(f"127.0.0.1:{degraded.port}", url, f"{degraded.cfg.data_dir}/own-{t}.bin")
        ts_d = degraded.storage.find_completed_task(task_id)
        peer_host[ts_d.meta.peer_id] = degraded.host_id

        for c in range(2, cfg.n_daemons):
            cd = cluster.daemons[c]
            dfget.download(f"127.0.0.1:{cd.port}", url, f"{cd.cfg.data_dir}/out-{t}.bin")
            pulls, hits = _remote_piece_costs(cd, task_id, peer_host, costs_ms, {degraded.host_id})
            total_pulls += pulls
            degraded_pulls += hits

    return _phase_result(costs_ms, degraded_pulls, total_pulls)


def run_gru_ab(
    cfg: GruABConfig | None = None, workdir: str | None = None, installed: "list | None" = None
) -> dict:
    """GRU-attributable A/B: identical degraded-parent workload under the
    ml evaluator WITHOUT the GRU (bad-node = base statistics) vs WITH it —
    the MLP ranking is shared by both arms, so any delta is the GRU's.
    ``installed``, when a list, receives ``(arm, kind, scorer)`` for each
    model an arm runs."""
    from dragonfly2_torch.scheduler.evaluator import BaseEvaluator, MLEvaluator
    from dragonfly2_torch.scheduler.model_refresher import ModelRefresher

    cfg = cfg or GruABConfig()
    resolve_device(cfg.device)
    workdir = workdir or tempfile.mkdtemp(prefix="dragonfly-ab-gru-")
    rng = random.Random(cfg.seed)

    ab = ABConfig(
        n_daemons=cfg.n_daemons,
        piece_length=cfg.piece_length,
        pieces_per_task=cfg.pieces_per_task,
        candidate_parent_limit=cfg.candidate_parent_limit,
        seed=cfg.seed,
        device=cfg.device,
    )

    def healthy_kwargs(i):
        return {
            "upload_delay_s": cfg.fast_delay_s,
            "upload_cold_piece_delay_s": cfg.cold_piece_delay_s,
            "host_stats_override": dict(cfg.stats),
        }

    def measure_kwargs(i):
        kw = healthy_kwargs(i)
        if i == 0:  # the degrading parent: slow serving AND slow own IO
            kw["_slow"] = True
            kw["upload_delay_s"] = cfg.degraded_delay_s
            kw["download_delay_s"] = cfg.degraded_delay_s
        return kw

    # ---- phase 1: healthy cluster produces the training records ----
    logger.info("gru phase 1: healthy cold-piece cluster, %d tasks", cfg.n_train_tasks)
    c1 = _Cluster(ab, BaseEvaluator(), os.path.join(workdir, "phase-train"), daemon_kwargs_fn=healthy_kwargs)
    try:
        train_origins = _make_origins(
            workdir, "train", cfg.n_train_tasks, cfg.piece_length, cfg.pieces_per_task, rng
        )
        _run_workload(c1, ab, train_origins)
        client, mgr_server, mgr_channel, _ = _train_and_activate(
            c1, os.path.join(workdir, "manager"), device=cfg.device
        )
    finally:
        c1.stop()

    measure_origins = _make_origins(
        workdir, "measure", cfg.n_measure_tasks, cfg.piece_length, cfg.pieces_per_task, rng
    )
    results = {}
    try:
        for arm in ("ml", "ml_gru"):
            evaluator = MLEvaluator()
            refresher = ModelRefresher(client, evaluator, scheduler_cluster_id=1, device=cfg.device)
            if not refresher.refresh_once():
                raise RuntimeError("model refresh failed")
            if arm == "ml":
                # ablation: same MLP ranking, bad-node back to statistics
                evaluator.set_gru(None)
            elif evaluator._gru is None:
                raise RuntimeError("no GRU installed — phase 1 produced too few sequences")
            _record_installed(installed, arm, evaluator)
            c = _Cluster(ab, evaluator, os.path.join(workdir, f"phase-{arm}"), daemon_kwargs_fn=measure_kwargs)
            try:
                results[arm] = _gru_run_workload(c, cfg, measure_origins)
            finally:
                c.stop()
    finally:
        mgr_channel.close()
        mgr_server.stop(0)

    ml, gru = results["ml"], results["ml_gru"]
    return {
        "scenario": "degrading-parent (benign cold-piece pattern)",
        "p50_ml_ms": round(ml.p50_ms, 3),
        "p50_ml_gru_ms": round(gru.p50_ms, 3),
        "p90_ml_ms": round(ml.p90_ms, 3),
        "p90_ml_gru_ms": round(gru.p90_ms, 3),
        "degraded_parent_fraction_ml": round(ml.slow_parent_fraction, 3),
        "degraded_parent_fraction_ml_gru": round(gru.slow_parent_fraction, 3),
        "pieces_ml": ml.piece_count,
        "pieces_ml_gru": gru.piece_count,
        "gru_wins": gru.p50_ms < ml.p50_ms and gru.slow_parent_fraction < ml.slow_parent_fraction,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="df-ab", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="the fits' and scorers' device: cuda (default) or cpu")
    args = p.parse_args(argv)
    out = run_ab(ABConfig(device=args.device))
    out["gru"] = run_gru_ab(GruABConfig(device=args.device))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
