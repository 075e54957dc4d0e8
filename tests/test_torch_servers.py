"""The port's servers, live: ``SchedulerServer(algorithm="ml",
device="cpu")`` and ``TrainerServer(device="cpu")`` against the
reference's real in-process manager (registry, database, object store)
over gRPC.

- A port scheduler and a JAX scheduler, each installing the same npz MLP
  from the manager and fed the same hosts and probes, make the same
  decisions for the same scripted daemons (one stream at a time, under
  ``random.seed``), and write the same download records.
- A port ``Announcer`` uploads the port scheduler's records and probe
  snapshot to a port ``TrainerServer``, whose round lands three
  ``CreateModel`` (MLP, GNN, GRU) in the manager; once activated there,
  the port's refresher installs the new versions and the next decision is
  served by the GNN.
- Both servers start at their defaults with a manager (telemetry every
  15 s, pushed to the reference's telemetry plane), serve /metrics and
  /healthz on a scrape port, and the trainer stamps its fits' snapshot
  directory (``fleet_enabled`` is held to the reference's in
  ``tests/test_torch_fleet.py``); the binaries' ``build`` read configs."""

import gc
import json
import queue
import random
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from dragonfly2_torch.models.mlp import init_mlp
from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.scheduler import server as t_server
from dragonfly2_torch.trainer import server as t_trainer_server
from dragonfly2_torch.utils import profiling as t_profiling
from dragonfly2_torch.weights import serialize_params

from dragonfly2_tpu.manager.database import Database
from dragonfly2_tpu.manager.models_registry import ModelRegistry
from dragonfly2_tpu.manager.objectstorage import FSObjectStorage
from dragonfly2_tpu.manager.service import ManagerService
from dragonfly2_tpu.manager.telemetry import TelemetryPlane, TelemetryService
from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.scheduler import server as j_server
from dragonfly2_tpu.utils import profiling as j_profiling

torch.set_num_threads(1)

sp = protos.load("scheduler_pb2")
cp = protos.load("common_pb2")
mp = protos.load("manager_pb2")

HOSTS = 24
URL = "https://registry.example/v2/app/blobs/sha256:0001"


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # each package's servers start its process-wide stack sampler and leave
    # it running, as a server process would; stop both once the module is
    # done so their sweeps do not tax the files run after it in this process
    yield
    t_profiling.stop()
    j_profiling.stop()


@pytest.fixture
def manager(tmp_path):
    db = Database(tmp_path / "manager.db")
    registry = ModelRegistry(db, FSObjectStorage(tmp_path / "objects"))
    server, port = j_glue.serve({j_glue.MANAGER_SERVICE: ManagerService(db, registry)})
    addr = f"127.0.0.1:{port}"
    channel = j_glue.dial(addr)
    client = j_glue.ServiceClient(channel, j_glue.MANAGER_SERVICE)
    blob = serialize_params(init_mlp(torch.Generator().manual_seed(5), [19, 32, 32, 1]))
    client.CreateModel(mp.CreateModelRequest(model_id="mlp-npz", type="mlp", ip="10.0.0.1", hostname="t",
                                             weights=blob, scheduler_cluster_id=1))
    client.UpdateModel(mp.UpdateModelRequest(model_id="mlp-npz", version=1, state="active"))
    yield addr, client
    channel.close()
    server.stop(0)
    db.close()


def _config(cls, tmp_path, name, manager_addr, **kw):
    base = dict(data_dir=str(tmp_path / name), manager_address=manager_addr, algorithm="ml",
                telemetry_interval=0, model_refresh_interval=3600.0, job_poll_interval=3600.0,
                retry_interval=0.0, storage_buffer_size=1, hostname=f"sched-{name}", advertise_ip="10.0.0.9")
    base.update(kw)
    return cls(**base)


def _host(i):
    return cp.HostInfo(
        id=f"host-{i:02d}", type="super" if i == 0 else "normal", hostname=f"h{i}", ip=f"10.1.0.{i}",
        port=8002, download_port=8001, concurrent_upload_limit=50,
        cpu=cp.CpuStat(percent=float(3 * i % 100)), memory=cp.MemoryStat(used_percent=float(7 * i % 90)),
        network=cp.NetworkStat(idc=f"idc-{i % 3}", location=f"cn|r{i % 2}|z{i % 4}",
                               tcp_connection_count=11 * i, upload_tcp_connection_count=i),
        disk=cp.DiskStat(used_percent=float(5 * i % 90)),
    )


def _drive(addr, peers=12, pieces=8, seed=0, task="task-x"):
    """Hosts announce and probe, then a seed and ``peers`` children run
    their AnnouncePeer streams one at a time → each peer's decision."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 1, (HOSTS, 2))
    ch = t_glue.dial(addr)
    client = t_glue.ServiceClient(ch, t_glue.SCHEDULER_SERVICE)
    try:
        for i in range(HOSTS):
            client.AnnounceHost(sp.AnnounceHostRequest(host=_host(i)))
        for rnd in range(3):
            for i in range(HOSTS):
                dests = [(i + 1 + rnd * 5 + d) % HOSTS for d in range(5)]
                reqs = [sp.SyncProbesRequest(host=_host(i), probe_finished=sp.ProbeFinishedRequest(probes=[
                    sp.ProbeResult(host_id=f"host-{j:02d}",
                                   rtt_ns=int((1 + 80 * np.linalg.norm(coords[i] - coords[j])) * 1e6),
                                   created_at_ns=time.time_ns() - (3 - rnd) * 10**9)
                    for j in dests if j != i
                ]))]
                for _ in client.SyncProbes(iter(reqs)):
                    pass
        decisions = {}
        for k in range(peers + 1):
            hi, pid = (0, f"{task}-seed") if k == 0 else (k % (HOSTS - 1) + 1, f"{task}-child-{k:02d}")
            base = dict(host_id=f"host-{hi:02d}", task_id=task, peer_id=pid)
            q = queue.Queue()
            random.seed(k)  # the same candidate sample on both schedulers
            stream = client.AnnouncePeer(iter(q.get, None))
            q.put(sp.AnnouncePeerRequest(**base, register_peer=sp.RegisterPeerRequest(
                task_id=task, peer_id=pid, url=URL + task, need_back_to_source=(k == 0))))
            resp = next(stream)
            which = resp.WhichOneof("response")
            parents = [c.peer_id for c in resp.normal_task.candidate_parents]
            decisions[pid] = (which, parents)
            if which == "normal_task":
                q.put(sp.AnnouncePeerRequest(**base, download_peer_started=sp.DownloadPeerStartedRequest()))
            else:
                q.put(sp.AnnouncePeerRequest(
                    **base, download_peer_back_to_source_started=sp.DownloadPeerBackToSourceStartedRequest()))
            for n in range(pieces):
                src = parents[n % len(parents)] if parents else ""
                q.put(sp.AnnouncePeerRequest(**base, download_piece_finished=sp.DownloadPieceFinishedRequest(
                    piece=cp.PieceInfo(number=n, parent_id=src, offset=n << 20, length=1 << 20,
                                       traffic_type="remote_peer" if src else "back_to_source",
                                       cost_ns=int((4 + 3 * n + k) * 1e6), created_at_ns=1 + n))))
            q.put(sp.AnnouncePeerRequest(**base, download_peer_finished=sp.DownloadPeerFinishedRequest(
                content_length=pieces << 20, piece_count=pieces, cost_ns=10**9)))
            q.put(None)
            for _ in stream:
                pass
        return decisions
    finally:
        ch.close()


def _records(srv):
    srv.storage.flush()
    out = []
    for r in srv.storage.list_download():
        out.append((r.id, r.state, r.finished_piece_count, [(p.id, len(p.pieces)) for p in r.parents]))
    return sorted(out)


def test_port_and_reference_schedulers_decide_alike(manager, tmp_path):
    addr, _ = manager
    port = t_server.SchedulerServer(_config(t_server.SchedulerServerConfig, tmp_path, "port", addr, device="cpu"))
    ref = j_server.SchedulerServer(_config(j_server.SchedulerServerConfig, tmp_path, "ref", addr,
                                           topology_backend="numpy"))
    try:
        got_addr, want_addr = port.serve(), ref.serve()
        assert port.model_refresher.loaded_version == ("mlp-npz", 1)
        assert port.scoring_service.model_kind() == "mlp"
        got = _drive(got_addr)
        want = _drive(want_addr)
        assert got == want
        assert sum(w == "normal_task" for w, _ in got.values()) >= 10
        assert port.evaluator._rung == "serving"
        assert _records(port) == _records(ref)
    finally:
        port.stop()
        ref.stop()


def test_serving_scheduler_freezes_its_heap(manager, tmp_path):
    # the set-up heap leaves the cyclic collector's walk once the server
    # serves, and again every HEAP_FREEZE_INTERVAL_S; what serving adds in
    # between is still collected, and all of it comes back at stop
    addr, _ = manager
    srv = t_server.SchedulerServer(_config(t_server.SchedulerServerConfig, tmp_path, "port", addr, device="cpu"))
    base = gc.get_freeze_count()  # what the interpreter froze itself
    try:
        srv.serve()
        frozen = gc.get_freeze_count()
        assert frozen > base + 1000
        assert not any(o is srv.scoring_service for o in gc.get_objects())
        garbage = [[]]
        garbage[0].append(garbage)  # a cycle made while serving
        del garbage
        assert gc.collect() >= 2
        kept = [[] for _ in range(3)]  # state made while serving
        assert any(o is kept for o in gc.get_objects())
        srv.gc.run("heap-freeze")  # what the interval task does
        assert not any(o is kept for o in gc.get_objects())
    finally:
        srv.stop()
    assert gc.get_freeze_count() <= base


def test_announcer_round_lands_three_models_and_the_refresher_installs_them(manager, tmp_path):
    addr, mclient = manager
    trainer = t_trainer_server.TrainerServer(t_trainer_server.TrainerServerConfig(
        data_dir=str(tmp_path / "trainer"), manager_address=addr, device="cpu", telemetry_interval=0,
        synchronous=True, gnn_epochs=5, mlp_batch_size=64))
    trainer_addr = trainer.serve()
    srv = t_server.SchedulerServer(_config(t_server.SchedulerServerConfig, tmp_path, "port", addr,
                                           device="cpu", trainer_address=trainer_addr))
    try:
        _drive(srv.serve(), peers=16)
        assert srv.networktopology.snapshot() == HOSTS
        assert srv.announcer.train_once()
        models = {m.type: m for m in mclient.ListModels(mp.ListModelsRequest(scheduler_cluster_id=1)).models
                  if m.model_id != "mlp-npz"}
        assert sorted(models) == ["gnn", "gru", "mlp"]
        for m in models.values():
            mclient.UpdateModel(mp.UpdateModelRequest(model_id=m.model_id, version=m.version, state="active"))
        r = srv.model_refresher
        assert r.refresh_once()
        assert r.loaded_version == (models["mlp"].model_id, models["mlp"].version)
        assert r.loaded_gnn_version == (models["gnn"].model_id, models["gnn"].version)
        assert r.loaded_gru_version == (models["gru"].model_id, models["gru"].version)
        assert srv.scoring_service.model_kind() == "gnn"
        # a new task's children are scored by the installed GNN
        batches = srv.scoring_service.batches
        decided = _drive(f"127.0.0.1:{srv.port}", peers=3, seed=1, task="task-y")
        assert [w for w, _ in decided.values()] == ["need_back_to_source"] + ["normal_task"] * 3
        assert srv.scoring_service.batches > batches
    finally:
        srv.stop()
        trainer.stop()


@pytest.fixture
def shipped_manager(tmp_path):
    """The reference's manager as a deployment runs it: its model registry
    and its telemetry plane over gRPC."""
    db = Database(tmp_path / "manager.db")
    registry = ModelRegistry(db, FSObjectStorage(tmp_path / "objects"))
    plane = TelemetryPlane(slos=[])
    server, port = j_glue.serve({
        j_glue.MANAGER_SERVICE: ManagerService(db, registry),
        j_glue.TELEMETRY_SERVICE: TelemetryService(plane),
    })
    yield f"127.0.0.1:{port}", plane
    server.stop(0)
    db.close()


def _get(address, path, accept=None):
    req = urllib.request.Request(f"http://{address}{path}", headers={"Accept": accept} if accept else {})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def _check_option(srv, service, option, plane):
    """The option a shipped config turns on works on the started server."""
    if option == "metrics_port":
        status, ctype, body = _get(srv.metrics_addr, "/metrics")
        assert status == 200 and ctype == "text/plain; version=0.0.4"
        assert f'dragonfly_build_info{{service="{service}",' in body
        status, ctype, body = _get(srv.metrics_addr, "/metrics", accept="application/openmetrics-text")
        assert status == 200 and ctype.startswith("application/openmetrics-text") and body.endswith("# EOF\n")
        status, _, body = _get(srv.metrics_addr, "/healthz")
        assert status == 200 and json.loads(body)["services"] == {service: "ok"}
    elif option == "telemetry_interval":
        rep = srv.telemetry_reporter
        assert rep is not None and rep.interval == 15.0 and rep._thread.is_alive()
        assert rep.push_once() and rep.failures == 0
        folded = plane._reporters[(service, rep.instance)]
        assert folded.sections["build"]["service"] == service
        assert folded.sections["endpoints"]["metrics"] == srv.metrics_addr
        assert folded.last_seq == rep.seq and folded.epoch == rep.epoch
    else:  # checkpoint_dir: the round's fits snapshot under it, per model and host
        cfg = srv.training.config
        stamped = srv.training._fit_config(cfg.gnn, "gnn", "h")
        assert stamped.checkpoint_dir == str(Path(cfg.checkpoint_dir) / "gnn-h")


@pytest.mark.parametrize("option", ["metrics_port", "telemetry_interval"])
def test_shipped_scheduler_options_serve(option, shipped_manager, tmp_path):
    """A scheduler at its defaults (telemetry every 15 s) with a manager
    and a scrape port starts and serves."""
    addr, plane = shipped_manager
    cfg = t_server.SchedulerServerConfig(data_dir=str(tmp_path / "s"), device="cpu", manager_address=addr,
                                         metrics_port=0, model_refresh_interval=3600.0, job_poll_interval=3600.0)
    assert cfg.telemetry_interval == 15.0
    srv = t_server.SchedulerServer(cfg)
    srv.serve()
    try:
        _check_option(srv, "scheduler", option, plane)
    finally:
        srv.stop()


@pytest.mark.parametrize("option", ["metrics_port", "telemetry_interval", "checkpoint_dir"])
def test_shipped_trainer_options_serve(option, shipped_manager, tmp_path):
    """A trainer at its defaults with a manager, a scrape port and a
    snapshot directory starts and serves."""
    addr, plane = shipped_manager
    cfg = t_trainer_server.TrainerServerConfig(data_dir=str(tmp_path / "t"), device="cpu", manager_address=addr,
                                               metrics_port=0, checkpoint_dir=str(tmp_path / "snapshots"))
    assert cfg.telemetry_interval == 15.0
    srv = t_trainer_server.TrainerServer(cfg)
    srv.serve()
    try:
        _check_option(srv, "trainer", option, plane)
    finally:
        srv.stop()


def test_servers_default_to_the_card(tmp_path):
    assert t_server.SchedulerServerConfig().device == "cuda"
    assert t_trainer_server.TrainerServerConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default builds on it")
    with pytest.raises(Exception, match="(?i)cuda"):
        t_server.SchedulerServer(t_server.SchedulerServerConfig(data_dir=str(tmp_path / "s"), algorithm="ml"))
    with pytest.raises(Exception, match="(?i)cuda"):
        t_trainer_server.TrainerServer(t_trainer_server.TrainerServerConfig(data_dir=str(tmp_path / "t")))


def test_build_reads_config_and_overrides(tmp_path):
    conf = tmp_path / "scheduler.yaml"
    conf.write_text(f"data_dir: {tmp_path / 'd'}\nalgorithm: ml\ntopology_backend: \"off\"\n")
    srv = t_server.build(str(conf), {"device": "cpu", "retry_limit": 2})
    try:
        assert srv.cfg.algorithm == "ml" and srv.cfg.retry_limit == 2 and srv.topology_engine is None
    finally:
        srv.stop()
    tr = t_trainer_server.build(None, {"device": "cpu", "data_dir": str(tmp_path / "t"), "gnn_epochs": 3})
    assert tr.cfg.gnn_epochs == 3 and tr.training.device.type == "cpu"
    with pytest.raises(Exception, match="unknown config key"):
        t_server.build(None, {"no_such_field": 1})


@pytest.mark.parametrize("binary,sets", [
    ("scheduler", ["device=cpu", "algorithm=ml", "telemetry_interval=0"]),
    ("trainer", ["device=cpu", "telemetry_interval=0"]),
])
def test_binaries_serve_until_signalled(binary, sets, tmp_path):
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    args = [sys.executable, "-m", f"dragonfly2_torch.{binary}", "--listen", "127.0.0.1:0",
            "--set", f"data_dir={tmp_path / binary}"]
    for kv in sets:
        args += ["--set", kv]
    proc = subprocess.Popen(args, cwd=str(repo), env=dict(os.environ, PYTHONPATH=str(repo)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line or line.startswith("READY"):
                break
        assert line.startswith(f"READY {binary} 127.0.0.1:"), line
        addr = line.split()[2]
        ch = t_glue.dial(addr)
        diag = t_glue.ServiceClient(ch, t_glue.DIAGNOSE_SERVICE).Diagnose(
            protos.load("diagnose_pb2").DiagnoseRequest(include_stacks=False))
        ch.close()
        assert diag.pid == proc.pid
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
