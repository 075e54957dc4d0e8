"""The train→serve loop through the port's own manager, on the CPU.

A port ``TrainerServer`` and a port ``SchedulerServer(algorithm="ml",
device="cpu")`` run against the port's ``ManagerServer`` over gRPC, and
the same servers run again against the reference's ``ManagerService``:

1. a seeded MLP is uploaded and lands inactive; the refresher's poll
   installs nothing until ``UpdateModel(state="active")``, and the next
   poll installs it;
2. a seeded wave of children (``tests/test_torch_servers.py``'s scripted
   daemons, one stream at a time under ``random.seed``) is ranked on it;
3. the announcer uploads the wave's records and probe snapshot to the
   trainer, whose fits land three ``CreateModel`` — inactive again, so a
   poll installs nothing; once the three are activated the next poll
   installs them, and a second seeded wave is ranked on the trained GNN.

Every response the daemons get — each decision's ranked parents — must be
the same under either manager, at ``tests/test_torch_servers.py``'s
limits (equal), and so must the uploaded weights and what was installed
when."""

import pytest
import torch

from dragonfly2_torch.manager import server as t_mserver
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
from dragonfly2_tpu.rpc import glue as j_glue
from test_torch_servers import HOSTS, _config, _drive

torch.set_num_threads(1)

mp = protos.load("manager_pb2")


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    yield
    t_profiling.stop()


def _port_manager(root):
    srv = t_mserver.ManagerServer(t_mserver.ManagerServerConfig(data_dir=str(root), issue_certs=False))
    return srv.serve(), srv.stop


def _reference_manager(root):
    root.mkdir(parents=True)
    db = Database(root / "manager.db")
    server, port = j_glue.serve({j_glue.MANAGER_SERVICE: ManagerService(db, ModelRegistry(
        db, FSObjectStorage(root / "objects")))})

    def stop():
        server.stop(0)
        db.close()

    return f"127.0.0.1:{port}", stop


def _loop(tmp_path, make_manager):
    """The whole loop against one manager → what the daemons and the
    operator saw."""
    addr, stop_manager = make_manager(tmp_path / "manager")
    channel = t_glue.dial(addr)
    ops = t_glue.ServiceClient(channel, t_glue.MANAGER_SERVICE)
    trainer = srv = None
    seen = {}
    try:
        blob = serialize_params(init_mlp(torch.Generator().manual_seed(5), [19, 32, 32, 1]))
        up = ops.CreateModel(mp.CreateModelRequest(model_id="mlp-npz", type="mlp", ip="10.0.0.1", hostname="t",
                                                   weights=blob, scheduler_cluster_id=1))
        seen["seed_upload"] = (up.version, up.state)
        trainer = t_trainer_server.TrainerServer(t_trainer_server.TrainerServerConfig(
            data_dir=str(tmp_path / "trainer"), manager_address=addr, device="cpu", telemetry_interval=0,
            synchronous=True, gnn_epochs=5, mlp_batch_size=64))
        trainer_addr = trainer.serve()
        srv = t_server.SchedulerServer(_config(t_server.SchedulerServerConfig, tmp_path, "port", addr,
                                               device="cpu", trainer_address=trainer_addr))
        sched_addr = srv.serve()
        r = srv.model_refresher
        # 1. the gate: nothing installed until the operator activates
        seen["before_activation"] = (r.loaded_version, r.refresh_once(), r.loaded_version,
                                     srv.scoring_service.model_kind())
        ops.UpdateModel(mp.UpdateModelRequest(model_id="mlp-npz", version=1, state="active"))
        seen["after_activation"] = (r.refresh_once(), r.loaded_version, srv.scoring_service.model_kind())
        # 2. a seeded wave on the seeded MLP
        seen["wave1"] = _drive(sched_addr, peers=16)
        seen["rung1"] = srv.evaluator._rung
        # 3. the trainer's uploads land inactive, then are activated
        assert srv.networktopology.snapshot() == HOSTS
        assert srv.announcer.train_once()
        models = {m.type: m for m in ops.ListModels(mp.ListModelsRequest(scheduler_cluster_id=1)).models
                  if m.model_id != "mlp-npz"}
        seen["uploads"] = sorted((t, m.version, m.state) for t, m in models.items())
        seen["weights"] = {t: ops.GetModelWeights(mp.GetModelRequest(model_id=m.model_id, version=m.version)).weights
                           for t, m in models.items()}
        seen["inactive_poll"] = (r.refresh_once(), r.loaded_version, r.loaded_gnn_version, r.loaded_gru_version)
        for m in models.values():
            ops.UpdateModel(mp.UpdateModelRequest(model_id=m.model_id, version=m.version, state="active"))
        seen["active_poll"] = (r.refresh_once(), r.loaded_version, r.loaded_gnn_version, r.loaded_gru_version,
                               srv.scoring_service.model_kind())
        batches = srv.scoring_service.batches
        seen["wave2"] = _drive(sched_addr, peers=3, seed=1, task="task-y")
        seen["served_by_gnn"] = srv.scoring_service.batches > batches and srv.scoring_service.model_kind() == "gnn"
        return seen
    finally:
        if srv is not None:
            srv.stop()
        if trainer is not None:
            trainer.stop()
        channel.close()
        stop_manager()


def test_the_loop_through_the_port_manager_ranks_as_with_the_reference(tmp_path):
    got = _loop(tmp_path / "torch", _port_manager)
    want = _loop(tmp_path / "jax", _reference_manager)
    assert got == want
    assert got["seed_upload"] == (1, "inactive")
    assert got["before_activation"] == (None, False, None, "")  # no model holds the serving slot
    assert got["after_activation"] == (True, ("mlp-npz", 1), "mlp")
    assert sum(w == "normal_task" for w, _ in got["wave1"].values()) >= 10 and got["rung1"] == "serving"
    assert got["uploads"] == [("gnn", 1, "inactive"), ("gru", 1, "inactive"), ("mlp", 1, "inactive")]
    assert got["inactive_poll"] == (False, ("mlp-npz", 1), None, None)
    installed, mlp, gnn, gru, kind = got["active_poll"]
    assert installed and kind == "gnn" and mlp != ("mlp-npz", 1) and mlp[1] == gnn[1] == gru[1] == 1
    assert [w for w, _ in got["wave2"].values()] == ["need_back_to_source"] + ["normal_task"] * 3
    assert got["served_by_gnn"]
