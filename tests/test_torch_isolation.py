"""The port stands alone: no ``dragonfly2_torch`` module and not
``chip_smoke.py`` imports ``jax`` or anything of ``dragonfly2_tpu``, and
nothing on ``chip_smoke.py``'s import path imports ``grpc`` or
``google.protobuf``.

Checked statically, by parsing every source for its imports, and at run
time in subprocesses (this process already imported jax) whose import
system refuses the blocked packages: one imports every port module and
runs the five legs of ``chip_smoke.py`` and its encoder-gradient leg
(Ulysses over a one-rank gloo group) on the CPU at a tiny size (the
trainer leg feeds its Train stream through plain messages and uploads
through plain requests; the preheat leg's job goes out through a plain
request), then the server leg, whose scheduler and trainer servers talk
gRPC to the port's manager, push telemetry to its plane and serve /metrics,
and whose trained models are activated over the manager's REST front, then the resume phase's crash
drill (two spawned fits SIGKILLed by a fault rule), the federation
phase, the native phase and the mesh phase (a gloo group of one) and the
download leg (the cluster settings and the image preheat sent to the
manager's REST front, a seed peer and two peers of the port's daemons, a 2 MiB
origin, 64 KiB pieces, and images of 2 × 1 MiB layers pulled through the
daemons' registry proxies: the preheated one by one peer, a fresh one by
both at once; then a 1 MiB object written with dfstore through one
peer's object-storage gateway and read through the other's, whole and as
a range, and a 1 MiB object of an S3 stand-in pulled by both peers) and
the fleet leg (3 scheduler processes leased in the manager's embedded KV,
a seed peer and two peers, a 2 MiB origin, leases of 0.8 s: the owner of
the task SIGKILLed mid-burst and its swarm adopted by the successor, a
late peer served there, a second member SIGTERMed), and checks that the
native decoder it loaded is its own build; the other also refuses gRPC and protobuf, imports only
``chip_smoke`` and runs the five legs again, never the servers."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dragonfly2_torch"
BLOCKED = ("jax", "jaxlib", "dragonfly2_tpu")
# what the card's path does without: the refresher, the manager upload and
# the trainer service load their protobuf modules only when their default
# message factories are used
WIRE = ("grpc", "google.protobuf")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported(path: Path) -> "set[str]":
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_neither_jax_nor_the_reference(path):
    bad = {n for n in _imported(path) if n.split(".")[0] in BLOCKED}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {blocked!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"{{name}} is blocked in this process")
        return None

sys.meta_path.insert(0, Refuse())
for name in BLOCKED:
    sys.modules[name] = None  # a cached import would bypass the finder

import torch
torch.set_num_threads(1)
import dragonfly2_torch

mods = []
if {every_module!r}:
    mods = [m.name for m in pkgutil.walk_packages(dragonfly2_torch.__path__, "dragonfly2_torch.")]
    for m in mods:
        importlib.import_module(m)
import chip_smoke

serve = chip_smoke.serve_leg("cpu", hosts=64, probes=4, waves=(8, 5), repeats=1)
assert serve["rows"] == 40 and serve["edges"] == 256, serve
sched = chip_smoke.scheduler_leg(
    "cpu", hosts=64, probes=4, tasks=4, peers=16, wave_size=8, waves=3, warmup=1,
)
assert sched["decisions"] == 24 and sched["service_batches"] == 3, sched
assert sched["mean_candidates"] >= 8, sched
manager = chip_smoke._Manager()
train = chip_smoke.trainer_leg(
    "cpu", files=2, file_mib=1, hosts=128, probes=16, gnn_epochs=20, group_records=256,
    mlp_batch=256, gnn_batch=64, streaming_threshold_bytes=0, gru_max_sequences=2000,
    serve=dict(tasks=4, peers=16, wave_size=8, waves=2, warmup=1), manager=manager,
)
assert train["mlp"]["steps"] == 87 and train["gnn"]["edges"] == 2048, train
assert train["gru"]["sequences"] == 2000, train
assert train["serve"]["decisions"] == 16 and train["serve"]["kind"] == "gnn", train
heat = chip_smoke.preheat_leg(
    "cpu", manager, tasks=64, hot=4, hosts=128, probes=16, candidates=16, window_buckets=8,
)
assert heat["planned"] == 4 and len(manager.jobs) == 1, heat
enc = chip_smoke.encoder_leg(
    "cpu", batch=2, seq=40,
    cfg=dict(in_dim=2, model_dim=32, num_heads=4, num_layers=2),
)
assert enc["launches"] == 0 and enc["err"] < 5e-2, enc
grad = chip_smoke.encoder_grad_leg(
    "cpu", batch=2, seq=40, cfg=dict(in_dim=2, model_dim=32, num_heads=4, num_layers=2),
    dtype=torch.float32,
)
assert grad["launches_by"] == {{"sm90": 0, "tf32x3": 0, "bwd": 0, "bwd_sm90": 0, "bwd_tf32x3": 0}}, grad
assert grad["grad_rel_err"] < 1e-3 and grad["grad_rel_err_qk"] < 1e-3, grad
if {servers!r}:
    live = chip_smoke.server_leg(
        "cpu", hosts=128, probes=16, tasks=8, peers=64, concurrency=8, phase2=16,
        probe_rounds=4, mlp_batch=16, gnn_epochs=300,
    )
    assert live["edges"] == 2048 and live["phase1"]["decisions"] == 512, live
    assert live["phase2"]["decisions"] == 16 and live["phase2"]["served"] > 0, live
    assert set(live["telemetry"]) == {{"scheduler", "trainer"}}, live
    # three activations, the telemetry snapshot and the console, over REST
    assert live["rest"]["requests"] == 5 and live["rest"]["statuses"] == {{200: 5}}, live["rest"]
    drill = chip_smoke.resume_phase("cpu", hosts=64, probes=8, group_records=200, mlp_batch=64)
    assert drill["gnn"]["resumed_epochs"] == drill["mlp"]["resumed_epochs"] == 2, drill
    fed = chip_smoke.federation_phase(
        "cpu", group_records=200, shards=((80, "binary"), (60, "binary"), (40, "binary"), (20, "csv")), batch=32,
    )
    assert fed["hosts"] == 4 and fed["merge_rel_err"] <= 1e-6 and fed["csv_native"], fed
    nat = chip_smoke.native_phase(
        "cpu", file_mib=6, prefix_mib=1, hosts=64, probes=8, group_records=400, mlp_batch=128,
        streaming_threshold_bytes=0,
    )
    assert nat["streamed"] and nat["prefix_equal"] and nat["graph_equal"], nat
    mesh = chip_smoke.mesh_phase("cpu", hosts=128, probes=16, group_records=400, gnn_epochs=100)
    assert mesh["backend"] == "gloo" and mesh["embed_err"] <= 1e-5, mesh
    dl = chip_smoke.download_leg("cpu", peers=2, file_mib=2, piece_length=64 * 1024, layers=2, layer_mib=1,
                                 object_mib=1, s3_mib=1)
    assert dl["burst"]["origin_egress_x"] < 3 and dl["burst"]["demoted"] == 0, dl
    assert dl["records"] >= 2 and dl["preheat"]["layer_pull_origin_bytes"] == 0, dl
    # the cluster settings, the token's signup, promotion and minting, the
    # preheat job and its read-back, over REST
    assert dl["rest"]["requests"] == 7 and dl["rest"]["statuses"] == {{200: 7}}, dl["rest"]
    hot, fresh = dl["proxy_preheated"], dl["proxy_fresh"]
    assert hot["origin_blob_bytes"] == 0 and hot["routes"] == {{"p2p": 2, "direct": 2}}, dl
    assert fresh["origin_egress_x"] < 3 and fresh["routes"] == {{"p2p": 4, "direct": 4}}, dl
    assert hot["via_p2p"] == fresh["via_p2p"] == ["1"] and dl["proxy_decisions"] > 0, dl
    obj, s3 = dl["object"], dl["s3"]
    assert obj["reader_sha256"] == [obj["sha256"]] and obj["range_sha256"] == obj["range_want_sha256"], dl
    assert obj["via_p2p"] == ["1"] and obj["readers"] == 1, dl
    assert not any(obj["reader_origin_bytes"].values()) and not any(obj["fallbacks"].values()), dl
    assert obj["object_task_decisions"] > 0 and obj["demoted"] == 0, dl
    assert s3["peer_sha256"] == [s3["sha256"]] and s3["listed"] == 1, dl
    assert s3["egress_x"] < 3 and s3["refused"] == 0, dl
    assert s3["decisions"] > 0 and s3["demoted"] == 0, dl
    # the scheduler fleet: 3 scheduler processes, the owner SIGKILLed
    # mid-burst, a late peer served by the successor, one member SIGTERMed
    fl = chip_smoke.fleet_leg("cpu", peers=2, file_mib=2, piece_length=64 * 1024, lease_ttl=0.8, renew=0.2,
                              poll=0.15, piece_delay_ms=200)
    assert fl["kill"]["pulls_running"] == 1 and fl["adopt"]["peers"] >= 2, fl
    assert fl["late"]["from_peers_share"] >= 0.9 and fl["late"]["rungs"] == ["serving"], fl
    assert not fl["failover"]["resumes"].get("fallback") and fl["failover"]["blackouts"] >= 1, fl
    assert fl["sigterm_to_lease_gone_s"] < fl["lease_ttl"], fl
else:
    assert not any(n.startswith("dragonfly2_torch.scheduler.server") for n in sys.modules)
loaded = sorted(
    n for n in sys.modules
    if any(n == b or n.startswith(b + ".") for b in BLOCKED) and sys.modules[n] is not None
)
assert not loaded, loaded
# importing torch.distributed.tensor slows every small torch op in the
# process (the server leg's probe ingest doubled on the card): no port
# module may import it with the module
assert "torch.distributed.tensor" not in sys.modules
# the port decodes CSV with its own build of its own copy of the decoder,
# never the reference's native/build/libdfnative.so
from dragonfly2_torch.schema import native
assert native.available()
maps = open("/proc/self/maps").read()
assert "native/build" not in maps and str(native.library_path()) in maps
print("ISOLATED", len(mods))
"""


def _run_child(blocked, every_module: bool) -> int:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(blocked=blocked, every_module=every_module,
                                              servers=every_module)],
        cwd=str(REPO),
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("ISOLATED"), proc.stdout
    return int(last.split()[1])


def test_port_runs_with_jax_and_reference_blocked():
    # every module of the port was imported (92 with the scheduler and
    # trainer servers, 96 with the sequence-parallel plane, 101 with the
    # telemetry plane and federation, 104 with the native decoder and the
    # sharded trainer, 123 with the client, 136 with the manager, 137 with
    # the order-sweep tool, 139 with the registry proxy and its transport,
    # 142 with the cloud source clients, the object-storage gateway and
    # dfstore, 145 with the manager's REST front, auth and console, 147
    # with the RESP KV server and swarm replication)
    assert _run_child(BLOCKED, every_module=True) >= 147


def test_the_rest_front_loads_no_torch():
    """The manager binary starts without torch: its REST front, auth and
    console import neither torch nor, with them blocked, jax or the
    reference."""
    code = (
        "import sys\n"
        + _CHILD.split("import torch\n")[0].format(blocked=BLOCKED, every_module=False, servers=False)
        + "import dragonfly2_torch.manager.server, dragonfly2_torch.manager.rest\n"
        "import dragonfly2_torch.manager.auth, dragonfly2_torch.manager.console\n"
        "assert 'torch' not in sys.modules, sorted(n for n in sys.modules if n.startswith('torch'))\n"
        "print('NO TORCH')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "NO TORCH", proc.stdout + proc.stderr


def test_no_port_source_names_the_reference_build():
    for path in _sources() + sorted(PORT.rglob("*.cc")):
        assert "native/build" not in path.read_text(), path


def test_chip_smoke_runs_without_grpc_or_protobuf():
    assert _run_child(BLOCKED + WIRE, every_module=False) == 0

