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
gRPC; the other also refuses gRPC and protobuf, imports only
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
assert grad["launches_by"] == {{"sm90": 0, "tf32x3": 0, "bwd": 0, "bwd_sm90": 0}}, grad
assert grad["grad_rel_err"] < 1e-3 and grad["grad_rel_err_qk"] < 1e-3, grad
if {servers!r}:
    live = chip_smoke.server_leg(
        "cpu", hosts=128, probes=16, tasks=8, peers=64, concurrency=8, phase2=16,
        probe_rounds=4, mlp_batch=16, gnn_epochs=300,
    )
    assert live["edges"] == 2048 and live["phase1"]["decisions"] == 512, live
    assert live["phase2"]["decisions"] == 16 and live["phase2"]["served"] > 0, live
else:
    assert not any(n.startswith("dragonfly2_torch.scheduler.server") for n in sys.modules)
loaded = sorted(
    n for n in sys.modules
    if any(n == b or n.startswith(b + ".") for b in BLOCKED) and sys.modules[n] is not None
)
assert not loaded, loaded
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
    # trainer servers, 96 with the sequence-parallel plane)
    assert _run_child(BLOCKED, every_module=True) >= 96


def test_chip_smoke_runs_without_grpc_or_protobuf():
    assert _run_child(BLOCKED + WIRE, every_module=False) == 0

