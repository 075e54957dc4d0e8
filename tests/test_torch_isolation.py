"""The port stands alone: no ``dragonfly2_torch`` module and not
``chip_smoke.py`` imports ``jax`` or anything of ``dragonfly2_tpu``, and
nothing on ``chip_smoke.py``'s import path imports ``grpc`` or
``google.protobuf``.

Checked statically, by parsing every source for its imports, and at run
time in subprocesses (this process already imported jax) whose import
system refuses the blocked packages: one imports every port module and
runs the three legs of ``chip_smoke.py`` on the CPU at a tiny size; the
other also refuses gRPC and protobuf, imports only ``chip_smoke`` and runs
the three legs again."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dragonfly2_torch"
BLOCKED = ("jax", "jaxlib", "dragonfly2_tpu")
# what the card's path does without: the refresher loads the manager's
# protobuf module only when its default request factory is used
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
enc = chip_smoke.encoder_leg(
    "cpu", batch=2, seq=40,
    cfg=dict(in_dim=2, model_dim=32, num_heads=4, num_layers=2),
)
assert enc["launches"] == 0 and enc["err"] < 5e-2, enc
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
        [sys.executable, "-c", _CHILD.format(blocked=blocked, every_module=every_module)],
        cwd=str(REPO),
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("ISOLATED"), proc.stdout
    return int(last.split()[1])


def test_port_runs_with_jax_and_reference_blocked():
    # every module of the port was imported (47 with the scheduler slice)
    assert _run_child(BLOCKED, every_module=True) >= 47


def test_chip_smoke_runs_without_grpc_or_protobuf():
    assert _run_child(BLOCKED + WIRE, every_module=False) == 0

