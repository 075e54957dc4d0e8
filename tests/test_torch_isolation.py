"""The port stands alone: no ``dragonfly2_torch`` module and not
``chip_smoke.py`` imports ``jax`` or anything of ``dragonfly2_tpu``.

Checked twice: statically, by parsing every source for its imports; and
at run time, in a subprocess (this process already imported jax) whose
import system refuses both packages, where every port module is imported
and both legs of ``chip_smoke.py`` run on the CPU at a tiny size."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "dragonfly2_torch"
BLOCKED = ("jax", "jaxlib", "dragonfly2_tpu")


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
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{{name}} is blocked in this process")
        return None

sys.meta_path.insert(0, Refuse())
for name in BLOCKED:
    sys.modules[name] = None  # a cached import would bypass the finder

import torch
torch.set_num_threads(1)
import dragonfly2_torch

mods = [m.name for m in pkgutil.walk_packages(dragonfly2_torch.__path__, "dragonfly2_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke

serve = chip_smoke.serve_leg("cpu", hosts=64, probes=4, waves=(8, 5), repeats=1)
assert serve["rows"] == 40 and serve["edges"] == 256, serve
enc = chip_smoke.encoder_leg(
    "cpu", batch=2, seq=40,
    cfg=dict(in_dim=2, model_dim=32, num_heads=4, num_layers=2),
)
assert enc["launches"] == 0 and enc["err"] < 5e-2, enc
loaded = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED and sys.modules[n] is not None)
assert not loaded, loaded
print("ISOLATED", len(mods))
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(blocked=BLOCKED)],
        cwd=str(REPO),
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("ISOLATED"), proc.stdout
    assert int(last.split()[1]) >= 15  # every module of the port was imported
