"""The generated protobuf modules the port speaks (``rpc/gen/*_pb2.py``,
byte-identical copies of the reference's: each proto package is its
RPCs' wire name, and the default descriptor pool accepts an identical
file twice). Loaded on first use, so a path that builds plain request
records never imports protobuf."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_GEN = Path(__file__).resolve().parent / "gen"


def load(name: str):
    """The generated module ``rpc/gen/<name>.py`` (e.g. ``"trainer_pb2"``)."""
    full = f"dragonfly2_torch.rpc.gen.{name}"
    module = sys.modules.get(full)
    if module is None:
        spec = importlib.util.spec_from_file_location(full, _GEN / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[full] = module
    return module
