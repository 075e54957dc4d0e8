"""Fit snapshots and resumable ingestion offsets (counterpart of the
reference's ``trainer/checkpoint.py``).

A fit loop given a ``checkpoint_dir`` snapshots (module state, optimizer
state, epoch) after every epoch and, restarted after a crash, resumes from
the newest snapshot: the per-epoch shuffle is seeded by (seed, epoch), so
an interrupted-and-resumed fit replays the uninterrupted one's schedule.
The reference writes its snapshots with orbax; this port writes its own
files with ``torch.save``, one per epoch, each through a temporary file
and ``os.replace``, so a process killed mid-save leaves the previous
snapshot whole.

Also here: resumable ingestion offsets. When a trainer runs incremental
rounds (``clear_after_train=False``), the byte offset consumed per dataset
file is committed after a successful fit, so the next round decodes only
newly appended upload rounds. The same ledger persists the per-file round
boundaries the Train stream marks.
"""

from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from dragonfly2_torch.utils import dflog

logger = dflog.get("trainer.ckpt")

_SNAPSHOT = re.compile(r"^epoch-(\d+)\.pt$")


def _to_cpu(tree: Any) -> Any:
    """A copy of ``tree`` (dicts, lists, tuples of tensors and scalars)
    with every tensor detached and copied to the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


class FitCheckpointer:
    """(module state dict, optimizer state, epoch) snapshots for one fit
    run, as ``<dir>/epoch-<k>.pt``; the newest ``max_to_keep`` stay.

    ``save`` copies the state to the host before it writes, so a snapshot
    holds CPU tensors whatever device the fit runs on; ``restore_latest``
    loads the newest one onto the fit's device."""

    def __init__(self, directory: str | Path, max_to_keep: int = 2):
        self._dir = Path(directory).resolve()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max(1, max_to_keep)

    @property
    def directory(self) -> Path:
        return self._dir

    def _epochs(self) -> list[int]:
        return sorted(
            int(m.group(1)) for m in map(_SNAPSHOT.match, os.listdir(self._dir)) if m
        )

    def _path(self, epoch: int) -> Path:
        return self._dir / f"epoch-{epoch}.pt"

    def save(self, epoch: int, state: Any) -> None:
        """Snapshot ``state`` after ``epoch`` (blocking — fit epochs are
        long compared to a snapshot write), then drop all but the newest
        ``max_to_keep``."""
        final = self._path(epoch)
        tmp = final.with_name(f".{final.name}.tmp")
        torch.save({"epoch": int(epoch), "state": _to_cpu(state)}, tmp)
        os.replace(tmp, final)
        for old in self._epochs()[: -self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def latest_epoch(self) -> int | None:
        epochs = self._epochs()
        return epochs[-1] if epochs else None

    def restore_latest(self, device="cpu") -> tuple[int, Any] | None:
        """→ (epoch, state) of the newest snapshot with its tensors on
        ``device``, or None when there is none."""
        epoch = self.latest_epoch()
        if epoch is None:
            return None
        return self.restore(epoch, device)

    def restore(self, epoch: int, device="cpu") -> tuple[int, Any]:
        """→ (epoch, state) of the snapshot taken after ``epoch``."""
        snap = torch.load(self._path(epoch), map_location=device, weights_only=True)
        return int(snap["epoch"]), snap["state"]

    def clear(self) -> None:
        """Delete every snapshot and the run's directory — called on
        successful fit completion so the next round trains fresh instead
        of resuming into zero epochs."""
        for name in os.listdir(self._dir):
            if _SNAPSHOT.match(name) or name.endswith(".pt.tmp"):
                (self._dir / name).unlink(missing_ok=True)
        try:
            self._dir.rmdir()
        except OSError:
            pass  # something else lives there: leave it


class OffsetLedger:
    """Byte offsets consumed per dataset file, committed only after a
    successful fit — a crashed round re-decodes from the previous commit
    (at-least-once ingestion; training is idempotent over a round)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._lock = threading.Lock()
        self._offsets: dict[str, int] = {}
        if self.path.exists():
            try:
                self._offsets = json.loads(self.path.read_text())
            except (OSError, json.JSONDecodeError) as e:
                logger.warning("offset ledger unreadable, starting fresh: %s", e)

    def get(self, key: str) -> int:
        with self._lock:
            return int(self._offsets.get(key, 0))

    def has(self, key: str) -> bool:
        """Whether an entry exists — callers that must distinguish "never
        committed" from "committed at 0" (round-boundary recovery) need
        more than get()'s 0 default."""
        with self._lock:
            return key in self._offsets

    def commit(self, key: str, offset: int) -> None:
        with self._lock:
            self._offsets[key] = int(offset)
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self._offsets, indent=0, sort_keys=True))
            tmp.replace(self.path)

    def reset(self, key: str) -> None:
        """Drop a file's offset (after the file itself is cleared)."""
        with self._lock:
            if key in self._offsets:
                del self._offsets[key]
                tmp = self.path.with_suffix(".tmp")
                tmp.write_text(json.dumps(self._offsets, indent=0, sort_keys=True))
                tmp.replace(self.path)


def _leaves(tree: Any) -> tuple[list, list]:
    """(leaves, structure) of a module, a state dict or a nested tree of
    dicts and lists, dict keys in sorted order (``jax.tree_util``'s)."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        leaves, struct = [], []
        for k in sorted(tree):
            sub_leaves, sub_struct = _leaves(tree[k])
            leaves += sub_leaves
            struct.append((k, sub_struct))
        return leaves, ("dict", struct)
    if isinstance(tree, (list, tuple)):
        leaves, struct = [], []
        for v in tree:
            sub_leaves, sub_struct = _leaves(v)
            leaves += sub_leaves
            struct.append(sub_struct)
        return leaves, ("list", struct)
    return [tree], None


def params_equal(a: Any, b: Any, atol: float = 0.0) -> bool:
    """Structural + numeric equality of two parameter trees (modules,
    state dicts or nested dicts/lists of tensors or arrays), by
    ``np.allclose`` with its default rtol, as the reference's helper for
    resume-reproducibility checks."""
    la, ta = _leaves(a)
    lb, tb = _leaves(b)
    if ta != tb or len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if not np.allclose(x, y, atol=atol):
            return False
    return True
