"""Columnar layout of training records (counterpart of the reference's
``schema/columnar.py``, without its npz block codec).

``records_to_columns`` transposes records into one numpy array per dotted
column; fixed-width repeated groups land as one column per slot
(``parents.3.host.cpu.percent``). The feature extractors and the wire
format both consume that layout.

The scheduler's record sinks share one rotation/snapshot mechanic:

- **CSV** (``RotatingCSVWriter``) — the interoperability/debugging form,
  with size-based rotation and bounded backups; also the negotiated
  train-stream fallback for trainers that do not take binary blocks.
- **binary columnar blocks** (``RotatingBlockWriter``, format in
  ``schema/wire.py``) — the train-stream payload: each flush encodes the
  buffered record batch into one self-delimiting block with the training
  tensors precomputed.
"""

from __future__ import annotations

import csv
import os
import re
from pathlib import Path
from typing import Any, Iterable, Sequence

import numpy as np

from dragonfly2_torch.schema import records as R


def write_csv(path: str | os.PathLike, recs: Sequence[Any], append: bool = False) -> None:
    if not recs:
        return
    cls = type(recs[0])
    cols = R.headers(cls)
    exists = os.path.exists(path) and os.path.getsize(path) > 0
    mode = "a" if append else "w"
    with open(path, mode, newline="") as f:
        # restval="" + skip_padding: padding list slots serialize as EMPTY
        # cells, not "0"s — 4-parent rows shrink ~32% (5.8K→4.0K bytes)
        # and the native decoder's empty-slot fast-forward / tail
        # short-circuit skip them wholesale (~28% higher records/s decode
        # measured standalone). unflatten treats trailing all-empty
        # elements as padding, so the roundtrip is lossless.
        w = csv.DictWriter(f, fieldnames=cols, restval="")
        if not (append and exists):
            w.writeheader()
        for rec in recs:
            w.writerow(R.flatten(rec, skip_padding=True))


def read_csv(path: str | os.PathLike, cls: type) -> list[Any]:
    out = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out.append(R.unflatten(cls, row))
    return out


class _RotatingSink:
    """Shared rotation/snapshot mechanics for the record sinks.

    Reference semantics (scheduler/storage/storage.go): the active file
    is ``<base>.<suffix>``; on exceeding ``max_size`` bytes it rotates to
    ``<base>-<n>.<suffix>`` and at most ``max_backups`` rotated files are
    kept (oldest dropped). ``buffer_size`` records are batched per flush;
    subclasses define how a batch lands on disk (``_write_batch``).
    """

    suffix = "dat"

    def __init__(
        self,
        directory: str | os.PathLike,
        base: str,
        max_size: int = 100 * 1024 * 1024,
        max_backups: int = 10,
        buffer_size: int = 64,
    ):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.base = base
        self.max_size = max_size
        self.max_backups = max_backups
        self.buffer_size = max(1, buffer_size)
        self._buf: list[Any] = []

    @property
    def active_path(self) -> Path:
        return self.dir / f"{self.base}.{self.suffix}"

    def create(self, *recs: Any) -> None:
        """Queue records; flush when the buffer fills."""
        self._buf.extend(recs)
        if len(self._buf) >= self.buffer_size:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        if self.active_path.exists() and self.active_path.stat().st_size >= self.max_size:
            self._rotate()
        self._write_batch(self._buf)
        self._buf.clear()

    def _write_batch(self, recs: list[Any]) -> None:
        raise NotImplementedError

    def _rotate(self) -> None:
        nums = sorted(self._backup_numbers())
        nxt = (nums[-1] + 1) if nums else 1
        self.active_path.rename(self.dir / f"{self.base}-{nxt}.{self.suffix}")
        nums.append(nxt)
        while len(nums) > self.max_backups:
            oldest = nums.pop(0)
            (self.dir / f"{self.base}-{oldest}.{self.suffix}").unlink(missing_ok=True)

    def _backup_numbers(self) -> list[int]:
        pat = re.compile(rf"^{re.escape(self.base)}-(\d+)\.{re.escape(self.suffix)}$")
        out = []
        for p in self.dir.iterdir():
            m = pat.match(p.name)
            if m:
                out.append(int(m.group(1)))
        return out

    def backups(self) -> list[Path]:
        return [
            self.dir / f"{self.base}-{n}.{self.suffix}"
            for n in sorted(self._backup_numbers())
        ]

    def all_files(self) -> list[Path]:
        files = self.backups()
        if self.active_path.exists():
            files.append(self.active_path)
        return files

    def snapshot(self, dest_dir: str | os.PathLike) -> list[Path]:
        """Move every current file into ``dest_dir`` and start fresh.

        Records written after this call land in a new active file, so an
        upload consuming the snapshot can't race (and then destroy)
        records appended during a slow transfer. Files are renamed with a
        unique prefix so repeated snapshots into the same pending dir
        (retry after a failed upload) never collide.
        """
        self.flush()
        dest = Path(dest_dir)
        dest.mkdir(parents=True, exist_ok=True)
        existing = len(list(dest.iterdir()))
        moved: list[Path] = []
        for i, p in enumerate(self.all_files()):
            target = dest / f"{existing + i:06d}-{p.name}"
            p.rename(target)
            moved.append(target)
        return sorted(dest.iterdir())

    def clear(self) -> None:
        self._buf.clear()
        for p in self.all_files():
            p.unlink(missing_ok=True)


class RotatingCSVWriter(_RotatingSink):
    """Size-rotated CSV sink with bounded backups — the
    reference-compatible / debugging form of the record stream."""

    suffix = "csv"

    def __init__(
        self,
        directory: str | os.PathLike,
        base: str,
        record_cls: type,
        max_size: int = 100 * 1024 * 1024,
        max_backups: int = 10,
        buffer_size: int = 64,
    ):
        super().__init__(directory, base, max_size, max_backups, buffer_size)
        self.record_cls = record_cls

    def _write_batch(self, recs: list[Any]) -> None:
        write_csv(self.active_path, recs, append=True)

    def read_all(self) -> list[Any]:
        self.flush()
        out: list[Any] = []
        for p in self.all_files():
            out.extend(read_csv(p, self.record_cls))
        return out


class RotatingBlockWriter(_RotatingSink):
    """Size-rotated binary columnar sink (schema/wire.py blocks) — the
    train-stream payload. Each flush encodes the buffered record batch
    into ONE self-delimiting block appended to the active file, so the
    per-record cost of tensor extraction is amortized over the batch and
    the announcer can ship the files verbatim (blocks concatenate)."""

    suffix = "dfb"

    def __init__(
        self,
        directory: str | os.PathLike,
        base: str,
        encoder,
        max_size: int = 100 * 1024 * 1024,
        max_backups: int = 10,
        buffer_size: int = 64,
    ):
        super().__init__(directory, base, max_size, max_backups, buffer_size)
        self.encoder = encoder  # list[record] -> block bytes
        self.encode_failures = 0

    def _write_batch(self, recs: list[Any]) -> None:
        # an encode failure (a poisoned record breaking tensor
        # extraction) must not take down the scheduler's record-creation
        # hot path: drop the batch LOUDLY and count it. The loss is
        # real — when the announcer ships the binary payload it discards
        # the parallel CSV snapshot unshipped, so these records never
        # reach the trainer in either form. That trade (lose one batch
        # of training data vs crash the serving path on a code bug in
        # extraction) is deliberate; encode_failures > 0 is the alarm.
        try:
            block = self.encoder(recs)
        except Exception:
            self.encode_failures += 1
            from dragonfly2_torch.utils import dflog

            dflog.get("columnar").exception(
                "block encode failed; dropping %d records from the binary sink",
                len(recs),
            )
            return
        with open(self.active_path, "ab") as f:
            f.write(block)


def records_to_columns(recs: Sequence[Any]) -> dict[str, np.ndarray]:
    """Transpose records into one array per dotted column.

    Numeric columns become float64/int64 arrays; string columns become numpy
    unicode arrays. Repeated groups are already fixed-width after
    ``flatten`` so every column has length N.
    """
    if not recs:
        return {}
    flats = [R.flatten(r) for r in recs]
    cols: dict[str, np.ndarray] = {}
    for key in flats[0]:
        vals = [f[key] for f in flats]
        cols[key] = np.asarray(vals)
    return cols


def num_rows(cols: dict[str, np.ndarray]) -> int:
    if not cols:
        return 0
    return len(next(iter(cols.values())))


def concat_columns(blocks: Iterable[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    blocks = [b for b in blocks if b]
    if not blocks:
        return {}
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks], axis=0) for k in keys}
