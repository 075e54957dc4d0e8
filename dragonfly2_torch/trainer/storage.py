"""Trainer storage: per-source-host dataset files (counterpart of the
reference's ``trainer/storage.py``; upstream trainer/storage/storage.go).

The Train stream appends raw chunks under the uploading scheduler's
hostID, one file per dataset AND payload format:

- ``download_<hostID>.csv`` / ``networktopology_<hostID>.csv`` — the CSV
  fallback (old schedulers);
- ``download_<hostID>.dfb`` / ``networktopology_<hostID>.dfb`` — the
  binary columnar block stream (``schema/wire.py``). Blocks are
  self-delimiting, so chunked appends are always a valid stream.

The files are byte-identical to the reference's for the same stream.
"""

from __future__ import annotations

import threading
from pathlib import Path

import csv

from dragonfly2_torch.schema import records as R
from dragonfly2_torch.trainer.checkpoint import OffsetLedger


class TrainerStorage:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        # byte offsets consumed per dataset file (incremental rounds)
        self.offsets = OffsetLedger(self.dir / "offsets.json")
        # last complete upload-round boundary per file (marked by the Train
        # service at stream EOF, read under the same lock appends hold) —
        # offsets committed here can never land mid-record/mid-block.
        # PERSISTED: truncate_to_round consults this after a failed
        # stream, and an in-memory-only map would make a restart + one
        # failed upload destroy every previously-accumulated round.
        self.rounds = OffsetLedger(self.dir / "rounds.json")
        # files whose tail has been verified clean this process —
        # crash-mid-stream recovery (see _ensure_clean_tail)
        self._tail_checked: set[str] = set()

    def download_path(self, host_id: str) -> Path:
        return self.dir / f"download_{host_id}.csv"

    def network_topology_path(self, host_id: str) -> Path:
        return self.dir / f"networktopology_{host_id}.csv"

    def download_blocks_path(self, host_id: str) -> Path:
        return self.dir / f"download_{host_id}.dfb"

    def network_topology_blocks_path(self, host_id: str) -> Path:
        return self.dir / f"networktopology_{host_id}.dfb"

    def _round_files(self, host_id: str) -> list[Path]:
        return [
            self.download_path(host_id),
            self.network_topology_path(host_id),
            self.download_blocks_path(host_id),
            self.network_topology_blocks_path(host_id),
        ]

    # -- stream append (Train RPC demux target) ---------------------------
    def _safe_boundary(self, path: Path) -> int:
        """The byte count worth keeping after a failed/interrupted
        stream: the persisted round boundary when one exists (bytes past
        it are a partial round the announcer's retry re-ships), else a
        content-derived parse-safe cut — the SAME rule for in-process
        failures (truncate_to_round) and crash recovery
        (_ensure_clean_tail), so neither path keeps half-rounds the
        other would drop."""
        if self.rounds.has(path.name):
            return self.rounds.get(path.name)
        return self._content_boundary(path)

    def _ensure_clean_tail(self, path: Path) -> None:
        """Once per file per process, before the first append: drop any
        partial tail a PREVIOUS process left by dying mid-stream (the
        in-process failure path runs truncate_to_round, but a killed
        trainer never does). Without this, appending complete data after
        a torn block poisons the file forever — the torn block's length
        prefix points into the new bytes — and even block-complete
        half-rounds would be double-trained once the retry re-ships
        them. Called under ``self._lock``."""
        if path.name in self._tail_checked:
            return
        self._tail_checked.add(path.name)
        if not path.exists():
            return
        good = self._safe_boundary(path)
        if good < path.stat().st_size:
            with open(path, "ab") as f:
                f.truncate(good)
        if good == 0:
            path.unlink(missing_ok=True)

    def _append(self, path: Path, chunk: bytes) -> None:
        with self._lock:
            self._ensure_clean_tail(path)
            with open(path, "ab") as f:
                f.write(chunk)

    def append_download(self, host_id: str, chunk: bytes) -> None:
        self._append(self.download_path(host_id), chunk)

    def append_network_topology(self, host_id: str, chunk: bytes) -> None:
        self._append(self.network_topology_path(host_id), chunk)

    def append_download_blocks(self, host_id: str, chunk: bytes) -> None:
        self._append(self.download_blocks_path(host_id), chunk)

    def append_network_topology_blocks(self, host_id: str, chunk: bytes) -> None:
        self._append(self.network_topology_blocks_path(host_id), chunk)

    # -- reads ------------------------------------------------------------
    def list_download(self, host_id: str) -> list[R.DownloadRecord]:
        return list(self._iter_concatenated(self.download_path(host_id), R.DownloadRecord))

    def list_network_topology(self, host_id: str) -> list[R.NetworkTopologyRecord]:
        return list(
            self._iter_concatenated(
                self.network_topology_path(host_id), R.NetworkTopologyRecord
            )
        )

    def iter_download_chunks(
        self,
        host_id: str,
        chunk_records: int = 50_000,
        max_bytes: int | None = None,
    ):
        """Yield lists of ≤ ``chunk_records`` DownloadRecords — the
        bounded-memory read of an arbitrarily large dataset file (the
        MLP leg's CSV path reads through it). ``max_bytes`` stops the read at a
        record-aligned byte boundary (pass a committed round boundary):
        this generator stays open across long extraction pauses, so
        without a bound a concurrent Train-stream append could be read
        mid-write as a torn trailing row."""
        chunk: list = []
        for rec in self._iter_concatenated(
            self.download_path(host_id), R.DownloadRecord, max_bytes=max_bytes
        ):
            chunk.append(rec)
            if len(chunk) >= chunk_records:
                yield chunk
                chunk = []
        if chunk:
            yield chunk

    @staticmethod
    def _iter_concatenated(path: Path, cls: type, max_bytes: int | None = None):
        """Parse a file made of appended CSV uploads: every upload round
        (and every rotated backup within a round) starts with its own
        header line, so embedded headers must be skipped, not parsed as
        data rows. A generator so callers can bound memory. With
        ``max_bytes``, only lines that END at or before that offset are
        parsed — callers pass a record-aligned boundary, so no torn or
        in-flight trailing data is ever decoded."""
        if not path.exists():
            return
        with open(path, "rb") as bf:
            def lines():
                consumed = 0
                for raw in bf:
                    consumed += len(raw)
                    if max_bytes is not None and consumed > max_bytes:
                        return
                    yield raw.decode("utf-8", errors="replace")

            reader = csv.reader(lines())
            header: list[str] | None = None
            for row in reader:
                if header is None:
                    header = row
                    continue
                # embedded header from a later upload/backup — match on
                # the first column name, not the whole row, so a header
                # that drifted between scheduler versions is re-adopted
                # instead of being parsed as a data row against stale
                # column positions
                if row and header and row[0] == header[0]:
                    header = row
                    continue
                yield R.unflatten(cls, dict(zip(header, row)))

    def host_ids(self) -> list[str]:
        """Every host with at least one dataset file (the FedAvg shards),
        whichever payload format it uploaded in."""
        ids = set()
        for pattern, prefix in (
            ("download_*.csv", "download_"),
            ("networktopology_*.csv", "networktopology_"),
            ("download_*.dfb", "download_"),
            ("networktopology_*.dfb", "networktopology_"),
        ):
            for p in self.dir.glob(pattern):
                ids.add(p.stem.removeprefix(prefix))
        return sorted(ids)

    # -- resumable ingestion offsets --------------------------------------
    @staticmethod
    def _offset_key(host_id: str, binary: bool) -> str:
        return f"download_blocks_{host_id}" if binary else f"download_{host_id}"

    def download_offset(self, host_id: str, binary: bool = False) -> int:
        return self.offsets.get(self._offset_key(host_id, binary))

    def commit_download_offset(
        self, host_id: str, offset: int, binary: bool = False
    ) -> None:
        self.offsets.commit(self._offset_key(host_id, binary), offset)

    def mark_download_round(self, host_id: str) -> int:
        """Record the current size of every dataset file for this host as
        a round boundary — called by the Train service once a stream
        finishes, so boundaries always sit between complete uploads (and,
        for the binary files, between complete blocks). Returns the
        download boundary of the binary file when it has data, else of
        the CSV file — the same preference order the fits use."""
        with self._lock:
            for path in self._round_files(host_id):
                size = path.stat().st_size if path.exists() else 0
                self.rounds.commit(path.name, size)
            bpath = self.download_blocks_path(host_id)
            if bpath.exists() and bpath.stat().st_size:
                return self.rounds.get(bpath.name)
            return self.rounds.get(self.download_path(host_id).name)

    def download_round_boundary(self, host_id: str, binary: bool = False) -> int:
        """Last marked round boundary; falls back to a locked size stat
        (direct-API callers that never interleave appends with training)."""
        path = (
            self.download_blocks_path(host_id)
            if binary
            else self.download_path(host_id)
        )
        return self._boundary_of(path)

    def network_topology_round_boundary(self, host_id: str, binary: bool = False) -> int:
        path = (
            self.network_topology_blocks_path(host_id)
            if binary
            else self.network_topology_path(host_id)
        )
        return self._boundary_of(path)

    def _boundary_of(self, path: Path) -> int:
        with self._lock:
            if self.rounds.has(path.name):
                return self.rounds.get(path.name)
            return path.stat().st_size if path.exists() else 0

    @staticmethod
    def _content_boundary(path: Path) -> int:
        """A parse-safe cut point derived from file CONTENT — the
        recovery fallback when no round boundary was ever persisted
        (ledger predates the file, or was lost): the end of the last
        complete block for ``.dfb``, the byte after the last newline for
        CSV. Data before it decodes cleanly; it may include complete
        chunks of the failed stream, which the announcer's retry then
        re-ships (at-least-once, same as the offset ledger's contract)."""
        if path.suffix == ".dfb":
            from dragonfly2_torch.schema import wire

            try:
                extents = wire.scan_block_extents(path)
            except Exception:
                return 0  # leading corruption: nothing salvageable
            return extents[-1][1] if extents else 0
        # CSV: last newline at EVEN RFC4180 quote parity — a newline
        # inside a quoted field is data (the reference's native
        # decoder splits files by the same rule), and cutting there would leave a
        # dangling open quote that swallows every later append into one
        # giant field. One forward streaming pass, bounded memory
        # (bytes.count/rfind are memchr-speed; this runs only in the
        # rare recovery path).
        last_even_nl = 0
        quotes = 0
        pos = 0
        chunk_size = 1 << 20
        with open(path, "rb") as f:
            while True:
                chunk = f.read(chunk_size)
                if not chunk:
                    break
                at = len(chunk)
                while True:
                    nl = chunk.rfind(b"\n", 0, at)
                    if nl < 0:
                        break
                    if (quotes + chunk.count(b'"', 0, nl)) % 2 == 0:
                        last_even_nl = pos + nl + 1
                        break
                    at = nl
                quotes += chunk.count(b'"')
                pos += len(chunk)
        return last_even_nl

    def truncate_to_round(self, host_id: str) -> None:
        """Drop the partial tail of a FAILED Train stream: every dataset
        file is cut back to its last persisted round boundary — or, when
        none was ever recorded for it, to a content-derived parse-safe
        point. Without this, the next successful upload would append
        complete data AFTER a torn half-round — which a CSV read
        mis-parses as one garbage row and a block scan cannot get past
        at all (the torn block's length prefix points into the new
        data)."""
        with self._lock:
            for path in self._round_files(host_id):
                if not path.exists():
                    continue
                boundary = self._safe_boundary(path)
                if path.stat().st_size > boundary:
                    with open(path, "ab") as f:
                        f.truncate(boundary)
                if boundary == 0:
                    path.unlink(missing_ok=True)

    # -- cleanup ----------------------------------------------------------
    def clear_download(self, host_id: str, binary: "bool | None" = None) -> None:
        """Drop consumed download data. ``binary=None`` clears both
        payload forms; True/False clears only that form — the training
        round clears exactly what its MLP leg consumed, so a host that
        switched formats keeps its other-era records for the next round
        instead of losing them."""
        targets = {
            None: (self.download_path(host_id), self.download_blocks_path(host_id)),
            False: (self.download_path(host_id),),
            True: (self.download_blocks_path(host_id),),
        }[binary]
        for p in targets:
            p.unlink(missing_ok=True)
            self.rounds.reset(p.name)
        if binary in (None, False):
            self.offsets.reset(self._offset_key(host_id, binary=False))
        if binary in (None, True):
            self.offsets.reset(self._offset_key(host_id, binary=True))

    def clear_network_topology(self, host_id: str) -> None:
        for p in (
            self.network_topology_path(host_id),
            self.network_topology_blocks_path(host_id),
        ):
            p.unlink(missing_ok=True)
            self.rounds.reset(p.name)
        self.offsets.reset(f"networktopology_{host_id}")

    def clear(self) -> None:
        for host_id in self.host_ids():
            self.clear_download(host_id)
            self.clear_network_topology(host_id)
