"""Piece-level disk store for the peer daemon.

Counterpart of the reference's ``client/storage.py``.

Role parity: upstream client/daemon/storage/storage_manager.go:52-962 +
local_storage.go — RegisterTask/WritePiece/ReadPiece/ReadAllPieces/Store/
GetPieces with per-task metadata persisted next to the data file, md5
piece verification, and a disk-usage reclaimer wired into the GC
framework (upstream storage_manager.go:80-89).

Layout: ``<data_dir>/<task_id[:3]>/<task_id>/{data,metadata.json}`` —
pieces are written at their offsets into one sparse data file, so a
completed task is a byte-identical copy of the origin object and
``store()`` can hardlink it out.

Content-addressed dedup (docs/data-plane.md): the manager keeps a
digest-keyed :class:`PieceIndex` over every stored piece. A second task
writing a piece whose digest (and length) is already held records a
*reference* instead of duplicating the bytes — its ``PieceMeta.ref_task``
marks the bytes as living in another task's data file, and every read
path (``piece_span``/``read_piece``/``read_range``/``read_all``/serve)
resolves the reference through the index. References are refcounted:
deleting the owning task first *migrates* each still-referenced piece's
bytes into one of the referring tasks (which becomes the new owner), so
shared bytes survive any single task's GC and are reclaimed only when
the last referent goes.
"""

# dfanalyze: hot — write_piece/piece_span run per piece on the data plane

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import asdict, dataclass, field

from dragonfly2_torch.client import metrics as M
from dragonfly2_torch.utils import dflog, flight, flows
from dragonfly2_torch.utils.digest import md5_from_bytes

logger = dflog.get("client.storage")

# flight event: a GC-time owner migration — rare, load-bearing for the
# dedup plane's correctness story, worth a permanent ring entry
EV_DEDUP_MIGRATE = flight.event_type("daemon.dedup_migrate")

_COPY_CHUNK = 1 << 20


@dataclass
class PieceMeta:
    number: int
    offset: int
    length: int
    digest: str = ""  # "md5:<hex>"
    traffic_type: str = ""
    cost_ns: int = 0
    parent_id: str = ""
    # content-addressed reference: non-empty = the bytes live in another
    # task's data file (the task id that owned them at dedup time —
    # provenance only; reads resolve the CURRENT owner via the index)
    ref_task: str = ""


@dataclass
class TaskMeta:
    task_id: str
    peer_id: str
    url: str = ""
    tag: str = ""
    application: str = ""
    content_length: int = -1
    total_piece_count: int = -1
    piece_length: int = 0
    done: bool = False
    access_time: float = field(default_factory=time.time)
    # minimal origin response headers (Content-Type at least), replayed
    # by the P2P transport so proxy clients see proper metadata
    headers: dict[str, str] = field(default_factory=dict)
    pieces: dict[int, PieceMeta] = field(default_factory=dict)

    def to_json(self) -> dict:
        d = asdict(self)
        d["pieces"] = {str(k): asdict(v) for k, v in self.pieces.items()}
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TaskMeta":
        pieces = {int(k): PieceMeta(**v) for k, v in d.pop("pieces", {}).items()}
        return cls(**{**d, "pieces": pieces})


class PieceIndex:
    """Digest-keyed index over every stored piece: which tasks hold the
    bytes physically (*holders*) and which merely reference them
    (*refs*). The refcount for GC purposes is holders + refs; bytes are
    reclaimable only when both hit zero. A leaf lock — never held while
    a task or manager lock is acquired."""

    def __init__(self):
        self._lock = threading.Lock()
        # digest -> (length, holders: set[(task_id, number)],
        #            refs: set[(task_id, number)])
        self._entries: dict[str, tuple[int, set, set]] = {}

    def find_holder(self, digest: str, length: int, exclude_task: str = ""):
        """→ (task_id, number) of a physical holder, or None. Length
        participates so a (theoretical) digest collision of differing
        sizes never aliases."""
        with self._lock:
            e = self._entries.get(digest)
            if e is None or e[0] != length:
                return None
            for task_id, number in e[1]:
                if task_id != exclude_task:
                    return (task_id, number)
            return None

    def record_holder(self, digest: str, length: int, task_id: str, number: int) -> None:
        with self._lock:
            e = self._entries.get(digest)
            if e is None or e[0] != length:
                e = self._entries[digest] = (length, set(), set())
            e[1].add((task_id, number))
            e[2].discard((task_id, number))

    def record_ref(self, digest: str, length: int, task_id: str, number: int) -> None:
        with self._lock:
            e = self._entries.get(digest)
            if e is None or e[0] != length:
                # a ref with no holder entry (crash-recovery edge): keep
                # the entry so drop/resolve see a consistent shape;
                # resolution will fail and the caller refetches
                e = self._entries[digest] = (length, set(), set())
            e[2].add((task_id, number))

    def add_ref_if_held(
        self, digest: str, length: int, task_id: str, number: int
    ):
        """Atomic find-holder + record-ref under ONE index lock — the
        write path's dedup decision. A separate find-then-record pair
        would leave a window where the holder's GC sees no referent and
        reclaims the only copy of bytes a ref is about to point at.
        → the holder (task_id, number) or None (caller writes bytes)."""
        with self._lock:
            e = self._entries.get(digest)
            if e is None or e[0] != length:
                return None
            for holder in e[1]:
                if holder[0] != task_id:
                    e[2].add((task_id, number))
                    return holder
            return None

    def orphaned_by(self, task_id: str) -> list[tuple[str, int, int]]:
        """Digests whose ONLY holders belong to ``task_id`` but that
        other tasks still reference → [(digest, number, length)]: the
        migration work list for deleting ``task_id``."""
        out = []
        with self._lock:
            for digest, (length, holders, refs) in self._entries.items():
                mine = [h for h in holders if h[0] == task_id]
                if not mine or any(h[0] != task_id for h in holders):
                    continue
                if any(r[0] != task_id for r in refs):
                    out.append((digest, mine[0][1], length))
        return out

    def referrers(self, digest: str, exclude_task: str = "") -> list[tuple[str, int]]:
        with self._lock:
            e = self._entries.get(digest)
            if e is None:
                return []
            return [r for r in e[2] if r[0] != exclude_task]

    def drop_task(self, task_id: str) -> list[str]:
        """Remove every entry of ``task_id``. Returns digests STRANDED
        by the removal — still referenced by other tasks but now
        holder-less (a ref recorded between the caller's migration scan
        and this drop): the caller must run one more migration pass for
        them while the bytes are still on disk."""
        stranded = []
        with self._lock:
            dead = []
            for digest, (_, holders, refs) in self._entries.items():
                held_here = any(h[0] == task_id for h in holders)
                holders.difference_update({h for h in holders if h[0] == task_id})
                refs.difference_update({r for r in refs if r[0] == task_id})
                if not holders and not refs:
                    dead.append(digest)
                elif held_here and not holders and refs:
                    stranded.append(digest)
            for digest in dead:
                del self._entries[digest]
        return stranded

    def stats(self) -> dict:
        with self._lock:
            holders = sum(len(e[1]) for e in self._entries.values())
            refs = sum(len(e[2]) for e in self._entries.values())
            return {"digests": len(self._entries), "holders": holders, "refs": refs}


class TaskStorage:
    """One task's on-disk state: sparse data file + metadata."""

    PERSIST_EVERY = 64  # pieces between metadata flushes on the hot path

    def __init__(self, task_dir: str, meta: TaskMeta, manager: "StorageManager | None" = None):
        self.dir = task_dir
        self.meta = meta
        self.lock = threading.RLock()
        self._dirty_pieces = 0
        # a live conductor owns this task (not persisted: after a crash
        # nothing is live, so orphans become reclaimable)
        self.busy = False
        # backref for content-addressed ref resolution; None for
        # standalone (test) construction — dedup is then inert
        self._sm = manager
        # cached count of ref pieces: the read paths take the stitched
        # (slower) route only when nonzero
        self._ref_count = sum(1 for p in meta.pieces.values() if p.ref_task)
        # cached write handle: one open() per piece write measured ~10%
        # of the small-piece write wall; closed on done/delete
        self._wf = None
        os.makedirs(task_dir, exist_ok=True)
        self.data_path = os.path.join(task_dir, "data")
        self.meta_path = os.path.join(task_dir, "metadata.json")
        if not os.path.exists(self.data_path):
            open(self.data_path, "wb").close()

    def persist(self) -> None:
        tmp = self.meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.meta.to_json(), f)
        os.replace(tmp, self.meta_path)

    def _write_handle(self):
        if self._wf is None or self._wf.closed:
            self._wf = open(self.data_path, "r+b")
        return self._wf

    def _close_write_handle(self) -> None:
        if self._wf is not None:
            try:
                self._wf.close()
            except OSError:
                pass
            self._wf = None

    def write_piece(
        self,
        number: int,
        offset: int,
        data: bytes,
        digest: str = "",
        traffic_type: str = "",
        cost_ns: int = 0,
        parent_id: str = "",
    ) -> PieceMeta:
        """Write piece bytes at their offset; verifies md5 when a digest
        is given (advisory ``io.md5`` strategy, upstream
        storage_manager.go digest handling). When the manager's
        content-addressed index already holds identical bytes, a
        reference is recorded instead of a second physical copy."""
        if digest:
            got = f"md5:{md5_from_bytes(data)}"
            if got != digest:
                raise StorageError(
                    f"piece {number} digest mismatch: want {digest} got {got}"
                )
        else:
            digest = f"md5:{md5_from_bytes(data)}"
        M.PIECE_DOWNLOADED_TOTAL.labels(traffic_type or "unknown").inc()
        M.PIECE_TRAFFIC_BYTES.labels(traffic_type or "unknown").inc(len(data))
        sm = self._sm
        dedup = sm is not None and sm.dedup_enabled and bool(data)
        with self.lock:
            holder = (
                # find + record in ONE index transaction (and under our
                # task lock, so GC migration — which takes referrer
                # locks — always sees the ref AND its piece meta
                # together): a plain find-then-record would race the
                # holder's delete into bytes stored nowhere
                sm.piece_index.add_ref_if_held(
                    digest, len(data), self.meta.task_id, number
                )
                if dedup
                else None
            )
            if holder is not None:
                M.PIECE_DEDUP_TOTAL.inc()
                M.PIECE_DEDUP_BYTES.inc(len(data))
            else:
                f = self._write_handle()
                f.seek(offset)
                f.write(data)
                f.flush()
                if dedup:
                    sm.piece_index.record_holder(
                        digest, len(data), self.meta.task_id, number
                    )
            pm = PieceMeta(
                number=number,
                offset=offset,
                length=len(data),
                digest=digest,
                traffic_type=traffic_type,
                cost_ns=cost_ns,
                parent_id=parent_id,
                ref_task=holder[0] if holder is not None else "",
            )
            prev = self.meta.pieces.get(number)
            if prev is not None and prev.ref_task and not pm.ref_task:
                self._ref_count -= 1
            if pm.ref_task and (prev is None or not prev.ref_task):
                self._ref_count += 1
            self.meta.pieces[number] = pm
            self.meta.access_time = time.time()
            # amortize metadata persistence: the full JSON rewrite is
            # O(pieces), so flushing per piece would make the hot path
            # O(n²) and skew cost_ns labels; a crash loses at most the
            # last PERSIST_EVERY piece *metadata* entries (bytes are on
            # disk; unlisted pieces are re-fetched on resume)
            self._dirty_pieces += 1
            if self._dirty_pieces >= self.PERSIST_EVERY:
                self._dirty_pieces = 0
                self.persist()
        # Flow-ledger attribution (outside the task lock): this is the
        # single acquisition choke point, and the classes are exclusive
        # — a piece is a dedup ref, a parent transfer, or an origin
        # read, never two — which is what makes per-plane byte
        # conservation checkable. "local_peer" imports are skipped: the
        # bytes were already on this host, nothing was acquired.
        if data and traffic_type != "local_peer":
            if holder is not None:
                prov = "dedup"
            elif traffic_type == "remote_peer":
                prov = "parent"
            elif traffic_type == "back_to_source":
                prov = (
                    "preheat" if flows.is_preheat(self.meta.task_id) else "origin"
                )
            else:
                prov = ""
            if prov:
                flows.account(flows.task_plane(self.meta.task_id), prov, len(data))
        return pm

    # ------------------------------------------------------------------
    # span-resolving reads: the zero-copy serve path asks WHERE bytes
    # live instead of materializing them (docs/data-plane.md)
    # ------------------------------------------------------------------
    def piece_span(self, number: int) -> tuple[str, int, int, str]:
        """→ (path, offset, length, digest) of the piece's bytes,
        resolving content-addressed references to the current physical
        holder. The upload server sendfiles straight from this span."""
        with self.lock:
            pm = self.meta.pieces.get(number)
            if pm is None:
                raise StorageError(f"piece {number} not found in {self.meta.task_id}")
            self.meta.access_time = time.time()
            if not pm.ref_task:
                return self.data_path, pm.offset, pm.length, pm.digest
            digest, length = pm.digest, pm.length
        if self._sm is None:
            raise StorageError(
                f"piece {number} is a dedup ref but no manager is attached"
            )
        span = self._sm.resolve_piece(digest, length, exclude_task=self.meta.task_id)
        if span is None:
            raise StorageError(
                f"piece {number} dedup source for {digest} vanished"
            )
        return span[0], span[1], length, digest

    def range_spans(self, offset: int, length: int) -> list[tuple[str | None, int, int]]:
        """Byte range [offset, offset+length) as a list of
        ``(path, file_offset, n)`` spans; ``path=None`` marks a sparse
        hole (read as zeros). Clamped to the current end-of-data, so a
        still-downloading task yields what exists — the same short-read
        semantics the raw sparse-file read had."""
        if length <= 0:
            return []
        with self.lock:
            self.meta.access_time = time.time()
            if not self._ref_count:
                try:
                    size = os.path.getsize(self.data_path)
                except OSError:
                    size = 0
                n = max(0, min(length, size - offset))
                return [(self.data_path, offset, n)] if n else []
            pieces = sorted(self.meta.pieces.values(), key=lambda p: p.offset)
        spans: list[tuple[str | None, int, int]] = []
        end = offset + length
        pos = offset
        for pm in pieces:
            if pm.offset + pm.length <= pos or pm.offset >= end:
                continue
            if pm.offset > pos:
                gap_end = min(pm.offset, end)
                spans.append((None, 0, gap_end - pos))
                pos = gap_end
            lo, hi = max(pos, pm.offset), min(end, pm.offset + pm.length)
            path, poff, _, _ = self.piece_span(pm.number)
            spans.append((path, poff + (lo - pm.offset), hi - lo))
            pos = hi
        return spans

    def current_end(self) -> int:
        """Highest byte written so far — the honest end-of-data for an
        open-ended Range on a task whose content_length is unknown."""
        with self.lock:
            if self.meta.pieces:
                return max(p.offset + p.length for p in self.meta.pieces.values())
            try:
                return os.path.getsize(self.data_path)
            except OSError:
                return 0

    def read_piece(self, number: int) -> bytes:
        path, off, length, _ = self.piece_span(number)
        with open(path, "rb") as f:
            f.seek(off)
            return f.read(length)

    def read_range(self, offset: int, length: int) -> bytes:
        out = bytearray()
        for path, off, n in self.range_spans(offset, length):
            if path is None:
                out += bytes(n)
            else:
                with open(path, "rb") as f:
                    f.seek(off)
                    out += f.read(n)
        return bytes(out)

    def read_all(self) -> bytes:
        with self.lock:
            if not self.meta.done:
                raise StorageError(f"task {self.meta.task_id} is not complete")
            size = self.meta.content_length
            if size < 0:
                size = self.current_end()
        return self.read_range(0, size)

    def verify_content_digest(self, expected: str) -> None:
        """Whole-task digest check against UrlMeta.digest ('sha256:…' /
        'md5:…'), hashed streaming so large tasks never materialize in
        RAM. The upstream declares this check but left it TODO
        (peertask_conductor.go:607). For a RANGE task the pin covers the
        slice (the task's content IS the slice). The hash runs with the
        storage lock released — the task is complete and its data file
        immutable, and holding the lock would stall every peer this
        daemon is serving for the duration."""
        algorithm, want = _parse_digest(expected)
        h = _hashlib.new(algorithm)
        with self.lock:
            length = self.meta.content_length
        if length < 0:
            length = self.current_end()
        for path, off, n in self.range_spans(0, length):
            if path is None:
                zeros = bytes(min(n, _COPY_CHUNK))
                left = n
                while left > 0:
                    step = min(left, _COPY_CHUNK)
                    h.update(zeros[:step])
                    left -= step
                continue
            with open(path, "rb") as f:
                f.seek(off)
                left = n
                while left > 0:
                    chunk = f.read(min(left, _COPY_CHUNK))
                    if not chunk:
                        break
                    h.update(chunk)
                    left -= len(chunk)
        if h.hexdigest() != want.lower():
            raise StorageError(
                f"task {self.meta.task_id} content digest mismatch:"
                f" want {expected}, got {algorithm}:{h.hexdigest()}"
            )

    def mark_done(
        self, content_length: int | None = None, expected_digest: str = ""
    ) -> None:
        """Complete the task. With ``expected_digest`` the content is
        verified FIRST and ``done`` only ever flips on a match — a
        concurrent reuse lookup (which requires done) can never observe
        unverified pinned content, no matter how long the hash takes.
        On mismatch the stored pieces are purged (a retry must
        re-download, not re-fail on the same bytes) and StorageError
        raises."""
        with self.lock:
            if content_length is not None:
                self.meta.content_length = content_length
            if self.meta.content_length >= 0:
                # truncate to exact length (last piece may have been
                # written into a sparse hole). Dedup refs live in holes
                # by design — the truncation only bounds physical bytes.
                self._close_write_handle()
                with open(self.data_path, "r+b") as f:
                    f.truncate(self.meta.content_length)
        if expected_digest:
            try:
                self.verify_content_digest(expected_digest)
            except StorageError:
                self.purge_pieces()
                raise
        with self.lock:
            self.meta.done = True
            self.meta.total_piece_count = len(self.meta.pieces)
            self._close_write_handle()
            self.persist()

    def purge_pieces(self) -> None:
        """Drop every stored piece (verification-failure path). Bytes
        other tasks reference are migrated out FIRST so a purge can
        never strand a dedup referent — migration runs before this
        task's lock is taken (cross-task lock nesting stays one-way)."""
        if self._sm is not None:
            self._sm.release_task_bytes(self)
        with self.lock:
            self.meta.pieces.clear()
            self.meta.total_piece_count = 0
            self._ref_count = 0
            self._close_write_handle()
            open(self.data_path, "wb").close()  # drop the bytes
            self.persist()

    def store(self, dest: str) -> None:
        """Hardlink-or-copy the completed data file to ``dest``
        (upstream dfget output handling). A task carrying dedup
        references materializes — its sparse file alone is not the
        content."""
        with self.lock:
            if not self.meta.done:
                raise StorageError(f"task {self.meta.task_id} is not complete")
            has_refs = bool(self._ref_count)
            size = self.meta.content_length
        os.makedirs(os.path.dirname(os.path.abspath(dest)) or ".", exist_ok=True)
        if os.path.exists(dest):
            os.remove(dest)
        if not has_refs:
            try:
                os.link(self.data_path, dest)
            except OSError:
                shutil.copyfile(self.data_path, dest)
            return
        if size < 0:
            size = self.current_end()
        with open(dest, "wb") as out:
            for path, off, n in self.range_spans(0, size):
                if path is None:
                    out.seek(n, os.SEEK_CUR)  # keep dest sparse for holes
                    continue
                with open(path, "rb") as f:
                    f.seek(off)
                    left = n
                    while left > 0:
                        chunk = f.read(min(left, _COPY_CHUNK))
                        if not chunk:
                            break
                        out.write(chunk)
                        left -= len(chunk)
            out.truncate(size)

    def size_on_disk(self) -> int:
        try:
            return os.path.getsize(self.data_path)
        except OSError:
            return 0


class StorageError(Exception):
    pass


class StorageManager:
    """All tasks' disk state + reuse index + reclaimer + the
    content-addressed piece index.

    Upstream client/daemon/storage/storage_manager.go:52-124 (API) and
    :80-89 (Reclaimer: evict least-recently-accessed completed tasks when
    disk usage crosses the high watermark).
    """

    def __init__(
        self,
        data_dir: str,
        max_bytes: int = 0,
        abandoned_ttl: float = 3600.0,
        dedup: bool | None = None,
    ):
        self.data_dir = data_dir
        self.max_bytes = max_bytes  # 0 = unbounded
        # incomplete tasks idle this long AND not owned by a live
        # conductor count as abandoned (crash leftovers)
        self.abandoned_ttl = abandoned_ttl
        # content-addressed cross-task dedup (DF_PIECE_DEDUP=0 disables)
        self.dedup_enabled = (
            os.environ.get("DF_PIECE_DEDUP", "1") != "0" if dedup is None else dedup
        )
        self.piece_index = PieceIndex()
        self.tasks: dict[str, TaskStorage] = {}
        self.lock = threading.RLock()
        os.makedirs(data_dir, exist_ok=True)
        self._load_existing()

    def _task_dir(self, task_id: str) -> str:
        return os.path.join(self.data_dir, task_id[:3], task_id)

    def _load_existing(self) -> None:
        """Recover persisted tasks on restart (download-side resume,
        upstream client/daemon/peer/peertask_reuse.go) and rebuild the
        content-addressed index from their metadata — holders first,
        then references, dropping any reference whose bytes no longer
        resolve (a crash between a holder's delete-migration and the
        referrer's re-point; the piece is simply re-fetched on resume)."""
        for prefix in os.listdir(self.data_dir):
            pdir = os.path.join(self.data_dir, prefix)
            if not os.path.isdir(pdir):
                continue
            for task_id in os.listdir(pdir):
                meta_path = os.path.join(pdir, task_id, "metadata.json")
                if not os.path.exists(meta_path):
                    continue
                try:
                    with open(meta_path) as f:
                        meta = TaskMeta.from_json(json.load(f))
                    self.tasks[task_id] = TaskStorage(
                        os.path.join(pdir, task_id), meta, manager=self
                    )
                except Exception:
                    logger.exception("failed to recover task %s", task_id)
        for ts in self.tasks.values():
            for pm in ts.meta.pieces.values():
                if not pm.ref_task and pm.digest:
                    self.piece_index.record_holder(
                        pm.digest, pm.length, ts.meta.task_id, pm.number
                    )
        for ts in self.tasks.values():
            broken = []
            for pm in ts.meta.pieces.values():
                if not pm.ref_task:
                    continue
                if (
                    self.piece_index.find_holder(
                        pm.digest, pm.length, exclude_task=ts.meta.task_id
                    )
                    is None
                ):
                    broken.append(pm.number)
                else:
                    self.piece_index.record_ref(
                        pm.digest, pm.length, ts.meta.task_id, pm.number
                    )
            if broken:
                logger.warning(
                    "task %s: %d dedup refs lost their source; dropped for refetch",
                    ts.meta.task_id[:16], len(broken),
                )
                with ts.lock:
                    for n in broken:
                        ts.meta.pieces.pop(n, None)
                        ts._ref_count -= 1
                    # a 'done' task missing pieces is no longer complete
                    if ts.meta.done:
                        ts.meta.done = False
                    ts.persist()

    def register_task(
        self,
        task_id: str,
        peer_id: str,
        url: str = "",
        piece_length: int = 0,
        content_length: int = -1,
        tag: str = "",
        application: str = "",
    ) -> TaskStorage:
        with self.lock:
            ts = self.tasks.get(task_id)
            if ts is None:
                meta = TaskMeta(
                    task_id=task_id,
                    peer_id=peer_id,
                    url=url,
                    tag=tag,
                    application=application,
                    piece_length=piece_length,
                    content_length=content_length,
                )
                ts = TaskStorage(self._task_dir(task_id), meta, manager=self)
                ts.persist()
                self.tasks[task_id] = ts
            else:
                if piece_length and not ts.meta.piece_length:
                    ts.meta.piece_length = piece_length
                if content_length >= 0 and ts.meta.content_length < 0:
                    ts.meta.content_length = content_length
            return ts

    def load(self, task_id: str) -> TaskStorage | None:
        with self.lock:
            return self.tasks.get(task_id)

    def find_completed_task(self, task_id: str) -> TaskStorage | None:
        ts = self.load(task_id)
        return ts if ts is not None and ts.meta.done else None

    def resolve_piece(
        self, digest: str, length: int, exclude_task: str = ""
    ) -> tuple[str, int] | None:
        """→ (data_path, offset) of the physical bytes for ``digest``,
        or None when no holder survives (the referrer refetches)."""
        holder = self.piece_index.find_holder(digest, length, exclude_task=exclude_task)
        if holder is None:
            return None
        ts = self.load(holder[0])
        if ts is None:
            return None
        pm = ts.meta.pieces.get(holder[1])
        if pm is None or pm.digest != digest or pm.ref_task:
            return None
        return (ts.data_path, pm.offset)

    def _migrate_digest(
        self, victim: TaskStorage, digest: str, number: int, length: int
    ) -> bool:
        """Copy ``victim``'s piece ``number`` into one of the digest's
        referrers, which becomes the new physical holder (remaining
        refs re-point through the index automatically)."""
        src_pm = victim.meta.pieces.get(number)
        if src_pm is None or src_pm.ref_task:
            return False
        for ref_task_id, ref_number in self.piece_index.referrers(
            digest, exclude_task=victim.meta.task_id
        ):
            heir = self.load(ref_task_id)
            if heir is None:
                continue
            try:
                with heir.lock:
                    heir_pm = heir.meta.pieces.get(ref_number)
                    if heir_pm is None or heir_pm.digest != digest:
                        continue
                    _copy_span(
                        victim.data_path, src_pm.offset,
                        heir.data_path, heir_pm.offset, length,
                    )
                    heir_pm.ref_task = ""
                    heir._ref_count -= 1
                    heir.persist()
            except OSError as e:
                logger.warning(
                    "dedup migration %s -> %s failed: %s",
                    victim.meta.task_id[:16], ref_task_id[:16], e,
                )
                continue
            self.piece_index.record_holder(digest, length, ref_task_id, ref_number)
            EV_DEDUP_MIGRATE(
                digest=digest,
                from_task=victim.meta.task_id,
                to_task=ref_task_id,
                bytes=length,
            )
            M.PIECE_DEDUP_MIGRATE_TOTAL.inc()
            return True
        return False

    def migrate_owned_pieces(self, victim: TaskStorage) -> int:
        """Before ``victim``'s bytes go away, copy every piece that other
        tasks still reference into one of its referrers. Returns
        migrated count."""
        if not self.dedup_enabled:
            return 0
        migrated = 0
        for digest, number, length in self.piece_index.orphaned_by(victim.meta.task_id):
            migrated += int(self._migrate_digest(victim, digest, number, length))
        return migrated

    def release_task_bytes(self, victim: TaskStorage) -> None:
        """Refcount-safe removal of ``victim`` from the index: migrate
        referenced bytes out, drop its entries, then run ONE more
        migration pass for digests a racing ``add_ref_if_held`` attached
        to between the scan and the drop (the bytes are still on disk —
        the caller reclaims them only after this returns)."""
        self.migrate_owned_pieces(victim)
        for digest in self.piece_index.drop_task(victim.meta.task_id):
            pm = next(
                (
                    p
                    for p in victim.meta.pieces.values()
                    if p.digest == digest and not p.ref_task
                ),
                None,
            )
            if pm is not None:
                self._migrate_digest(victim, digest, pm.number, pm.length)

    def delete_task(self, task_id: str) -> None:
        with self.lock:
            ts = self.tasks.pop(task_id, None)
        if ts is not None:
            # refcount-safe GC: shared bytes move to a surviving
            # referrer before this task's files go
            self.release_task_bytes(ts)
            ts._close_write_handle()
            shutil.rmtree(ts.dir, ignore_errors=True)

    def total_bytes(self) -> int:
        with self.lock:
            return sum(t.size_on_disk() for t in self.tasks.values())

    def reclaim(self) -> int:
        """Evict least-recently-accessed completed tasks until under the
        byte budget. Returns the number of tasks evicted."""
        if not self.max_bytes:
            return 0
        evicted = 0
        while self.total_bytes() > self.max_bytes:
            with self.lock:
                now = time.time()
                candidates = [
                    t
                    for t in self.tasks.values()
                    # completed tasks, plus ABANDONED incomplete ones
                    # (crash leftovers would otherwise leak disk
                    # forever). A live conductor's task is never a
                    # candidate no matter how slowly its origin
                    # trickles — busy says someone owns it.
                    if t.meta.done
                    or (not t.busy and now - t.meta.access_time > self.abandoned_ttl)
                ]
                if not candidates:
                    break
                victim = min(candidates, key=lambda t: t.meta.access_time)
            self.delete_task(victim.meta.task_id)
            evicted += 1
        return evicted


def _copy_span(src_path: str, src_off: int, dst_path: str, dst_off: int, n: int) -> None:
    """Kernel-side span copy where the OS offers it (copy_file_range —
    reflink-capable filesystems share the extent outright), buffered
    read/write otherwise."""
    with open(src_path, "rb") as src, open(dst_path, "r+b") as dst:
        if hasattr(os, "copy_file_range"):
            left, soff, doff = n, src_off, dst_off
            try:
                while left > 0:
                    moved = os.copy_file_range(
                        src.fileno(), dst.fileno(), left, soff, doff
                    )
                    if moved == 0:
                        break
                    left -= moved
                    soff += moved
                    doff += moved
                if left == 0:
                    return
            except OSError:
                pass  # cross-device / unsupported fs: buffered fallback
        src.seek(src_off)
        dst.seek(dst_off)
        left = n
        while left > 0:
            chunk = src.read(min(left, _COPY_CHUNK))
            if not chunk:
                break
            dst.write(chunk)
            left -= len(chunk)


# hoisted (dfanalyze hot-module hygiene): verify_content_digest ran these
# imports per call
import hashlib as _hashlib  # noqa: E402

from dragonfly2_torch.utils.digest import parse_digest as _parse_digest  # noqa: E402
