"""Piece manager: fetch pieces from parents or the origin into storage.

Counterpart of the reference's ``client/piece_manager.py``.

Role parity: upstream client/daemon/peer/piece_manager.go —
``download_piece`` from a parent (:170) and ``download_source`` whole-file
from origin with optional concurrent ranged piece downloads
(:139-166,303-373). The parent dispatcher keeps a per-parent latency
EWMA with randomized tie-breaking (upstream piece_dispatcher.go:103-149).
"""

# dfanalyze: hot — per-piece fetch/verify/write path + the rate limiter
# every transfer windows through

from __future__ import annotations

import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from dragonfly2_torch.client import downloader, source
from dragonfly2_torch.client.pieces import PieceRange, compute_piece_length, piece_ranges
from dragonfly2_torch.client.storage import StorageError, TaskStorage
from dragonfly2_torch.utils import dflog, faults, flight, flows, profiling

logger = dflog.get("client.piece")

# dfprof phases: the piece path's wall split — network read from the
# parent vs the verified write into the piece store (the wait-for-parent
# leg is accounted conductor-side, where the waiting happens)
PH_PIECE_READ = profiling.phase_type("daemon.piece_read")
PH_PIECE_WRITE = profiling.phase_type("daemon.piece_write")

# origin-path flight events: back-to-source is the expensive fallback,
# so every origin hit is worth a permanent ring entry
EV_SOURCE_START = flight.event_type("daemon.source_download_start")
EV_SOURCE_DONE = flight.event_type("daemon.source_download_done")

# fault point: the parent piece fetch — chaos schedules model flaky/lying
# parents here (errors, latency, payload truncation/corruption); the
# digest check downstream must catch every mutated payload
FP_PIECE_READ = faults.point("daemon.piece_read")

TRAFFIC_BACK_TO_SOURCE = "back_to_source"
TRAFFIC_REMOTE_PEER = "remote_peer"


@dataclass
class ParentInfo:
    peer_id: str
    upload_addr: str  # host:port of the parent's HTTP upload server
    finished_pieces: set[int] = field(default_factory=set)
    # latency EWMA (seconds) for dispatcher scoring
    latency: float = 0.0

    def observe(self, dt: float) -> None:
        self.latency = dt if self.latency == 0 else 0.8 * self.latency + 0.2 * dt


class PieceDispatcher:
    """Scores parents by observed latency with randomization so one fast
    parent doesn't absorb every piece (upstream
    piece_dispatcher.go:103-149)."""

    def __init__(self, rand: random.Random | None = None):
        self.rand = rand or random.Random(0)

    def pick(
        self,
        parents: list[ParentInfo],
        piece_number: int,
        exclude: set[str] | None = None,
    ) -> ParentInfo | None:
        """Pick a parent for ``piece_number``. Parents advertising the piece
        win; otherwise any parent may be probed optimistically (an
        in-progress parent's finished_pieces snapshot goes stale the moment
        it downloads more — a 404 there is retryable, not disqualifying).
        ``exclude`` deprioritizes just-failed parents when alternatives
        exist."""
        if exclude:
            preferred = [p for p in parents if p.peer_id not in exclude]
            if preferred:
                parents = preferred
        eligible = [p for p in parents if piece_number in p.finished_pieces]
        if not eligible:
            # parents that may have the piece soon: any parent
            eligible = list(parents)
        if not eligible:
            return None
        # weight ∝ 1/(latency+ε), jittered
        weights = [
            (1.0 / (p.latency + 1e-3)) * (0.75 + 0.5 * self.rand.random())
            for p in eligible
        ]
        return eligible[max(range(len(eligible)), key=lambda i: weights[i])]


class PieceManager:
    def __init__(
        self,
        concurrent_pieces: int = 4,
        source_concurrency: int = 4,
        source_concurrency_threshold: int = 32 * 1024 * 1024,
        shaper: "TrafficShaper | None" = None,
        download_delay_s: float = 0.0,
    ):
        self.concurrent_pieces = concurrent_pieces
        self.source_concurrency = source_concurrency
        self.source_concurrency_threshold = source_concurrency_threshold
        self.shaper = shaper
        # synthetic receive-side latency per piece, landing INSIDE the
        # measured cost window — fault-injection knob modelling a loaded
        # host whose pressure slows its own downloads (the signal the
        # bad-node detectors read); 0 in production
        self.download_delay_s = download_delay_s

    # ------------------------------------------------------------------
    def download_piece_from_parent(
        self,
        ts: TaskStorage,
        parent: ParentInfo,
        pr: PieceRange,
        peer_id: str,
    ) -> "PieceResult":
        t0 = time.monotonic()
        try:
            FP_PIECE_READ()
        except faults.InjectedFault as e:
            raise downloader.PieceDownloadError(str(e)) from e
        with PH_PIECE_READ:
            data, digest, content_type = downloader.download_piece(
                parent.upload_addr, ts.meta.task_id, pr.number, peer_id=peer_id
            )
        data = FP_PIECE_READ.mutate(data)
        if self.download_delay_s > 0:
            time.sleep(self.download_delay_s)  # inside the cost window
        dt_transfer = time.monotonic() - t0
        if self.shaper is not None and self.shaper.enabled:
            # debit on SUCCESS, outside the measured window: optimistic
            # 404 probes transfer nothing and must not burn the budget,
            # and limiter stall must not poison the recorded piece cost
            # that trains the parent-ranking models
            self.shaper.limiter_for(ts.meta.task_id).acquire(len(data))
        dt = dt_transfer
        parent.observe(dt)
        if content_type and "Content-Type" not in ts.meta.headers:
            ts.meta.headers["Content-Type"] = content_type
        if len(data) != pr.length:
            raise downloader.PieceDownloadError(
                f"piece {pr.number}: want {pr.length}B got {len(data)}B"
            )
        try:
            with PH_PIECE_WRITE:
                pm = ts.write_piece(
                    pr.number,
                    pr.offset,
                    data,
                    digest=digest,
                    traffic_type=TRAFFIC_REMOTE_PEER,
                    cost_ns=int(dt * 1e9),
                    parent_id=parent.peer_id,
                )
        except StorageError as e:
            # a digest mismatch means THIS parent served corrupt bytes —
            # that's a retryable piece failure (another parent or the
            # origin may hold good bytes), not a terminal task error
            raise downloader.PieceDownloadError(
                f"piece {pr.number} from {parent.peer_id}: {e}"
            ) from e
        # flow ledger: one request per parent piece fetch, attributed
        # like the bytes were (a ref hit is a dedup request)
        flows.request(
            flows.task_plane(ts.meta.task_id),
            "dedup" if pm.ref_task else "parent",
            latency_s=dt,
        )
        return PieceResult(pm.number, pm.offset, pm.length, pm.digest, pm.traffic_type, pm.cost_ns, parent.peer_id)

    # ------------------------------------------------------------------
    def download_source(
        self,
        ts: TaskStorage,
        url: str,
        headers: dict | None = None,
        on_piece=None,
        offset: int = 0,
        length: int = -1,
        expected_digest: str = "",
    ) -> int:
        """Whole-file origin download: ranged concurrent pieces when the
        origin supports Range and the file is big enough, else one
        sequential stream chunked into pieces (upstream
        piece_manager.go:303-373). Returns content length.

        ``offset``/``length`` select a byte range of the origin object
        (dfget --range / UrlMeta.range): the task's content IS that
        slice — pieces number from its start, and the task completes at
        ``length`` bytes."""
        t_start = time.monotonic()
        EV_SOURCE_START(
            task_id=ts.meta.task_id, url=url, offset=offset, length=length
        )
        client = source.client_for(url)
        meta = client.metadata(url, headers)
        content_length = meta.content_length
        ranged = bool(offset or length >= 0)
        if ranged:
            if not meta.support_range:
                raise ValueError(f"origin does not support ranges: {url}")
            if content_length < 0:
                raise ValueError("ranged download needs a known origin length")
            if offset < 0:
                # suffix form (-n = last n bytes): RFC 7233 clamps a
                # suffix longer than the object to the whole object
                offset = max(0, content_length + offset)
            if offset >= content_length:
                # HTTP 416 semantics: a start past the end is an error,
                # never an empty 'completed' task
                raise ValueError(
                    f"range start {offset} beyond object end {content_length}"
                )
            avail = content_length - offset
            content_length = min(length, avail) if length >= 0 else avail

        if meta.content_type:
            ts.meta.headers["Content-Type"] = meta.content_type
        if content_length >= 0 and ts.meta.content_length < 0:
            ts.meta.content_length = content_length
        if not ts.meta.piece_length:
            ts.meta.piece_length = compute_piece_length(content_length)

        use_concurrent = (
            meta.support_range
            and content_length >= self.source_concurrency_threshold
            and self.source_concurrency > 1
        )
        if use_concurrent:
            ranges = piece_ranges(content_length, ts.meta.piece_length)

            def fetch(pr: PieceRange):
                t0 = time.monotonic()
                # piece offsets are slice-relative; the origin fetch adds
                # the slice's own start
                data = b"".join(
                    client.download(url, headers, offset + pr.offset, pr.length)
                )
                if len(data) != pr.length:
                    # an origin that ignores Range (200 + full body) or
                    # truncates must fail the task, not poison pieces —
                    # the peer-download path enforces the same invariant
                    raise ValueError(
                        f"origin returned {len(data)} bytes for a"
                        f" {pr.length}-byte ranged piece"
                    )
                dt = time.monotonic() - t0
                if self.shaper is not None and self.shaper.enabled:
                    self.shaper.limiter_for(ts.meta.task_id).acquire(len(data))
                pm = ts.write_piece(
                    pr.number, pr.offset, data,
                    traffic_type=TRAFFIC_BACK_TO_SOURCE, cost_ns=int(dt * 1e9),
                )
                if on_piece:
                    on_piece(PieceResult(pm.number, pm.offset, pm.length, pm.digest, pm.traffic_type, pm.cost_ns, ""))

            with ThreadPoolExecutor(max_workers=self.source_concurrency) as pool:
                list(pool.map(fetch, ranges))
            ts.mark_done(content_length, expected_digest=expected_digest)
            EV_SOURCE_DONE(
                task_id=ts.meta.task_id,
                mode="concurrent",
                bytes=content_length,
                wall_s=round(time.monotonic() - t_start, 3),
            )
            self._account_source_request(ts, time.monotonic() - t_start)
            return content_length

        # sequential stream → pieces (write offsets are slice-relative)
        number, write_off, buf = 0, 0, b""
        pl = ts.meta.piece_length
        t0 = time.monotonic()
        stream = (
            client.download(url, headers, offset, content_length)
            if ranged
            else client.download(url, headers)
        )
        for chunk in stream:
            buf += chunk
            if ranged and write_off + len(buf) > content_length:
                # fail the moment the origin over-delivers (Range
                # ignored) — BEFORE more wrong-content pieces are
                # written and announced to the scheduler
                raise ValueError(
                    f"ranged origin delivered more than {content_length} bytes"
                )
            while len(buf) >= pl:
                piece, buf = buf[:pl], buf[pl:]
                dt = time.monotonic() - t0
                pm = ts.write_piece(
                    number, write_off, piece,
                    traffic_type=TRAFFIC_BACK_TO_SOURCE, cost_ns=int(dt * 1e9),
                )
                if on_piece:
                    on_piece(PieceResult(pm.number, pm.offset, pm.length, pm.digest, pm.traffic_type, pm.cost_ns, ""))
                number += 1
                write_off += len(piece)
                t0 = time.monotonic()
        if buf or number == 0:
            dt = time.monotonic() - t0
            pm = ts.write_piece(
                number, write_off, buf,
                traffic_type=TRAFFIC_BACK_TO_SOURCE, cost_ns=int(dt * 1e9),
            )
            if on_piece:
                on_piece(PieceResult(pm.number, pm.offset, pm.length, pm.digest, pm.traffic_type, pm.cost_ns, ""))
            write_off += len(buf)
        if ranged and write_off != content_length:
            # over-delivery = origin ignored the Range header; short =
            # truncated stream — both must fail, not complete wrong
            raise ValueError(
                f"ranged origin delivered {write_off} bytes, expected {content_length}"
            )
        ts.mark_done(write_off, expected_digest=expected_digest)
        EV_SOURCE_DONE(
            task_id=ts.meta.task_id,
            mode="sequential",
            bytes=write_off,
            wall_s=round(time.monotonic() - t_start, 3),
        )
        self._account_source_request(ts, time.monotonic() - t_start)
        return write_off

    @staticmethod
    def _account_source_request(ts: TaskStorage, wall_s: float) -> None:
        flows.request(
            flows.task_plane(ts.meta.task_id),
            "preheat" if flows.is_preheat(ts.meta.task_id) else "origin",
            latency_s=wall_s,
        )


@dataclass
class PieceResult:
    number: int
    offset: int
    length: int
    digest: str
    traffic_type: str
    cost_ns: int
    parent_id: str


class RateLimiter:
    """Token-bucket byte-rate limiter (one per task under the
    TrafficShaper's global budget)."""

    def __init__(self, rate_bytes_per_s: float):
        self.rate = rate_bytes_per_s
        self.tokens = rate_bytes_per_s
        self.last = time.monotonic()
        self.lock = threading.Lock()
        self.consumed = 0  # bytes since the shaper's last sample

    def acquire(self, n: int) -> None:
        with self.lock:
            self.consumed += n
        if self.rate <= 0:
            return
        while True:
            with self.lock:
                now = time.monotonic()
                self.tokens = min(self.rate, self.tokens + (now - self.last) * self.rate)
                self.last = now
                # debt-based: a request larger than one second's budget
                # (bucket capacity) admits once the bucket is full and
                # drives the balance negative — otherwise a piece bigger
                # than the task's share would spin forever
                need = min(float(n), self.rate)
                if self.tokens >= need:
                    self.tokens -= n
                    return
                wait = (need - self.tokens) / self.rate
            time.sleep(min(wait, 0.5))

    def acquire_nowait(self, n: int) -> float:
        """Non-blocking form for the readiness-based serve loop: debit
        ``n`` and return 0.0 when the budget allows it now, else return
        the seconds to wait (nothing debited — the caller parks the
        connection on a loop timer and retries). Debt-based exactly like
        :meth:`acquire`, so a window larger than one second's budget
        still admits once the bucket fills."""
        with self.lock:
            self.consumed += n
            if self.rate <= 0:
                return 0.0
            now = time.monotonic()
            self.tokens = min(self.rate, self.tokens + (now - self.last) * self.rate)
            self.last = now
            need = min(float(n), self.rate)
            if self.tokens >= need:
                self.tokens -= n
                return 0.0
            self.consumed -= n
            return (need - self.tokens) / self.rate

    def refund(self, n: int) -> None:
        """Return tokens debited for bytes that never hit the wire (a
        socket that went write-blocked mid-window)."""
        with self.lock:
            self.tokens = min(self.rate, self.tokens + n) if self.rate > 0 else self.tokens
            self.consumed = max(0, self.consumed - n)

    def set_rate(self, rate: float) -> None:
        with self.lock:
            self.rate = rate

    def take_usage(self) -> int:
        with self.lock:
            used, self.consumed = self.consumed, 0
            return used


class TrafficShaper:
    """Cross-task sampling traffic shaper (upstream
    client/daemon/peer/traffic_shaper.go:126-175): one global download
    budget, re-allocated across active tasks every sampling interval.

    Allocation rule per sample: every task keeps a fair share
    (total/N); tasks that used less than their share in the last window
    donate the surplus, which is split among tasks that saturated theirs
    proportionally to observed demand — a lone hot task gets the whole
    budget, competing hot tasks converge to equal shares.
    """

    def __init__(self, total_rate: float, interval: float = 1.0):
        self.total_rate = total_rate
        self.interval = interval
        self._tasks: dict[str, RateLimiter] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def enabled(self) -> bool:
        return self.total_rate > 0

    def start(self) -> None:
        if not self.enabled or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="traffic-shaper", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def limiter_for(self, task_id: str) -> RateLimiter:
        with self._lock:
            lim = self._tasks.get(task_id)
            if lim is None:
                # a joining task starts at the fair share; the next sample
                # rebalances everyone
                share = (
                    self.total_rate / (len(self._tasks) + 1)
                    if self.enabled
                    else 0.0
                )
                lim = self._tasks[task_id] = RateLimiter(share)
                if self.enabled:
                    for other in self._tasks.values():
                        other.set_rate(share)
            return lim

    def release(self, task_id: str) -> None:
        with self._lock:
            self._tasks.pop(task_id, None)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.sample_once()

    def sample_once(self) -> None:
        with self._lock:
            tasks = list(self._tasks.values())
        if not tasks or not self.enabled:
            return
        share = self.total_rate / len(tasks)
        floor = 0.05 * self.total_rate  # a donor can always restart
        usages = [lim.take_usage() for lim in tasks]
        # saturated = used ≥ ~90% of its current per-window allowance
        saturated = [
            u >= 0.9 * lim.rate * self.interval for lim, u in zip(tasks, usages)
        ]
        if not any(saturated):
            # nobody is starved: plain fair shares (and a lone task keeps
            # the whole budget for instant ramp-up)
            for lim in tasks:
                lim.set_rate(share)
            return
        # donors are clamped near their observed demand (+20% headroom)
        # so allocated rates SUM to ≤ total_rate — handing a donor's
        # surplus away while it keeps its full share would over-admit;
        # a donor that turns hot saturates its clamp within one window
        # and gets promoted at the next sample
        donor_rates = {
            id(lim): min(share, max(u / self.interval * 1.2, floor))
            for lim, u, sat in zip(tasks, usages, saturated)
            if not sat
        }
        surplus = sum(share - r for r in donor_rates.values())
        demand = sum(u for u, sat in zip(usages, saturated) if sat)
        for lim, u, sat in zip(tasks, usages, saturated):
            if sat and demand > 0:
                rate = share + surplus * (u / demand)
            elif sat:
                rate = share + surplus / max(1, sum(saturated))
            else:
                rate = donor_rates[id(lim)]
            lim.set_rate(rate)

