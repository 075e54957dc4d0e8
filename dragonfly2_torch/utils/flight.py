"""Black-box flight recorder: always-on bounded event rings per category,
dumped as jsonl to ``DF_DIAG_DIR`` on demand — counterpart of the
reference's ``utils/flight.py``: the stall watchdog, the crash hooks
(``install``: SIGTERM and fatal exceptions dump the rings) and the runtime
state the Diagnose RPC serves (thread stacks, registered probes).

Typed emitters are declared once per module with ``event_type``; the
name is ``<service>.<what>`` and its service segment names the ring, so
one service's chatter never evicts another's history. Events carry the
current sampled span's ``trace_id``/``span_id``.

Env: ``DF_DIAG_DIR`` (dump directory; no dumps when unset),
``DF_FLIGHT`` (``0`` disables event recording), ``DF_FLIGHT_RING``
(events kept per category, default 512).
"""

from __future__ import annotations

import collections
import json
import os
import signal
import statistics
import sys
import threading
import time
import traceback

from dragonfly2_torch.utils import tracing
from dragonfly2_torch.utils.metrics import default_registry as _r

RING_DEPTH_GAUGE = _r.gauge(
    "flight_ring_depth", "Events resident in a flight-recorder ring", ("category",)
)
DROPPED_TOTAL = _r.counter(
    "flight_events_dropped_total",
    "Events evicted from a full flight-recorder ring",
    ("category",),
)
DUMPS_TOTAL = _r.counter("flight_dumps_total", "Flight-recorder dumps written", ("reason",))

_DEFAULT_RING = 512

_dump_augments: list = []


def register_dump_augment(fn) -> None:
    """Attach extra state to every future dump's meta line. ``fn`` is a
    zero-arg callable returning a dict (merged into meta) — failures are
    swallowed at dump time, never fatal mid-crash."""
    if fn not in _dump_augments:
        _dump_augments.append(fn)


def _env_ring_size() -> int:
    try:
        return max(16, int(os.environ.get("DF_FLIGHT_RING", _DEFAULT_RING)))
    except ValueError:
        return _DEFAULT_RING


# module-level flag read on every emit: a plain global read is the
# cheapest gate Python offers
_enabled = os.environ.get("DF_FLIGHT", "1").lower() not in ("0", "false", "no")

# pre-bound for the emit fast path
_current_span = tracing._current.get
_time_ns = time.time_ns


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def dump_armed() -> bool:
    """True when a flight dump could land somewhere (``DF_DIAG_DIR`` is
    set). Hot paths use this to skip building payloads that exist only to
    be dumped."""
    return bool(os.environ.get("DF_DIAG_DIR"))


class EventType:
    """A typed emitter: ``EV = flight.event_type("scheduler.schedule")``
    once at module level, then ``EV(peer_id=..., retries=...)`` on the hot
    path."""

    __slots__ = ("name", "category", "_ring", "_maxlen", "_dropbox")

    def __init__(self, name: str, recorder: "FlightRecorder"):
        self.name = name
        self.category = name.split(".", 1)[0]
        self._ring = recorder._ring_for(self.category)
        self._maxlen = self._ring.maxlen
        self._dropbox = recorder._dropboxes[self.category]

    def __call__(self, **fields) -> None:
        # the ring holds a plain tuple around the kwargs dict; the event
        # dict is assembled lazily at snapshot/dump time
        if not _enabled:
            return
        span = _current_span()
        if span is not None and span.sampled:
            tid, sid = span.trace_id, span.span_id
        else:
            tid = sid = ""
        ring = self._ring
        if len(ring) == self._maxlen:
            # plain int add into the per-category box; the Prometheus
            # counter is synced at snapshot time
            self._dropbox[0] += 1
        ring.append((_time_ns(), self.name, tid, sid, fields))


class FlightRecorder:
    def __init__(self, ring_size: "int | None" = None):
        self.ring_size = ring_size or _env_ring_size()
        self._rings: dict[str, collections.deque] = {}
        # one mutable [count] box per category, shared with its EventTypes
        self._dropboxes: dict[str, list[int]] = {}
        self._dropped_synced: dict[str, int] = {}
        self._create_lock = threading.Lock()  # ring/probe creation only
        self._probes: dict[str, object] = {}
        self.service = ""
        self.dumps = 0
        self._installed = False
        self._prev_excepthook = None

    def event_type(self, name: str) -> EventType:
        return EventType(name, self)

    def _ring_for(self, category: str) -> collections.deque:
        ring = self._rings.get(category)
        if ring is None:
            with self._create_lock:
                # dropbox BEFORE ring: the unlocked fast path keys on the
                # ring's existence
                self._dropboxes.setdefault(category, [0])
                self._dropped_synced.setdefault(category, 0)
                ring = self._rings.setdefault(
                    category, collections.deque(maxlen=self.ring_size)
                )
        return ring

    def register_probe(self, name: str, fn) -> None:
        """A zero-arg callable whose result rides every dump/Diagnose
        snapshot as runtime state — queue depths, topology engine stats,
        resource counts. Failures are captured, never raised."""
        with self._create_lock:
            self._probes[name] = fn

    def snapshot(self, categories: "list[str] | None" = None) -> dict:
        """{category: [event, ...]} — a point-in-time copy of the rings,
        each event expanded into its dict shape. Also refreshes the ring
        depth and dropped series."""
        out: dict[str, list] = {}
        for cat, ring in list(self._rings.items()):
            if categories is not None and cat not in categories:
                continue
            out[cat] = [
                {"ts_ns": ts, "type": name, "trace_id": tid, "span_id": sid, **f}
                for ts, name, tid, sid, f in self._copy_ring(ring)
            ]
            RING_DEPTH_GAUGE.labels(cat).set(len(out[cat]))
            dropped = self.dropped(cat)
            delta = dropped - self._dropped_synced.get(cat, 0)
            if delta > 0:
                DROPPED_TOTAL.labels(cat).inc(delta)
                self._dropped_synced[cat] = dropped
        return out

    @staticmethod
    def _copy_ring(ring: collections.deque) -> list:
        # list(deque) can raise if a writer appends mid-iteration; the emit
        # path never blocks on a reader lock, so retry instead
        for _ in range(4):
            try:
                return list(ring)
            except RuntimeError:
                continue
        return []

    def categories(self) -> list[str]:
        return sorted(self._rings)

    def dropped(self, category: str) -> int:
        box = self._dropboxes.get(category)
        return box[0] if box else 0

    def runtime_state(self, include_stacks: bool = True) -> dict:
        """Live process state for Diagnose/dumps: thread inventory (and
        stacks), per-category drop counts, registered probe results."""
        state: dict = {
            "pid": os.getpid(),
            "thread_count": threading.active_count(),
            "dropped": {c: box[0] for c, box in self._dropboxes.items()},
        }
        if include_stacks:
            frames = sys._current_frames()
            stacks = {}
            for t in threading.enumerate():
                fr = frames.get(t.ident)
                if fr is not None:
                    stacks[t.name] = "".join(traceback.format_stack(fr))
            state["thread_stacks"] = stacks
        probes = {}
        for name, fn in list(self._probes.items()):
            try:
                probes[name] = fn()
            except Exception as e:
                probes[name] = {"error": str(e)}
        if probes:
            state["probes"] = probes
        return state

    def dump(self, reason: str, diag_dir: "str | None" = None) -> "str | None":
        """Write every ring as jsonl under ``DF_DIAG_DIR`` (first line: dump
        metadata; one event per following line). Returns the path, or None
        when no diag dir is configured or the write failed."""
        diag_dir = diag_dir or os.environ.get("DF_DIAG_DIR") or ""
        if not diag_dir:
            return None
        try:
            os.makedirs(diag_dir, exist_ok=True)
            slug = "".join(c if c.isalnum() or c in "._-" else "-" for c in reason)
            path = os.path.join(
                diag_dir,
                f"{self.service or 'proc'}-{os.getpid()}-{time.time_ns()}-{slug}.jsonl",
            )
            snap = self.snapshot()
            meta = {
                "reason": reason,
                "service": self.service,
                "pid": os.getpid(),
                "dumped_at_ns": time.time_ns(),
                "ring_size": self.ring_size,
                "events": {c: len(e) for c, e in snap.items()},
                "runtime": self.runtime_state(),
            }
            for fn in list(_dump_augments):
                try:
                    meta.update(fn() or {})
                except Exception:
                    continue
            with open(path, "w") as f:
                f.write(json.dumps({"meta": meta}, default=str) + "\n")
                for cat, events in snap.items():
                    for ev in events:
                        f.write(json.dumps({"category": cat, **ev}, default=str) + "\n")
            self.dumps += 1
            DUMPS_TOTAL.labels(reason.split(":", 1)[0].split("-", 1)[0]).inc()
            return path
        except Exception:
            # a failing dump must never turn into a crash
            return None

    def install(self, service: str) -> None:
        """Wire the crash dumps for this process: SIGTERM and uncaught
        fatal exceptions each write a dump before the previous behavior
        runs. Idempotent; a process hosting several services records
        every name."""
        if service:
            if not self.service:
                self.service = service
            elif service not in self.service.split("+"):
                self.service += f"+{service}"
        if self._installed:
            return
        self._installed = True
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _on_term(signum, frame):
                try:
                    self.dump("sigterm")
                finally:
                    if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
                        prev(signum, frame)
                    elif prev is signal.SIG_IGN:
                        pass  # SIGTERM was ignored before; keep ignoring
                    else:
                        signal.signal(signal.SIGTERM, signal.SIG_DFL)
                        os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            pass  # not the main thread: signal hooks unavailable here
        self._prev_excepthook = sys.excepthook

        def _hook(exc_type, exc, tb):
            try:
                self.dump(f"fatal:{exc_type.__name__}")
            finally:
                (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = _hook
        prev_thread_hook = threading.excepthook

        def _thread_hook(args):
            try:
                name = args.exc_type.__name__ if args.exc_type else "Unknown"
                self.dump(f"fatal:{name}")
            finally:
                prev_thread_hook(args)

        threading.excepthook = _thread_hook


class StallWatchdog:
    """Regression detector over a stream of duration observations
    (step time per superbatch, decode wait per shard): an observation
    past ``factor ×`` the trailing median — and past an absolute floor,
    so microsecond jitter can't trip it — emits ``event`` and dumps the
    flight rings while the stall is still live (cooldown-limited).
    ``observe`` is called per superbatch/shard, never on a microsecond
    hot path. ``DF_STALL_FACTOR`` sets the factor (4.0; 0 disables)."""

    def __init__(
        self,
        name: str,
        factor: "float | None" = None,
        window: int = 64,
        min_samples: int = 8,
        floor_s: float = 0.1,
        cooldown_s: float = 60.0,
        event: "EventType | None" = None,
    ):
        if factor is None:
            try:
                factor = float(os.environ.get("DF_STALL_FACTOR", "4.0"))
            except ValueError:
                factor = 4.0
        self.name = name
        self.factor = factor
        self.min_samples = min_samples
        self.floor_s = floor_s
        self.cooldown_s = cooldown_s
        self.event = event
        self.stalls = 0
        self._samples: collections.deque = collections.deque(maxlen=window)
        self._last_trigger = 0.0

    def observe(self, seconds: float) -> bool:
        """Feed one observation; True when it was judged a stall."""
        if self.factor <= 0:
            return False
        stalled = False
        if len(self._samples) >= self.min_samples:
            med = statistics.median(self._samples)
            if seconds > max(self.factor * med, self.floor_s):
                now = time.monotonic()
                if now - self._last_trigger >= self.cooldown_s:
                    self._last_trigger = now
                    self.stalls += 1
                    stalled = True
                    if self.event is not None:
                        self.event(
                            watchdog=self.name,
                            observed_s=round(seconds, 6),
                            median_s=round(med, 6),
                            factor=self.factor,
                        )
                    _recorder.dump(f"stall-{self.name}")
        self._samples.append(seconds)
        return stalled


_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def event_type(name: str) -> EventType:
    """Declare a typed emitter on the process-wide recorder; the name must
    be ``<service>.<what>``."""
    return _recorder.event_type(name)


def install(service: str) -> None:
    _recorder.install(service)


def register_probe(name: str, fn) -> None:
    _recorder.register_probe(name, fn)


def dump(reason: str, diag_dir: "str | None" = None) -> "str | None":
    return _recorder.dump(reason, diag_dir=diag_dir)


def snapshot(categories: "list[str] | None" = None) -> dict:
    return _recorder.snapshot(categories)
