"""Lightweight in-process tracing — the part of the reference's
``utils/tracing.py`` the scheduler's decision path calls: spans with
parent links and attributes recorded into a bounded in-memory ring per
service, a contextvar-held current span, and the root sampling ratio. File
and OTLP export and W3C trace-context propagation come with the server
slice.

Env: ``DF_TRACE_SAMPLE`` (root sampling ratio in [0, 1], default 1).
"""

from __future__ import annotations

import collections
import contextvars
import os
import random
import threading
import time
import uuid
from dataclasses import dataclass, field

_RING_SIZE = 1024


# Span ids come from the stdlib Mersenne generator, not uuid4: trace ids
# need uniqueness, not unpredictability, and uuid4 costs an os.urandom
# syscall per id on the scheduling hot path.
def _gen_trace_id() -> str:
    return f"{random.getrandbits(128):032x}"


def _gen_span_id() -> str:
    return f"{random.getrandbits(64):016x}"


# the current span for this thread/context — the implicit parent for spans
# started without an explicit one
_current: "contextvars.ContextVar[Span | None]" = contextvars.ContextVar(
    "df_current_span", default=None
)


def current_span() -> "Span | None":
    return _current.get()


def is_sampling() -> bool:
    """True when a span started now would be recorded: the current span is
    sampled, or there is no current span and the root ratio can sample. Hot
    paths use this to skip span construction entirely — pair with
    ``NOOP_SPAN``/``noop_cm`` for the not-sampling branch."""
    cur = _current.get()
    if cur is not None:
        return cur.sampled
    return _sample_ratio > 0.0


class _NoopCm:
    """Context manager that does nothing — not even contextvar writes. Safe
    exactly when ``is_sampling()`` is False."""

    __slots__ = ()

    def __enter__(self):
        return _UNSAMPLED

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP_CM = _NoopCm()


def maybe_span(service: str, name: str, **attrs):
    """``get(service).span(name, **attrs)`` when sampling, a free no-op
    context manager otherwise."""
    if is_sampling():
        return get(service).span(name, **attrs)
    return _NOOP_CM


def noop_cm() -> _NoopCm:
    return _NOOP_CM


class use_span:
    """Make ``span`` the current span for the duration of the block (a
    plain class, not @contextmanager: the generator protocol costs more per
    entry and this sits on scheduling's hot path)."""

    __slots__ = ("_span", "_token")

    def __init__(self, span: "Span | None"):
        self._span = span

    def __enter__(self) -> "Span | None":
        if _current.get() is self._span:
            self._token = None
        else:
            self._token = _current.set(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _current.reset(self._token)
        return False


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: str = ""
    service: str = ""
    start_ns: int = 0
    end_ns: int = 0
    status: str = "ok"
    sampled: bool = True
    attributes: dict = field(default_factory=dict)
    _tracer: "Tracer | None" = None
    _ctx_token: object = field(default=None, repr=False, compare=False)

    def set(self, **attrs) -> "Span":
        self.attributes.update(attrs)
        return self

    def end(self, status: str = "ok") -> None:
        if self.end_ns:
            return  # idempotent
        self.end_ns = time.time_ns()
        self.status = status
        if self._tracer is not None:
            self._tracer._record(self)

    # entering a span also makes it the current span, so everything
    # started inside the block parents under it
    def __enter__(self) -> "Span":
        self._ctx_token = _current.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._ctx_token is not None:
            _current.reset(self._ctx_token)
            self._ctx_token = None
        self.end("error" if exc_type is not None else "ok")
        return False


class _UnsampledSpan(Span):
    """The unsampled fast path: ONE shared instance serves every unsampled
    trace; it is never recorded, so its mutators are no-ops. Entering uses
    a per-context depth counter: only the outermost entry flips the
    current span."""

    def set(self, **attrs) -> "Span":
        return self

    def end(self, status: str = "ok") -> None:
        pass

    def __enter__(self) -> "Span":
        d = _unsampled_depth.get()
        if d == 0:
            _unsampled_token.set(_current.set(self))
        _unsampled_depth.set(d + 1)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        d = _unsampled_depth.get() - 1
        _unsampled_depth.set(d)
        if d == 0:
            token = _unsampled_token.get()
            if token is not None:
                _current.reset(token)
                _unsampled_token.set(None)
        return False


_unsampled_depth: "contextvars.ContextVar[int]" = contextvars.ContextVar(
    "df_unsampled_depth", default=0
)
_unsampled_token: "contextvars.ContextVar[object]" = contextvars.ContextVar(
    "df_unsampled_token", default=None
)
_UNSAMPLED = _UnsampledSpan(
    name="unsampled",
    trace_id=uuid.uuid4().hex,
    span_id=uuid.uuid4().hex[:16],
    sampled=False,
)
# the placeholder for "no span here" code paths guarded by is_sampling()
NOOP_SPAN = _UNSAMPLED


class Tracer:
    """One service's spans; finished sampled spans land in a bounded
    ring (``finished``)."""

    def __init__(self, service: str):
        self.service = service
        self.finished: collections.deque[Span] = collections.deque(maxlen=_RING_SIZE)

    def start_span(self, name: str, parent: "Span | None" = None, **attrs) -> Span:
        """Start a span under ``parent``, or under the current span when
        None. A true root draws the sampling decision from the ratio;
        children inherit it."""
        if parent is None:
            parent = _current.get()
        if parent is not None:
            if not parent.sampled:
                return _UNSAMPLED
            trace_id = parent.trace_id
            parent_id = parent.span_id
        else:
            ratio = _sample_ratio
            if not (ratio >= 1.0 or (ratio > 0.0 and random.random() < ratio)):
                return _UNSAMPLED
            trace_id = _gen_trace_id()
            parent_id = ""
        return Span(
            name=name,
            trace_id=trace_id,
            span_id=_gen_span_id(),
            parent_id=parent_id,
            service=self.service,
            start_ns=time.time_ns(),
            attributes=dict(attrs),
            _tracer=self,
        )

    def span(self, name: str, parent: "Span | None" = None, **attrs) -> Span:
        """Context-manager form: ``with tracer.span("x") as sp: ...``."""
        return self.start_span(name, parent=parent, **attrs)

    def _record(self, span: Span) -> None:
        if span.sampled:
            self.finished.append(span)  # a deque append is GIL-atomic


_tracers: dict[str, Tracer] = {}
_config_lock = threading.Lock()
try:
    _sample_ratio: float = min(1.0, max(0.0, float(os.environ.get("DF_TRACE_SAMPLE", "1"))))
except ValueError:
    _sample_ratio = 1.0


def get(service: str) -> Tracer:
    tracer = _tracers.get(service)
    if tracer is not None:
        return tracer
    with _config_lock:
        return _tracers.setdefault(service, Tracer(service))
