"""Structured logging (reference parity: internal/dflog).

Per-subsystem loggers with host/peer context helpers. Uses stdlib logging
with a key=value formatter so log lines stay grep-able without external
deps. Every record carries the active span's ``trace_id``/``span_id``
(logs↔traces correlation: grep a trace id from dftrace/dfdoctor straight
into the service logs) — appended as key=value only when a sampled span
is actually current, so span-less lines stay clean.
"""

from __future__ import annotations

import logging
import sys

from dragonfly2_torch.utils import tracing

_CONFIGURED = False

_FORMAT = "%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s%(trace_ctx)s"


class _TraceContextFilter(logging.Filter):
    """Stamp the active span's identity onto every record the handler
    emits. Attributes are always set (the formatter needs them), but the
    rendered suffix is empty without a sampled current span."""

    def filter(self, record: logging.LogRecord) -> bool:
        span = tracing.current_span()
        if span is not None and span.sampled:
            record.trace_id = span.trace_id
            record.span_id = span.span_id
            record.trace_ctx = f"\ttrace_id={span.trace_id} span_id={span.span_id}"
        else:
            record.trace_id = ""
            record.span_id = ""
            record.trace_ctx = ""
        return True


def configure(level: int = logging.INFO, stream=None) -> None:
    global _CONFIGURED
    root = logging.getLogger("dragonfly2_torch")
    if _CONFIGURED:
        root.setLevel(level)
        return
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    handler.addFilter(_TraceContextFilter())
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False
    _CONFIGURED = True


def get(subsystem: str) -> logging.LoggerAdapter:
    """Subsystem logger: core, grpc, gc, storage, job, trainer…"""
    return logging.LoggerAdapter(logging.getLogger(f"dragonfly2_torch.{subsystem}"), {})


class _Ctx(logging.LoggerAdapter):
    """key=value context adapter — defined once at module level, not per
    with_context call (the old per-call class build allocated a fresh
    type object on every invocation)."""

    def process(self, msg, kwargs):
        prefix = " ".join(f"{k}={v}" for k, v in self.extra.items())
        return (f"{prefix} {msg}" if prefix else msg), kwargs


def with_context(subsystem: str, **ctx: str) -> logging.LoggerAdapter:
    """Logger carrying key=value context (WithPeer / WithHostnameAndIP)."""
    return _Ctx(logging.getLogger(f"dragonfly2_torch.{subsystem}"), ctx)
