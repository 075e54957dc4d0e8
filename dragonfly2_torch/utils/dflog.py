"""Structured logging (counterpart of the reference's ``utils/dflog.py``).

Per-subsystem loggers under ``dragonfly2_torch.<subsystem>``, with a
key=value formatter so log lines stay grep-able without external deps.
Every record carries the active span's ``trace_id``/``span_id``, appended
only when a sampled span is current.
"""

from __future__ import annotations

import logging
import sys

from dragonfly2_torch.utils import tracing

_CONFIGURED = False

_FORMAT = "%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s%(trace_ctx)s"


class _TraceContextFilter(logging.Filter):
    """Stamp the active span's identity onto every record the handler
    emits (an empty suffix without a sampled current span)."""

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
    """Subsystem logger: scheduler.evaluator, scheduler.serving, …"""
    return logging.LoggerAdapter(logging.getLogger(f"dragonfly2_torch.{subsystem}"), {})
