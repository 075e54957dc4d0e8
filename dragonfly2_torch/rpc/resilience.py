"""The resilience layer's deadline budget and degraded-mode registry — the
part of the reference's ``rpc/resilience.py`` the scheduler's decision
path calls. ``wrap_call``, the circuit breakers, retry budgets and
``ResilienceError`` come with the server slice.

- **Deadline budget**: an absolute monotonic deadline in a contextvar,
  installed by ``deadline_scope``; ``remaining_budget_s`` lets the scoring
  service skip co-batching when waiting would expire the request.
- **Degraded mode**: a component on a fallback path (the scheduler's
  ML → base evaluator ladder) registers a reason; the
  ``resilience_degraded_mode`` gauge and a flight event follow each flip.
"""

from __future__ import annotations

import contextvars
import threading
import time

from dragonfly2_torch.utils import flight
from dragonfly2_torch.utils.metrics import default_registry as _r

DEGRADED_MODE = _r.gauge(
    "resilience_degraded_mode",
    "1 while a component runs in degraded mode (fallback path active)",
    ("component",),
)
EV_DEGRADED = flight.event_type("rpc.degraded_mode")

_registry_lock = threading.Lock()

# absolute monotonic deadline for the current request context
_deadline: contextvars.ContextVar = contextvars.ContextVar("df_deadline", default=None)


def remaining_budget_s() -> "float | None":
    """Seconds left in the inherited deadline budget, or None when no
    deadline is in scope. Can be negative (budget already exhausted)."""
    d = _deadline.get()
    if d is None:
        return None
    return d - time.monotonic()


class deadline_scope:
    """Installs an absolute deadline ``budget_s`` from now as the current
    context's budget (``None`` clears it)."""

    __slots__ = ("_budget_s", "_token")

    def __init__(self, budget_s: "float | None"):
        self._budget_s = budget_s

    def __enter__(self):
        self._token = _deadline.set(
            None if self._budget_s is None else time.monotonic() + self._budget_s
        )
        return self

    def __exit__(self, *exc):
        _deadline.reset(self._token)
        return False


_degraded: dict[str, str] = {}


def reset() -> None:
    """Drop all degraded state (tests)."""
    with _registry_lock:
        _degraded.clear()


def set_degraded(component: str, reason: "str | None") -> None:
    """Flag (or clear, reason=None) a component's degraded mode."""
    with _registry_lock:
        was = _degraded.get(component)
        if reason is None:
            _degraded.pop(component, None)
        else:
            _degraded[component] = reason
    if (reason is None) != (was is None) or (reason != was):
        DEGRADED_MODE.labels(component).set(0.0 if reason is None else 1.0)
        EV_DEGRADED(component=component, reason=reason or "", active=reason is not None)


def degraded() -> dict[str, str]:
    with _registry_lock:
        return dict(_degraded)
