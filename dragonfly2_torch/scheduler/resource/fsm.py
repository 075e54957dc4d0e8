"""Minimal finite-state machine (counterpart of the reference's
``scheduler/resource/fsm.py``).

Upstream Dragonfly2 drives peer/task lifecycle with looplab/fsm (its
scheduler/resource/peer.go:226-247); this is the same model: named events,
each with a set of legal source states and one destination.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


class InvalidTransitionError(Exception):
    def __init__(self, event: str, state: str):
        super().__init__(f"event {event} inappropriate in current state {state}")
        self.event = event
        self.state = state


@dataclass(frozen=True)
class Transition:
    event: str
    sources: tuple[str, ...]
    dst: str


class FSM:
    def __init__(self, initial: str, transitions: list[Transition], on_transition=None):
        self._state = initial
        self._by_event = {t.event: t for t in transitions}
        self._lock = threading.Lock()
        # observer for successful transitions, called with the new state
        # AFTER the lock is released — one hook covers every event()
        # caller (service demux, scheduling, gc, leave paths)
        self.on_transition = on_transition

    @property
    def current(self) -> str:
        with self._lock:
            return self._state

    def is_state(self, *states: str) -> bool:
        with self._lock:
            return self._state in states

    def can(self, event: str) -> bool:
        t = self._by_event.get(event)
        with self._lock:
            return t is not None and self._state in t.sources

    def event(self, event: str) -> None:
        t = self._by_event.get(event)
        if t is None:
            raise InvalidTransitionError(event, self.current)
        with self._lock:
            if self._state not in t.sources:
                raise InvalidTransitionError(event, self._state)
            self._state = t.dst
        cb = self.on_transition
        if cb is not None:
            cb(t.dst)
