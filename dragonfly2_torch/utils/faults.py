"""Deterministic fault-injection plane: named points, seeded schedules —
counterpart of the reference's ``utils/faults.py``.

Every layer declares a named injection point once at module level
(``FP = faults.point("scheduler.serving_score")``) and calls it on the hot
path; a seeded schedule drives the points, so a chaos run replays the same
fault sequence every time. With no schedule loaded a point call is one
module-global predicate.

Schedules come from ``DF_FAULTS`` (a spec string, or a path to a JSON
file) or from :func:`configure`.

Spec grammar (``;``-separated)::

    seed=42;scheduler.serving_score=error:UNAVAILABLE@0.05;rpc.unary_send=delay:200@0.1
    trainer.fit_step=abort#2            # SIGKILL on that point's call #2

``action[:arg][@rate][#after[+count]]`` — actions:

- ``error[:CODE]``    raise :class:`InjectedFault` carrying that status name
- ``delay:MS``        sleep MS milliseconds, then continue
- ``kill_conn``       raise an InjectedFault flagged ``kill_conn``
- ``abort``           SIGKILL the process (crash-recovery drills)
- ``truncate``, ``corrupt``: payload rules; they parse, and fire only at
  the payload points (``mutate``) that come with the daemon slice

``@rate`` fires from the rule's own seeded RNG; ``#after[+count]`` fires
on exact call indices. Without either, every call fires.

JSON file form: ``{"seed": 42, "rules": [{"point": ..., "action": ...,
"code": ..., "delay_ms": ..., "rate": ..., "after": ..., "count": ...}]}``.
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field

from dragonfly2_torch.utils.metrics import default_registry as _r

INJECTED_TOTAL = _r.counter(
    "faults_injected_total",
    "Faults fired by the injection plane, by point and action",
    ("point", "action"),
)

# the layers a point name may start with
POINT_LAYERS = (
    "rpc", "daemon", "scheduler", "trainer", "manager", "kv", "fleet", "preheat",
)

ACTIONS = ("error", "delay", "truncate", "corrupt", "kill_conn", "abort")

# module-global fast gate, read on every point call
_active = False


class InjectedFault(Exception):
    """A fault fired by the plane. The reference's subclasses
    ``grpc.RpcError``; this port's decision path carries no gRPC, so it is
    a plain exception with the same ``point``/``action``/``code_name``
    and ``details()``."""

    def __init__(self, point: str, action: str, code_name: str = "UNAVAILABLE"):
        super().__init__(f"injected fault at {point}: {action} ({code_name})")
        self.point = point
        self.action = action
        self.code_name = code_name

    def details(self) -> str:
        return str(self)


@dataclass
class FaultRule:
    point: str
    action: str
    code: str = "UNAVAILABLE"
    delay_ms: float = 0.0
    rate: float = 0.0  # probabilistic when > 0 (seeded RNG)
    after: int = 0  # first call index the rule may fire on
    count: int = 0  # 0 = unbounded window
    calls: int = 0  # runtime state, not part of the spec
    _rng: random.Random = field(default=None, repr=False)  # type: ignore[assignment]

    def should_fire(self) -> bool:
        n = self.calls
        self.calls += 1
        if n < self.after:
            return False
        if self.count and n >= self.after + self.count:
            return False
        if self.rate > 0:
            return self._rng.random() < self.rate
        return True


class FaultPoint:
    """One named injection site. Call it on the hot path (may sleep, raise
    or abort per the armed schedule); a single-predicate no-op when no
    schedule is loaded."""

    __slots__ = ("name", "_plane")

    def __init__(self, name: str, plane: "FaultPlane"):
        self.name = name
        self._plane = plane

    def __call__(self) -> None:
        if not _active:
            return
        self._plane.fire(self.name)


class FaultPlane:
    def __init__(self):
        self._points: dict[str, FaultPoint] = {}
        self._rules: dict[str, list[FaultRule]] = {}
        self._lock = threading.Lock()

    def point(self, name: str) -> FaultPoint:
        with self._lock:
            pt = self._points.get(name)
            if pt is None:
                pt = self._points[name] = FaultPoint(name, self)
            return pt

    def configure(self, spec: str) -> int:
        """Arm a schedule (spec string or JSON-file path); returns the
        number of rules loaded. An empty spec disarms the plane."""
        global _active
        spec = (spec or "").strip()
        rules, seed = _parse_spec(spec)
        with self._lock:
            self._rules = {}
            for i, rule in enumerate(rules):
                # per-rule RNG seeded off (seed, point, rule index)
                rule._rng = random.Random(f"{seed}:{rule.point}:{i}")
                self._rules.setdefault(rule.point, []).append(rule)
        _active = bool(rules)
        return len(rules)

    def clear(self) -> None:
        self.configure("")

    def fire(self, name: str) -> None:
        rules = self._rules.get(name)
        if not rules:
            return
        for rule in rules:
            if rule.action in ("truncate", "corrupt"):
                continue  # payload rules apply at payload points only
            with self._lock:
                fired = rule.should_fire()
            if not fired:
                continue
            self._record(name, rule.action)
            if rule.action == "delay":
                time.sleep(rule.delay_ms / 1000.0)
            elif rule.action == "abort":
                os.kill(os.getpid(), signal.SIGKILL)
            elif rule.action in ("error", "kill_conn"):
                raise InjectedFault(name, rule.action, rule.code)

    @staticmethod
    def _record(point: str, action: str) -> None:
        INJECTED_TOTAL.labels(point, action).inc()
        _injected_event()(point=point, action=action)


def _injected_event():
    # lazy: keeps the fault-free path free of any flight coupling
    global _EV_INJECTED
    if _EV_INJECTED is None:
        from dragonfly2_torch.utils import flight

        _EV_INJECTED = flight.event_type("faults.injected")
    return _EV_INJECTED


_EV_INJECTED = None


def _parse_spec(spec: str) -> tuple[list[FaultRule], int]:
    """Spec string or JSON-file path → (rules, seed). Malformed specs raise
    ValueError — a typo'd schedule must fail loudly, not run fault-free."""
    if not spec:
        return [], 0
    if spec.endswith(".json") or os.path.isfile(spec):
        with open(spec) as f:
            doc = json.load(f)
        seed = int(doc.get("seed", 0))
        rules = []
        for rdoc in doc.get("rules", []):
            rule = FaultRule(
                point=rdoc["point"],
                action=rdoc["action"],
                code=rdoc.get("code", "UNAVAILABLE"),
                delay_ms=float(rdoc.get("delay_ms", 0.0)),
                rate=float(rdoc.get("rate", 0.0)),
                after=int(rdoc.get("after", 0)),
                count=int(rdoc.get("count", 0)),
            )
            _validate(rule)
            rules.append(rule)
        return rules, seed
    seed = 0
    rules = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition("=")
        key, value = key.strip(), value.strip()
        if not value:
            raise ValueError(f"fault spec entry {part!r} has no '='")
        if key == "seed":
            seed = int(value)
            continue
        rules.append(_parse_rule(key, value))
    for r in rules:
        _validate(r)
    return rules, seed


def _parse_rule(point: str, value: str) -> FaultRule:
    """``action[:arg][@rate][#after[+count]]`` for one point."""
    after = count = 0
    rate = 0.0
    if "#" in value:
        value, _, window = value.partition("#")
        if "+" in window:
            a, _, c = window.partition("+")
            after, count = int(a), int(c)
        else:
            after, count = int(window), 1
    if "@" in value:
        value, _, r = value.partition("@")
        rate = float(r)
    action, _, arg = value.partition(":")
    rule = FaultRule(point=point, action=action, rate=rate, after=after, count=count)
    if action == "error" and arg:
        rule.code = arg.upper()
    elif action == "delay":
        rule.delay_ms = float(arg or 0)
    return rule


def _validate(rule: FaultRule) -> None:
    if rule.action not in ACTIONS:
        raise ValueError(f"unknown fault action {rule.action!r} (know {ACTIONS})")
    layer = rule.point.split(".", 1)[0]
    if "." not in rule.point or layer not in POINT_LAYERS:
        raise ValueError(
            f"fault point {rule.point!r} must be <layer>.<what> with layer"
            f" in {POINT_LAYERS}"
        )
    if not 0.0 <= rule.rate <= 1.0:
        raise ValueError(f"fault rate {rule.rate} outside [0, 1]")


_plane = FaultPlane()


def point(name: str) -> FaultPoint:
    """Declare (or fetch) a named injection point on the process-wide
    plane; the name must be ``<layer>.<what>``."""
    return _plane.point(name)


def configure(spec: str) -> int:
    return _plane.configure(spec)


def clear() -> None:
    _plane.clear()


# arm from the environment at import: a chaos run sets DF_FAULTS before
# exec so every layer's points come up armed
_env_spec = os.environ.get("DF_FAULTS", "")
if _env_spec:
    configure(_env_spec)
