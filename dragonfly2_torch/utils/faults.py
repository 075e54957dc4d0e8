"""Deterministic fault-injection plane: named points, seeded schedules —
counterpart of the reference's ``utils/faults.py``.

Chaos discipline (Netflix-style continuous fault injection, Dean &
Barroso's tail-at-scale failure modes): the resilience layer
(rpc/resilience.py) only earns trust if the faults it survives are
*reproducible*. This module gives every layer a named injection point —
``faults.point("rpc.unary_send")`` declared once at module level, called
on the hot path — and drives them from a seeded schedule, so a chaos run
replays the exact same fault sequence every time.

Points follow the flight-recorder's zero-cost discipline: with no
schedule loaded (production default) a point call is one module-global
predicate; the bench's ``resilience_overhead_pct`` holds the whole
fault-free pre-flight under 2% of the scheduling op.

Schedules come from ``DF_FAULTS`` (a spec string, or a path to a JSON
file) or live via :func:`configure` — exposed on every MetricsServer as
``GET/POST /debug/faults`` so a running process can be armed/disarmed
without restarting (the same debug surface as ``/debug/ring``).

Spec grammar (``;``-separated)::

    seed=42;rpc.unary_send=error:UNAVAILABLE@0.05;daemon.piece_read=delay:200@0.1
    trainer.fit_step=abort#2            # SIGKILL on that point's call #2
    kv.roundtrip=kill_conn#3+2          # calls 3 and 4 kill the connection

``action[:arg][@rate][#after[+count]]`` — actions:

- ``error[:CODE]``    raise :class:`InjectedFault` with that gRPC code
- ``delay:MS``        sleep MS milliseconds, then continue
- ``truncate``        payload points: drop the tail half (via ``mutate``)
- ``corrupt``         payload points: flip bytes deterministically
- ``kill_conn``       raise an InjectedFault flagged ``kill_conn`` — call
                      sites drop their connection (kvstore, rpc channel)
- ``abort``           SIGKILL the process (crash-recovery drills)

``@rate`` fires probabilistically from the rule's own seeded RNG (same
seed → same decision sequence); ``#after[+count]`` fires on exact call
indices — fully deterministic windows. Without either, every call fires.

JSON file form: ``{"seed": 42, "rules": [{"point": ..., "action": ...,
"code": ..., "delay_ms": ..., "rate": ..., "after": ..., "count": ...}]}``.
"""

# dfanalyze: hot — a disarmed point is one predicate on every RPC attempt

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

# the layers a point name may start with — the same census discipline as
# metric/event names (hack/check_metrics.py lints registrations)
POINT_LAYERS = (
    "rpc", "daemon", "scheduler", "trainer", "manager", "kv", "fleet", "preheat",
)

ACTIONS = ("error", "delay", "truncate", "corrupt", "kill_conn", "abort")

# module-global fast gate, read on every point call: False (production
# default) means a point call costs one predicate and returns
_active = False


def _fault_class():
    """Build :class:`InjectedFault` on first use: a ``grpc.RpcError``
    subclass with ``code()``/``details()``, so RPC call sites and the
    resilience layer classify an injected fault exactly like a wire error —
    an injected fault that exhausts retries lands in the same ``except
    grpc.RpcError`` fallbacks a wire error would, not crash the caller.
    Built lazily so that a path that never fires a fault (the card's
    scoring legs) never imports gRPC."""
    global _InjectedFault
    if _InjectedFault is None:
        import grpc

        class InjectedFault(grpc.RpcError):
            __doc__ = _fault_class.__doc__

            def __init__(self, point: str, action: str, code_name: str = "UNAVAILABLE"):
                super().__init__(f"injected fault at {point}: {action} ({code_name})")
                self.point = point
                self.action = action
                self.code_name = code_name

            def code(self):
                return getattr(grpc.StatusCode, self.code_name, grpc.StatusCode.UNKNOWN)

            def details(self) -> str:
                return str(self)

        InjectedFault.__module__ = __name__
        _InjectedFault = InjectedFault
    return _InjectedFault


_InjectedFault = None


def __getattr__(name: str):
    # ``faults.InjectedFault`` resolves to the lazily built class
    if name == "InjectedFault":
        return _fault_class()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclass
class FaultRule:
    point: str
    action: str
    code: str = "UNAVAILABLE"
    delay_ms: float = 0.0
    rate: float = 0.0  # probabilistic when > 0 (seeded RNG)
    after: int = 0  # first call index the rule may fire on
    count: int = 0  # 0 = unbounded window
    # runtime state (not part of the spec)
    calls: int = 0
    fired: int = 0
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
    """One named injection site. Call it on the hot path (may sleep,
    raise, or abort per the armed schedule); ``mutate(data)`` applies
    payload rules (truncate/corrupt). Both are single-predicate no-ops
    when no schedule is loaded."""

    __slots__ = ("name", "_plane")

    def __init__(self, name: str, plane: "FaultPlane"):
        self.name = name
        self._plane = plane

    def __call__(self) -> None:
        if not _active:
            return
        self._plane.fire(self.name)

    def mutate(self, data: bytes) -> bytes:
        if not _active:
            return data
        return self._plane.mutate(self.name, data)


class FaultPlane:
    def __init__(self):
        self._points: dict[str, FaultPoint] = {}
        self._rules: dict[str, list[FaultRule]] = {}
        self._lock = threading.Lock()
        self.seed = 0
        self.spec = ""

    # -- declaration ---------------------------------------------------
    def point(self, name: str) -> FaultPoint:
        with self._lock:
            pt = self._points.get(name)
            if pt is None:
                pt = self._points[name] = FaultPoint(name, self)
            return pt

    def points(self) -> list[str]:
        return sorted(self._points)

    # -- configuration -------------------------------------------------
    def configure(self, spec: str) -> int:
        """Arm a schedule (spec string or JSON-file path); returns the
        number of rules loaded. An empty spec disarms the plane."""
        global _active
        spec = (spec or "").strip()
        rules, seed = _parse_spec(spec)
        with self._lock:
            self.spec = spec
            self.seed = seed
            self._rules = {}
            for i, rule in enumerate(rules):
                # per-rule RNG seeded off (seed, point, rule index): the
                # decision sequence is a pure function of the schedule
                rule._rng = random.Random(f"{seed}:{rule.point}:{i}")
                self._rules.setdefault(rule.point, []).append(rule)
        _active = bool(rules)
        return len(rules)

    def clear(self) -> None:
        self.configure("")

    def snapshot(self) -> dict:
        """Live state for the debug surface: registered points, armed
        rules with call/fire counts."""
        with self._lock:
            return {
                "active": _active,
                "seed": self.seed,
                "spec": self.spec,
                "points": sorted(self._points),
                "rules": [
                    {
                        "point": r.point,
                        "action": r.action,
                        "code": r.code,
                        "delay_ms": r.delay_ms,
                        "rate": r.rate,
                        "after": r.after,
                        "count": r.count,
                        "calls": r.calls,
                        "fired": r.fired,
                    }
                    for rules in self._rules.values()
                    for r in rules
                ],
            }

    # -- firing --------------------------------------------------------
    def fire(self, name: str) -> None:
        rules = self._rules.get(name)
        if not rules:
            return
        for rule in rules:
            if rule.action in ("truncate", "corrupt"):
                continue  # payload rules only apply via mutate()
            with self._lock:
                fired = rule.should_fire()
            if not fired:
                continue
            rule.fired += 1
            self._record(name, rule.action)
            if rule.action == "delay":
                time.sleep(rule.delay_ms / 1000.0)
            elif rule.action == "abort":
                # crash drill: die the way a OOM-killed/evicted process
                # dies — no atexit, no finally blocks
                os.kill(os.getpid(), signal.SIGKILL)
            elif rule.action in ("error", "kill_conn"):
                raise _fault_class()(name, rule.action, rule.code)

    def mutate(self, name: str, data: bytes) -> bytes:
        rules = self._rules.get(name)
        if not rules:
            return data
        for rule in rules:
            if rule.action not in ("truncate", "corrupt"):
                continue
            with self._lock:
                fired = rule.should_fire()
            if not fired:
                continue
            rule.fired += 1
            self._record(name, rule.action)
            if rule.action == "truncate":
                data = data[: len(data) // 2]
            else:  # corrupt: deterministic byte flips from the rule's RNG
                buf = bytearray(data)
                for _ in range(max(1, len(buf) // 256)):
                    if not buf:
                        break
                    i = rule._rng.randrange(len(buf))
                    buf[i] ^= 0xFF
                data = bytes(buf)
        return data

    @staticmethod
    def _record(point: str, action: str) -> None:
        INJECTED_TOTAL.labels(point, action).inc()
        _injected_event()(point=point, action=action)


def _injected_event():
    # lazy: flight imports metrics at module load; importing it here at
    # faults-import time would be fine, but the lazy bind keeps the
    # fault-free path free of any flight coupling
    global _EV_INJECTED
    if _EV_INJECTED is None:
        from dragonfly2_torch.utils import flight

        _EV_INJECTED = flight.event_type("faults.injected")
    return _EV_INJECTED


_EV_INJECTED = None


def _parse_spec(spec: str) -> tuple[list[FaultRule], int]:
    """Spec string or JSON-file path → (rules, seed). Malformed specs
    raise ValueError — a chaos run with a typo'd schedule must fail
    loudly, not run fault-free and 'pass'."""
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


# ---------------------------------------------------------------------------
# process-wide plane + module-level convenience API
# ---------------------------------------------------------------------------

_plane = FaultPlane()


def plane() -> FaultPlane:
    return _plane


def point(name: str) -> FaultPoint:
    """Declare (or fetch) a named injection point on the process-wide
    plane. Call once at module level; the name must be
    ``<layer>.<what>`` (linted by hack/check_metrics.py)."""
    return _plane.point(name)


def configure(spec: str) -> int:
    return _plane.configure(spec)


def clear() -> None:
    _plane.clear()


def active() -> bool:
    return _active


def snapshot() -> dict:
    return _plane.snapshot()


# arm from the environment at import — the chaos drivers (tests,
# tools/stress.py --chaos, subprocess crash drills) set DF_FAULTS before
# exec so every layer's points come up armed
_env_spec = os.environ.get("DF_FAULTS", "")
if _env_spec:
    configure(_env_spec)
