"""Prometheus-compatible metrics: counters, gauges and histograms with
labels in one registry per process — counterpart of the reference's
``utils/metrics.py``. The text exposition and its /metrics server come
with the server slice.

Stdlib-only — the hot paths need lock-cheap increments more than they need
a client library.
"""

from __future__ import annotations

import threading

_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0, float("inf"),
)


class _Metric:
    def __init__(self, name: str, help_: str, labels: tuple[str, ...]):
        self.name = name
        self.help = help_
        self.label_names = labels
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def labels(self, *values: str):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {values}"
            )
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _default_child(self):
        if self.label_names:
            raise ValueError(f"{self.name} requires labels {self.label_names}")
        return self.labels()


class _CounterChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Counter(_Metric):
    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _GaugeChild:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        # same lock as inc: an unlocked set racing a read-modify-write
        # inc can lose whichever lands second
        with self._lock:
            self._value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Metric):
    def _new_child(self):
        return _GaugeChild()

    def set(self, v: float) -> None:
        self._default_child().set(v)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class _HistogramChild:
    __slots__ = ("buckets", "counts", "total", "count", "_lock")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.total += v
            self.count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1


class Histogram(_Metric):
    def __init__(self, name, help_, labels=(), buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_, labels)
        self.buckets = tuple(buckets)
        if self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float) -> None:
        self._default_child().observe(v)


class Registry:
    def __init__(self, namespace: str = "dragonfly"):
        self.namespace = namespace
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._sync_hooks: list = []

    def on_sync(self, fn) -> None:
        """Register a zero-arg callable run before every registry read —
        for series whose hot path must not touch a counter lock (the swarm
        observatory's gauges): they refresh here, once per read."""
        with self._lock:
            self._sync_hooks.append(fn)

    def sync(self) -> None:
        """Run the sync hooks; reader-side, so a failing hook must not take
        the read down with it."""
        for fn in list(self._sync_hooks):
            try:
                fn()
            except Exception:  # noqa: BLE001 — the read survives a bad hook
                continue

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                if type(existing) is not type(metric):
                    raise ValueError(f"metric {metric.name} re-registered as different kind")
                return existing
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help_: str = "", labels: tuple = ()) -> Counter:
        return self._register(Counter(f"{self.namespace}_{name}", help_, tuple(labels)))

    def gauge(self, name: str, help_: str = "", labels: tuple = ()) -> Gauge:
        return self._register(Gauge(f"{self.namespace}_{name}", help_, tuple(labels)))

    def histogram(
        self, name: str, help_: str = "", labels: tuple = (), buckets=_DEFAULT_BUCKETS
    ) -> Histogram:
        return self._register(
            Histogram(f"{self.namespace}_{name}", help_, tuple(labels), buckets)
        )


# process-wide default registry: each module defines its series here
default_registry = Registry()

# cross-service identity series: every exporter carries one
# dragonfly_build_info{service,version} = 1 sample, so dashboards can
# join any series to the build that produced it. A process hosting
# several services sets one sample per service name.
BUILD_INFO = default_registry.gauge(
    "build_info",
    "Build identity of this exporter (value is always 1)",
    ("service", "version"),
)


def set_build_info(service: str) -> None:
    """Stamp the exporter identity sample; every server assembly calls
    this on serve with its own service name."""
    from dragonfly2_torch.version import __version__

    BUILD_INFO.labels(service, __version__).set(1)
