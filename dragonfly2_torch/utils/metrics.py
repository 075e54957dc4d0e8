"""Prometheus-compatible metrics: counters, gauges and histograms with
labels, the text exposition (format 0.0.4) and OpenMetrics, and a /metrics
HTTP server per service process — counterpart of the reference's
``utils/metrics.py`` (upstream scheduler/metrics/metrics.go,
trainer/metrics/metrics.go).

Stdlib-only — the scrape format is a stable text protocol, and the hot
paths need lock-cheap increments more than they need a client library.
"""

from __future__ import annotations

import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_logger = logging.getLogger("dragonfly.metrics")

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

    def _snapshot(self):
        # scrapes race first-occurrence label inserts; iterate a copy
        with self._lock:
            return sorted(self._children.items())

    def _default_child(self):
        if self.label_names:
            raise ValueError(f"{self.name} requires labels {self.label_names}")
        return self.labels()

    @staticmethod
    def _fmt_labels(names, values) -> str:
        if not names:
            return ""
        pairs = ",".join(
            f'{n}="{v}"' for n, v in zip(names, values)
        )
        return "{" + pairs + "}"


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
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for key, child in self._snapshot():
            out.append(
                f"{self.name}{self._fmt_labels(self.label_names, key)} {child.value}"
            )
        return out

    def expose_om(self) -> list[str]:
        # OpenMetrics counters: the FAMILY name drops the _total suffix,
        # samples keep it — same series name on the wire either way
        family = self.name[:-6] if self.name.endswith("_total") else self.name
        sample = f"{family}_total"
        out = [f"# TYPE {family} counter"]
        if self.help:
            out.insert(0, f"# HELP {family} {self.help}")
        for key, child in self._snapshot():
            out.append(
                f"{sample}{self._fmt_labels(self.label_names, key)} {child.value}"
            )
        return out


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
    kind = "gauge"

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

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for key, child in self._snapshot():
            out.append(
                f"{self.name}{self._fmt_labels(self.label_names, key)} {child.value}"
            )
        return out

    def expose_om(self) -> list[str]:
        out = self.expose()
        if not self.help:
            out = out[1:]
        return out


class _HistogramChild:
    __slots__ = ("buckets", "counts", "total", "count", "exemplars", "_lock")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.total = 0.0
        self.count = 0
        # bucket index -> (labels, value, unix_ts): the most recent
        # exemplar per bucket (OpenMetrics keeps one; trace_id exemplars
        # let a dashboard jump from a latency bucket to the owning trace)
        self.exemplars: dict[int, tuple[dict, float, float]] = {}
        self._lock = threading.Lock()

    def observe(self, v: float, exemplar: "dict | None" = None) -> None:
        with self._lock:
            self.total += v
            self.count += 1
            first = None
            for i, b in enumerate(self.buckets):
                if v <= b:
                    if first is None:
                        first = i
                    self.counts[i] += 1
            if exemplar and first is not None:
                self.exemplars[first] = (dict(exemplar), v, time.time())

    def time(self):
        return _Timer(self)


class _Timer:
    def __init__(self, child):
        self._child = child

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._child.observe(time.perf_counter() - self._t0)
        return False


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, labels=(), buckets=_DEFAULT_BUCKETS):
        super().__init__(name, help_, labels)
        self.buckets = tuple(buckets)
        if self.buckets[-1] != float("inf"):
            self.buckets = self.buckets + (float("inf"),)

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float, exemplar: "dict | None" = None) -> None:
        self._default_child().observe(v, exemplar=exemplar)

    def time(self):
        return self._default_child().time()

    def expose(self) -> list[str]:
        return self._expose_lines(exemplars=False)

    def expose_om(self) -> list[str]:
        return self._expose_lines(exemplars=True)

    def _expose_lines(self, exemplars: bool) -> list[str]:
        out = [f"# TYPE {self.name} histogram"]
        if self.help:
            out.insert(0, f"# HELP {self.name} {self.help}")
        for key, child in self._snapshot():
            base = self._fmt_labels(self.label_names, key)
            with child._lock:
                counts = list(child.counts)
                ex = dict(child.exemplars) if exemplars else {}
                total, count = child.total, child.count
            for i, (b, c) in enumerate(zip(child.buckets, counts)):
                le = "+Inf" if b == float("inf") else repr(b)
                if base:
                    lbl = base[:-1] + f',le="{le}"}}'
                else:
                    lbl = f'{{le="{le}"}}'
                line = f"{self.name}_bucket{lbl} {c}"
                if i in ex:
                    labels, v, ts = ex[i]
                    pairs = ",".join(f'{k}="{val}"' for k, val in labels.items())
                    line += f" # {{{pairs}}} {v} {ts:.3f}"
                out.append(line)
            out.append(f"{self.name}_sum{base} {total}")
            out.append(f"{self.name}_count{base} {count}")
        return out


class Registry:
    def __init__(self, namespace: str = "dragonfly"):
        self.namespace = namespace
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._sync_hooks: list = []

    def on_sync(self, fn) -> None:
        """Register a zero-arg callable run before every exposition or
        registry snapshot — the flight-recorder discipline for series
        whose hot path must not touch a counter lock (the flow ledger):
        deltas flush here, once per read, instead of per event."""
        with self._lock:
            self._sync_hooks.append(fn)

    def sync(self) -> None:
        """Run the sync hooks; reader-side, so a failing hook must not
        take the scrape down with it."""
        for fn in list(self._sync_hooks):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — scrape survives a bad hook
                _logger.debug("metric sync hook %r failed: %s", fn, e)

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

    def expose(self) -> str:
        self.sync()
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: list[str] = []
        for metric in metrics:
            lines.extend(metric.expose())
        return "\n".join(lines) + "\n"

    def expose_openmetrics(self) -> str:
        """OpenMetrics text exposition: the format that carries
        exemplars (trace_id on histogram buckets). Served by
        MetricsServer when the scraper negotiates it via Accept."""
        self.sync()
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: list[str] = []
        for metric in metrics:
            lines.extend(metric.expose_om())
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


class MetricsServer:
    """GET /metrics on its own port (upstream runs one per service on
    :8000, trainer/metrics/metrics.go:38). A scraper sending
    ``Accept: application/openmetrics-text`` gets the OpenMetrics form
    (with exemplars); everyone else the classic 0.0.4 text.

    GET /healthz answers per-service liveness as JSON on the same port
    deploys already scrape: services register named probes via
    ``register_health``; 200 while every probe passes, 503 otherwise
    (hard-down ONLY — a *degraded* component answers 200). The body also
    carries the resilience plane's state (rpc/resilience): per-target
    circuit-breaker states, retry-budget fill, and the degraded-mode
    component map (e.g. the scheduler's ML→base evaluator fallback), so
    the port operators already scrape explains both "is it up" and "is
    it limping".

    GET /debug/ring serves the local flight-recorder rings
    (utils/flight) as JSON — ``?category=<name>`` narrows to one ring
    and 404s for unknown categories, the same not-found behavior as
    unknown paths. GET /debug/prof serves the continuous profiler
    (utils/profiling) — collapsed flamegraph stacks plus the phase
    ledger as JSON; ``?seconds=N`` narrows to the recent-sample window,
    ``?format=collapsed`` returns the bare stack text, and unknown
    parameters/values are 400. GET /debug/faults serves the fault-injection plane's
    state (utils/faults: registered points, armed rules with call/fire
    counts); POST /debug/faults with a spec-string body arms a schedule
    live (empty body disarms) — the chaos toggle without a restart.
    Unknown paths stay 404."""

    def __init__(self, registry: Registry, host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.host = host
        self.port = port
        self._httpd = None
        self._thread = None
        self._started_at = time.time()
        self._health: dict[str, object] = {}
        self._status_sections: dict[str, object] = {}

    def register_health(self, service: str, probe) -> None:
        """Register a liveness probe: a zero-arg callable returning a
        truthy value (or raising) — e.g. ``lambda: server.running``."""
        self._health[service] = probe

    def register_status_section(self, name: str, fn) -> None:
        """Attach an extra section to the /healthz body: a zero-arg
        callable whose dict result lands under ``name`` (e.g. the
        manager's SLO state next to the resilience map). Sections are
        informational — they can never flip the 200/503, and a failing
        section is dropped, not fatal (liveness must always answer)."""
        self._status_sections[name] = fn

    def health_snapshot(self) -> tuple[bool, dict]:
        services = {}
        ok = True
        for name, probe in sorted(self._health.items()):
            try:
                alive = bool(probe())
            except Exception:
                alive = False
            services[name] = "ok" if alive else "down"
            ok = ok and alive
        body = {
            # hard-down only: degraded components (the resilience map
            # below) keep the 200 — a scheduler limping on the base
            # evaluator must not be LB-ejected like a dead one
            "status": "ok" if ok else "down",
            "uptime_s": round(time.time() - self._started_at, 3),
            "services": services,
        }
        try:
            # lazy: resilience registers its own series in this module's
            # default registry at import time
            from dragonfly2_torch.rpc import resilience

            snap = resilience.snapshot()
            body["resilience"] = {
                "breakers": snap["breakers"],
                "retry_budget_fill": snap["retry_budget_fill"],
            }
            body["degraded"] = snap["degraded"]
        except Exception:
            pass  # liveness must answer even if the resilience plane can't
        for name, fn in sorted(self._status_sections.items()):
            try:
                body[name] = fn()
            except Exception as e:
                # informational sections never break liveness, but a
                # broken one is named in the body instead of vanishing
                body.setdefault("status_section_errors", {})[name] = str(e)
        return ok, body

    def start(self) -> str:
        registry = self.registry
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                import json

                if self.path.split("?", 1)[0] != "/debug/faults":
                    self.send_response(404)
                    self.end_headers()
                    return
                from dragonfly2_torch.utils import faults

                length = int(self.headers.get("Content-Length") or 0)
                spec = self.rfile.read(length).decode("utf-8", "replace").strip()
                try:
                    n = faults.configure(spec)
                except Exception as e:
                    data = json.dumps({"error": str(e)}).encode()
                    self.send_response(400)
                else:
                    data = json.dumps({"rules": n, "active": faults.active()}).encode()
                    self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                from urllib.parse import parse_qs, urlparse

                url = urlparse(self.path)
                if url.path == "/healthz":
                    import json

                    ok, body = server.health_snapshot()
                    data = json.dumps(body).encode()
                    self.send_response(200 if ok else 503)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if url.path == "/debug/ring":
                    import json

                    # lazy import: flight registers its own series in
                    # this module's default registry at import time
                    from dragonfly2_torch.utils import flight

                    rec = flight.recorder()
                    # keep_blank_values: ?category= must 404 like any
                    # other unknown category, not serve every ring
                    cat = parse_qs(url.query, keep_blank_values=True).get(
                        "category", [None]
                    )[0]
                    if cat is not None and cat not in rec.categories():
                        self.send_response(404)
                        self.end_headers()
                        return
                    data = json.dumps(
                        {
                            "service": rec.service,
                            "rings": rec.snapshot([cat] if cat else None),
                        },
                        default=str,
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if url.path == "/debug/prof":
                    import json

                    # lazy import: profiling registers its own series in
                    # this module's default registry at import time
                    from dragonfly2_torch.utils import profiling

                    params = parse_qs(url.query, keep_blank_values=True)
                    unknown = set(params) - {"seconds", "format"}
                    seconds = None
                    fmt = params.get("format", ["json"])[0]
                    err = ""
                    if unknown:
                        err = f"unknown parameters: {sorted(unknown)}"
                    elif fmt not in ("json", "collapsed"):
                        err = f"unknown format {fmt!r} (json|collapsed)"
                    elif "seconds" in params:
                        import math

                        try:
                            seconds = float(params["seconds"][0])
                        except ValueError:
                            seconds = -1.0
                        # nan/inf parse fine but blow up the ns window
                        # math downstream — same 400 as any bad value
                        if not math.isfinite(seconds) or seconds <= 0:
                            err = "seconds must be a positive finite number"
                    if err:
                        data = json.dumps({"error": err}).encode()
                        self.send_response(400)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                        return
                    snap = profiling.profile_snapshot(seconds)
                    if fmt == "collapsed":
                        data = (snap["collapsed"] + "\n").encode()
                        ctype = "text/plain; charset=utf-8"
                    else:
                        data = json.dumps(snap, default=str).encode()
                        ctype = "application/json"
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if url.path == "/debug/flows":
                    import json

                    # lazy import: flows registers its own series in
                    # this module's default registry at import time
                    from dragonfly2_torch.utils import flows

                    params = parse_qs(url.query, keep_blank_values=True)
                    unknown = set(params) - {"window"}
                    window = 60.0
                    err = ""
                    if unknown:
                        err = f"unknown parameters: {sorted(unknown)}"
                    elif "window" in params:
                        import math

                        try:
                            window = float(params["window"][0])
                        except ValueError:
                            window = -1.0
                        if not math.isfinite(window) or window <= 0:
                            err = "window must be a positive finite number"
                    if err:
                        data = json.dumps({"error": err}).encode()
                        self.send_response(400)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                        return
                    snap = flows.snapshot()
                    snap["window_s"] = window
                    snap["window_rates"] = flows.window_rates(window)
                    data = json.dumps(snap, default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if url.path == "/debug/swarm":
                    import json

                    # lazy import: the observatory registers its series
                    # in this module's default registry at import time,
                    # and only scheduler processes ever populate it
                    from dragonfly2_torch.scheduler import swarm

                    params = parse_qs(url.query, keep_blank_values=True)
                    unknown = set(params) - {"task"}
                    if unknown:
                        data = json.dumps(
                            {"error": f"unknown parameters: {sorted(unknown)}"}
                        ).encode()
                        self.send_response(400)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(data)))
                        self.end_headers()
                        self.wfile.write(data)
                        return
                    task = params.get("task", [None])[0] or None
                    data = json.dumps(swarm.snapshot(task), default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if url.path == "/debug/faults":
                    import json

                    from dragonfly2_torch.utils import faults

                    data = json.dumps(faults.snapshot(), default=str).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                if url.path != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                accept = self.headers.get("Accept", "")
                if "application/openmetrics-text" in accept:
                    data = registry.expose_openmetrics().encode()
                    ctype = OPENMETRICS_CONTENT_TYPE
                else:
                    data = registry.expose().encode()
                    ctype = "text/plain; version=0.0.4"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics", daemon=True
        )
        self._thread.start()
        return f"{self.host}:{self.port}"

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()


# process-wide default registry: each service defines its series here and
# the assembly exposes them on its /metrics port
default_registry = Registry()

# cross-service identity series: every exporter carries one
# dragonfly_build_info{service,version} = 1 sample, so dashboards can
# join any series to the build that produced it (uptime_s alone carries
# no identity). A process hosting several services (tests, all-in-one
# deploys) sets one sample per service name.
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
