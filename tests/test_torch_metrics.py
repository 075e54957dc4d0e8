"""The port's metrics exposition (dragonfly2_torch.utils.metrics) against
the JAX package's on the CPU: the same series filled into both packages'
``Registry`` (labelled counters, gauges, histograms with exemplars at a
fixed clock) expose line for line alike, in the text format and in
OpenMetrics; both ``MetricsServer``s answer the same status codes and
bodies (content negotiation, /healthz, 404s, the /debug endpoints' 400s,
/debug/faults arming and disarming); and one topology-engine flush moves
the same ``dragonfly_topology_*`` series in both packages."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dragonfly2_torch.topology import TopologyConfig as TTopologyConfig
from dragonfly2_torch.topology import TopologyEngine as TTopologyEngine
from dragonfly2_torch.utils import faults as t_faults
from dragonfly2_torch.utils import metrics as t_metrics
from dragonfly2_tpu.topology import TopologyConfig as JTopologyConfig
from dragonfly2_tpu.topology import TopologyEngine as JTopologyEngine
from dragonfly2_tpu.utils import faults as j_faults
from dragonfly2_tpu.utils import metrics as j_metrics

torch.set_num_threads(1)

EXEMPLAR_CLOCK = 1_700_000_000.125


def _fill(registry, kinds):
    """The same series into a registry of either package; exemplar stamps
    read ``time.time``, which the caller fixes."""
    if "counter" in kinds:
        c = registry.counter("scheduler_ops_total", "Ops by kind", ("kind", "outcome"))
        c.labels("register", "ok").inc(3)
        c.labels("register", "fail").inc()
        c.labels("leave", "ok").inc(2.5)
        registry.counter("trainer_train_total", "Train streams").inc(7)
        registry.counter("bare", "").inc()  # no _total suffix, no help
    if "gauge" in kinds:
        g = registry.gauge("scheduler_peers", "Live peers", ("state",))
        g.labels("Running").set(12)
        g.labels("Succeeded").set(0.5)
        registry.gauge("scheduler_depth", "").set(-3)
    if "histogram" in kinds:
        h = registry.histogram("scheduler_schedule_duration_seconds", "Latency", ("path",),
                               buckets=(0.001, 0.01, 0.1, 1.0))
        h.labels("wave").observe(0.0005, exemplar={"trace_id": "aa11"})
        h.labels("wave").observe(0.05, exemplar={"trace_id": "bb22", "span_id": "01"})
        h.labels("wave").observe(5.0)
        h.labels("scalar").observe(0.02)
        plain = registry.histogram("trainer_fit_duration_seconds", "", buckets=(1.0, 10.0))
        plain.observe(3.0, exemplar={"trace_id": "cc33"})
        plain.observe(30.0)


def _registries(monkeypatch, kinds, namespace="dragonfly"):
    monkeypatch.setattr(time, "time", lambda: EXEMPLAR_CLOCK)
    regs = t_metrics.Registry(namespace), j_metrics.Registry(namespace)
    for r in regs:
        _fill(r, kinds)
    monkeypatch.undo()
    return regs


@pytest.mark.parametrize("kinds", ["counter", "gauge", "histogram", "counter,gauge,histogram"])
@pytest.mark.parametrize("form", ["text", "openmetrics"])
def test_exposition_matches_reference_line_for_line(monkeypatch, kinds, form):
    got, want = _registries(monkeypatch, kinds.split(","))
    if form == "text":
        a, b = got.expose(), want.expose()
    else:
        a, b = got.expose_openmetrics(), want.expose_openmetrics()
        assert a.endswith("# EOF\n")
        if "histogram" in kinds:
            assert ' # {trace_id="bb22",span_id="01"} 0.05 1700000000.125' in a
    assert a.splitlines() == b.splitlines()


def test_sync_hooks_run_before_every_exposition():
    for mod in (t_metrics, j_metrics):
        reg = mod.Registry("t")
        gauge = reg.gauge("synced")
        calls = []

        def hook(calls=calls, gauge=gauge):
            calls.append(1)
            gauge.set(len(calls))

        reg.on_sync(hook)
        reg.on_sync(lambda: 1 / 0)  # a failing hook never takes the scrape down
        assert "t_synced 1.0" in reg.expose()
        assert "t_synced 2.0" in reg.expose_openmetrics()


# -- the /metrics servers ------------------------------------------------------


@pytest.fixture
def servers(monkeypatch):
    got, want = _registries(monkeypatch, ["counter", "gauge", "histogram"])
    pair = [t_metrics.MetricsServer(got, port=0), j_metrics.MetricsServer(want, port=0)]
    for srv in pair:
        srv.register_health("scheduler", lambda: True)
        srv.register_status_section("extra", lambda: {"n": 1})
        srv.start()
    yield pair
    for srv in pair:
        srv.stop()


def _call(srv, path, accept=None, body=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    req = urllib.request.Request(url, data=body, headers={"Accept": accept} if accept else {},
                                 method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.mark.parametrize("accept", [None, "text/plain", "application/openmetrics-text; version=1.0.0"])
def test_metrics_content_negotiation_matches_reference(servers, accept):
    got, want = (_call(s, "/metrics", accept) for s in servers)
    assert got == want
    assert got[0] == 200
    om = accept is not None and "openmetrics" in accept
    assert got[1] == (t_metrics.OPENMETRICS_CONTENT_TYPE if om else "text/plain; version=0.0.4")


def test_healthz_matches_reference(servers):
    (s1, c1, b1), (s2, c2, b2) = (_call(s, "/healthz") for s in servers)
    got, want = json.loads(b1), json.loads(b2)
    assert (s1, c1) == (s2, c2) == (200, "application/json")
    assert got.keys() == want.keys() >= {"status", "uptime_s", "services", "resilience", "degraded", "extra"}
    for key in ("status", "services", "extra"):
        assert got[key] == want[key]
    assert got["resilience"].keys() == want["resilience"].keys()
    # a probe that fails or raises flips both to 503
    for srv in servers:
        srv.register_health("trainer", lambda: 1 / 0)
    (s1, _, b1), (s2, _, b2) = (_call(s, "/healthz") for s in servers)
    assert s1 == s2 == 503
    assert json.loads(b1)["services"] == json.loads(b2)["services"] == {"scheduler": "ok", "trainer": "down"}


@pytest.mark.parametrize("path,status", [
    ("/nope", 404),
    ("/metrics/extra", 404),
    ("/debug/ring?category=no-such-ring", 404),
    ("/debug/ring?category=", 404),
    ("/debug/prof?format=svg", 400),
    ("/debug/prof?seconds=nan", 400),
    ("/debug/prof?bogus=1", 400),
    ("/debug/flows?window=-1", 400),
    ("/debug/flows?x=1", 400),
    ("/debug/swarm?x=1", 400),
])
def test_error_answers_match_reference(servers, path, status):
    got, want = (_call(s, path) for s in servers)
    assert got == want
    assert got[0] == status


@pytest.mark.parametrize("path", ["/debug/ring", "/debug/prof", "/debug/prof?format=collapsed",
                                  "/debug/flows?window=30", "/debug/swarm", "/debug/faults"])
def test_debug_endpoints_answer(servers, path):
    (s1, c1, b1), (s2, c2, b2) = (_call(s, path) for s in servers)
    assert (s1, c1) == (s2, c2)
    assert s1 == 200
    if c1 == "application/json":
        got, want = json.loads(b1), json.loads(b2)
        assert got.keys() == want.keys()


def test_faults_arm_and_disarm_like_reference(servers):
    try:
        spec = b"rpc.unary_send=error@0.5#1+2"
        got, want = (_call(s, "/debug/faults", body=spec) for s in servers)
        assert got == want
        assert got[0] == 200 and json.loads(got[2]) == {"rules": 1, "active": True}
        assert t_faults.active() and j_faults.active()
        snaps = [json.loads(_call(s, "/debug/faults")[2]) for s in servers]
        assert snaps[0]["rules"] == snaps[1]["rules"]
        bad = [_call(s, "/debug/faults", body=b"rpc.unary_send=explode") for s in servers]
        assert bad[0][0] == bad[1][0] == 400
        off = [_call(s, "/debug/faults", body=b"") for s in servers]
        assert off[0] == off[1]
        assert json.loads(off[0][2]) == {"rules": 0, "active": False}
        assert not t_faults.active() and not j_faults.active()
        assert _call(servers[0], "/debug/other", body=b"x")[0] == _call(servers[1], "/debug/other", body=b"x")[0] == 404
    finally:
        t_faults.clear()
        j_faults.clear()


# -- the topology engine's series ---------------------------------------------


TOPOLOGY_SERIES = (
    "dragonfly_topology_edges", "dragonfly_topology_hosts", "dragonfly_topology_delta_queue_depth",
    "dragonfly_topology_delta_dropped_total", "dragonfly_topology_flush_total",
    "dragonfly_topology_stale_edges_purged_total", "dragonfly_topology_inference_cache_hit_rate",
    'dragonfly_topology_query_total{source="cache"}', 'dragonfly_topology_query_total{source="direct"}',
    'dragonfly_topology_query_total{source="inferred"}', 'dragonfly_topology_query_total{source="unknown"}',
    'dragonfly_topology_query_total{source="no_path"}', "dragonfly_topology_flush_seconds_count",
)


def _series(registry) -> dict:
    out = {}
    for line in registry.expose().splitlines():
        if line.startswith("dragonfly_topology_"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_engine_flush_moves_the_same_series():
    """Both engines take the same probes (one host pair stale, the queue
    over its cap), flush once and answer the same queries: every
    ``dragonfly_topology_*`` series moves by the same amount (gauges read
    the same)."""
    rng = np.random.default_rng(3)
    now = 1_000_000.0
    engines = (
        TTopologyEngine(TTopologyConfig(num_landmarks=2, max_pending=40), device="cpu", clock=lambda: now),
        JTopologyEngine(JTopologyConfig(backend="numpy", num_landmarks=2, max_pending=40)),
    )
    probes = [(f"h{a}", f"h{b}", int(rng.integers(1, 50) * 1e6), now - 5.0)
              for a, b in rng.integers(0, 12, (60, 2)) if a != b]
    probes.append(("h90", "h91", int(3e6), now - 10 * 3600.0))  # past max_age_s: purged
    registries = (t_metrics.default_registry, j_metrics.default_registry)
    before = [_series(r) for r in registries]
    queries = [("h0", "h1"), ("h0", "h1"), ("h2", "h90"), ("h3", "h3"), ("h4", "h7"), ("nobody", "h1")]
    for engine in engines:
        for src, dst, rtt, at in probes:
            engine.enqueue(src, dst, rtt, created_at=at)
        engine.flush(now=now)
        for a, b in queries:
            engine.est_rtt_ns(a, b)
        engine.stats()
    after = [_series(r) for r in registries]
    moved = [
        {k: a.get(k, 0.0) - b.get(k, 0.0) if k.endswith(("_total", "_count")) or "_total{" in k else a.get(k)
         for k in TOPOLOGY_SERIES}
        for a, b in zip(after, before)
    ]
    assert moved[0] == moved[1]
    assert moved[0]["dragonfly_topology_flush_total"] == 1
    assert moved[0]["dragonfly_topology_delta_dropped_total"] > 0
