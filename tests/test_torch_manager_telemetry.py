"""The port's telemetry plane (``manager/telemetry.py``) against the
reference's on one seeded sequence of reports.

The sequence, made from a numpy seed on a clock of its own, runs for two
hours of reports from schedulers, trainers and daemons: new reporters
join, reporters restart with a new epoch, deliveries are duplicated,
pushes alternate between full snapshots and changed-only ones, a
reporter falls silent past the eviction age, and the schedulers' failure
counters and slow decisions breach the download, announce and latency
SLOs for a while, then recover. Both planes must give the same acks and,
at every checkpoint, the same snapshot (inventory, swarms, shards,
trainers, daemons, cluster rollup, SLO states and burn rates) and the
same /healthz section. ``quantile_from_buckets`` must agree on seeded
histograms, and the port's ``TelemetryService`` must answer the port's
reporter over gRPC and refuse a bad payload as the reference does."""

import json
import time

import grpc
import numpy as np
import pytest
import torch

from dragonfly2_torch.manager import telemetry as t_telemetry
from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.utils import metrics as t_metrics
from dragonfly2_torch.utils import telemetry as t_reporter
from dragonfly2_tpu.manager import telemetry as j_telemetry

torch.set_num_threads(1)

tp = protos.load("telemetry_pb2")

T0 = 1_800_000_000.0
EDGES = ("0.005", "0.05", "0.1", "0.5", "1.0", "+Inf")


class _Source:
    """One reporter's cumulative series, advanced by a seeded rng."""

    def __init__(self, service, instance, rng):
        self.service, self.instance, self.rng = service, instance, rng
        self.epoch = 0
        self.seq = 0
        self.counters: dict[str, float] = {}
        self.hists: dict[str, dict] = {}
        self.gauges: dict[str, float] = {}
        self.sections: dict = {}
        self.last: dict[str, object] = {}

    def restart(self):
        self.epoch += 1
        self.seq = 0
        self.counters, self.hists, self.last = {}, {}, {}

    def _count(self, key, n):
        self.counters[key] = self.counters.get(key, 0.0) + float(n)

    def _observe(self, key, samples):
        h = self.hists.setdefault(key, {"buckets": {e: 0.0 for e in EDGES}, "count": 0, "sum": 0.0})
        for s in samples:
            for e in EDGES:
                if e == "+Inf" or s <= float(e):
                    h["buckets"][e] += 1
            h["count"] += 1
            h["sum"] += float(s)

    def step(self, now, bad: bool):
        r = self.rng
        if self.service == "scheduler":
            ok = int(r.integers(5, 50))
            fail = int(r.integers(5, 30)) if bad else int(r.random() < 0.05)
            self._count("dragonfly_scheduler_download_peer_finished_total", ok)
            self._count("dragonfly_scheduler_download_peer_failure_total", fail)
            self._count("dragonfly_scheduler_announce_peer_total{event=register_peer}", ok + fail)
            self._count("dragonfly_scheduler_announce_peer_failure_total", fail // 2)
            self._count("dragonfly_scheduler_schedule_total", ok)
            slow = r.uniform(0.4, 3.0, fail) if bad else r.uniform(0.0, 0.3, 1)
            self._observe("dragonfly_scheduler_schedule_duration_seconds{algorithm=ml}",
                          np.concatenate([r.exponential(0.03, ok), slow]))
            self.gauges["dragonfly_scheduler_peers"] = float(r.integers(10, 500))
            self.gauges["dragonfly_scheduler_tasks"] = float(r.integers(1, 40))
            tasks = [f"task-{int(i)}" for i in r.choice(8, 3, replace=False)]
            self.sections["swarms"] = [
                {"task_id": t, "peers": int(r.integers(1, 20)), "seeders": int(r.integers(0, 3)),
                 "done_pieces": int(r.integers(0, 100)), "total_pieces": 100,
                 "stragglers": [f"p{int(r.integers(0, 9))}"]} for t in tasks] + [{"task_id": ""}]
            self.sections["swarm_rollup"] = {"tasks": 3, "peers": int(r.integers(3, 60)),
                                             "depth_hist": {"1": 3, "2": int(r.integers(0, 9))},
                                             "stragglers": 1, "stuck": int(r.integers(0, 2))}
        elif self.service == "trainer":
            self._count("dragonfly_trainer_ingest_records_total", int(r.integers(0, 10_000)))
            self._count("dragonfly_trainer_dataset_bytes_total", int(r.integers(0, 10**7)))
            stale = 30 * 24 * 3600 if bad else 3600
            self.gauges["dragonfly_trainer_last_fit_timestamp_seconds{model=mlp}"] = now - stale
            self.gauges["dragonfly_trainer_last_fit_timestamp_seconds{model=gnn}"] = now - 60
        else:
            self._count("dragonfly_daemon_piece_traffic_bytes_total{traffic_type=remote_peer}",
                        int(r.integers(0, 10**6)))
            self._count("dragonfly_daemon_back_to_source_total", int(r.integers(0, 3)))
            p2p, origin = int(r.integers(0, 10**6)), int(r.integers(0, 10**6 if bad else 10**4))
            self._count("dragonfly_flow_p2p_bytes_total", p2p)
            self._count("dragonfly_flow_origin_bytes_total", origin)
            self._count("dragonfly_flow_bytes_total{plane=p2p,provenance=parent}", p2p + origin)
            self.sections["flows"] = {"planes": {"p2p": {"parent": p2p}}}
        self.sections["build"] = {"service": self.service, "version": "0.1.0"}
        self.sections["endpoints"] = {"rpc": self.instance}

    def payload(self, full: bool) -> dict:
        cur = {"counters": dict(self.counters), "gauges": dict(self.gauges),
               "hists": json.loads(json.dumps(self.hists))}
        if full:
            out = dict(cur, full=True)
        else:
            out = {kind: {k: v for k, v in cur[kind].items() if self.last.get((kind, k)) != v}
                   for kind in ("counters", "gauges", "hists")}
        self.last = {(kind, k): v for kind in ("counters", "gauges", "hists") for k, v in cur[kind].items()}
        out.update(self.sections)
        return out


def _sequence(seed=15, steps=1300):
    """→ [(now, report kwargs)] for ``TelemetryPlane.apply``."""
    rng = np.random.default_rng(seed)
    sources = [_Source("scheduler", "10.0.0.1:8002", rng), _Source("trainer", "10.0.0.7:9090", rng),
               _Source("daemon", "10.0.1.1:65001", rng)]
    joiners = [(120, _Source("scheduler", "10.0.0.2:8002", rng)), (300, _Source("daemon", "10.0.1.2:65001", rng)),
               (2500, _Source("daemon", "10.0.1.3:65001", rng))]
    silent = sources[2]  # falls silent at step 400, evicted an hour on
    out, now, fresh = [], T0, set()
    for n in range(steps):
        now += float(rng.uniform(0.5, 12.0))
        while joiners and n >= joiners[0][0] // 3:
            sources.append(joiners.pop(0)[1])
        live = [s for s in sources if s is not silent or n < 400]
        src = live[int(rng.integers(len(live)))]
        if rng.random() < 0.01:
            src.restart()
            fresh.discard(id(src))
        bad = 250 <= n < 420 and src.service in ("scheduler", "daemon", "trainer")
        src.step(now, bad)
        full = id(src) not in fresh or rng.random() < 0.1
        fresh.add(id(src))
        src.seq += 1
        kw = dict(service=src.service, instance=src.instance, shard=src.instance if src.service == "scheduler" else "",
                  epoch=f"e{src.epoch}", seq=src.seq, interval_s=10.0, payload=src.payload(full))
        out.append((now, kw))
        if rng.random() < 0.05:  # a redelivery after a lost ack
            out.append((now + 0.1, dict(kw)))
        if rng.random() < 0.02:  # a stale one, older than the newest
            out.append((now + 0.2, dict(kw, seq=max(src.seq - 1, 1))))
    return out


def test_a_seeded_report_sequence_folds_alike(monkeypatch):
    seq = _sequence()
    planes = {"torch": t_telemetry.TelemetryPlane(), "jax": j_telemetry.TelemetryPlane()}
    clock = [T0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    acks = {name: [] for name in planes}
    views = {name: [] for name in planes}
    breached_ever = set()
    for n, (now, kw) in enumerate(seq):
        clock[0] = now
        for name, plane in planes.items():
            acks[name].append(plane.apply(now=now, **json.loads(json.dumps(kw))))
        if n % 37 == 0 or n == len(seq) - 1:
            for name, plane in planes.items():
                views[name].append((plane.snapshot(now), plane.health_section()))
            breached_ever |= set(views["torch"][-1][1]["breached"])
    assert acks["torch"] == acks["jax"]
    for n, (a, b) in enumerate(zip(views["torch"], views["jax"])):
        assert a == b, f"checkpoint {n} differs"
    # the sequence reaches what it is meant to reach
    assert {"download_success", "announce_availability", "schedule_p99", "fit_freshness"} <= breached_ever
    assert views["torch"][-1][1]["breached"] == []  # and recovers
    assert sum(registered for registered, _ in acks["torch"]) > 8
    last = views["torch"][-1][0]
    assert {s["instance"] for s in last["services"]} == {"10.0.0.1:8002", "10.0.0.2:8002", "10.0.0.7:9090",
                                                          "10.0.1.2:65001", "10.0.1.3:65001"}
    assert last["swarms"] and last["shards"] and last["trainers"] and last["daemons"]


def test_quantiles_agree_on_seeded_histograms():
    rng = np.random.default_rng(3)
    for _ in range(200):
        edges = sorted({round(float(x), 4) for x in rng.uniform(0.001, 2.0, int(rng.integers(1, 8)))})
        counts = np.cumsum(rng.integers(0, 50, len(edges) + 1)).astype(float)
        buckets = {repr(e): c for e, c in zip(edges, counts)}
        buckets["+Inf"] = counts[-1]
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert t_telemetry.quantile_from_buckets(buckets, q) == j_telemetry.quantile_from_buckets(buckets, q)
    assert t_telemetry.quantile_from_buckets({}, 0.99) == 0.0


def test_the_service_takes_the_port_reporter_and_refuses_bad_payloads():
    plane = t_telemetry.TelemetryPlane()
    server, port = t_glue.serve({t_glue.TELEMETRY_SERVICE: t_telemetry.TelemetryService(plane)})
    channel = t_glue.dial(f"127.0.0.1:{port}")
    try:
        client = t_glue.ServiceClient(channel, t_glue.TELEMETRY_SERVICE)
        registry = t_metrics.Registry("mgrtest")
        counter = registry.counter("scheduler_work_total")
        rep = t_reporter.TelemetryReporter(client, service="scheduler", instance="127.0.0.1:1",
                                           shard="127.0.0.1:1", interval=60.0, registry=registry)
        counter.inc(5)
        assert rep.push_once()  # registration: baselined
        counter.inc(3)
        assert rep.push_once()
        with plane._lock:
            held = plane._reporters[("scheduler", "127.0.0.1:1")]
            assert held.counters_cum["mgrtest_scheduler_work_total"] == 8.0
            assert sum(b.counters.get("mgrtest_scheduler_work_total", 0.0) for b in held.buckets) == 3.0
        for bad in ("[1, 2]", "{not json"):
            with pytest.raises(grpc.RpcError) as e:
                client.ReportTelemetry(tp.TelemetryReport(service="x", instance="y", epoch="1", seq=1,
                                                          payload_json=bad))
            assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        channel.close()
        server.stop(0)
