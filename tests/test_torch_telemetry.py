"""The port's telemetry reporter (dragonfly2_torch.utils.telemetry) against
the JAX package's on the CPU: ``registry_snapshot`` and ``changed_only``
agree across the packages on the same series, the telemetry field census
is the same, and the port's ``TelemetryReporter`` pushes over gRPC to the
reference's manager telemetry service (``dragonfly2_tpu.manager.
telemetry``) under the same lossy-delivery protocol: deltas counted once,
a duplicate delivery dropped, no double counting across a manager
restart, a failed push keeping its baseline, a new reporter epoch
re-baselining."""

import json

import pytest
import torch

from dragonfly2_torch.rpc import glue as t_glue
from dragonfly2_torch.rpc import protos
from dragonfly2_torch.utils import metrics as t_metrics
from dragonfly2_torch.utils import telemetry as t_telemetry
from dragonfly2_tpu.manager.telemetry import TelemetryPlane, TelemetryService
from dragonfly2_tpu.rpc import glue as j_glue
from dragonfly2_tpu.utils import metrics as j_metrics
from dragonfly2_tpu.utils import telemetry as j_telemetry

torch.set_num_threads(1)

tp = protos.load("telemetry_pb2")


def _fill(registry, step: int):
    c = registry.counter("scheduler_ops_total", "", ("kind",))
    c.labels("a").inc(3 + step)
    if step:
        c.labels("b").inc(step)
    registry.gauge("scheduler_depth").set(7 - step)
    registry.gauge("trainer_only").set(1)
    h = registry.histogram("scheduler_lat_seconds", buckets=(0.1, 1.0))
    for _ in range(step + 1):
        h.observe(0.05)


@pytest.mark.parametrize("prefixes", [(), ("t9_scheduler_",), ("nope_",)])
def test_registry_snapshot_and_changed_only_match_reference(prefixes):
    regs = t_metrics.Registry("t9"), j_metrics.Registry("t9")
    for reg in regs:
        _fill(reg, 0)
    got0 = t_telemetry.registry_snapshot(regs[0], prefixes)
    want0 = j_telemetry.registry_snapshot(regs[1], prefixes)
    assert got0 == want0
    for reg in regs:
        _fill(reg, 2)
    got1 = t_telemetry.registry_snapshot(regs[0], prefixes)
    want1 = j_telemetry.registry_snapshot(regs[1], prefixes)
    assert got1 == want1
    assert t_telemetry.changed_only(got1, got0) == j_telemetry.changed_only(want1, want0)
    assert t_telemetry.changed_only(got1, got1) == {"counters": {}, "gauges": {}, "hists": {}}


def test_telemetry_fields_match_reference():
    assert t_telemetry.TFIELDS.names == j_telemetry.TFIELDS.names
    assert t_telemetry.TELEMETRY_SCOPES == j_telemetry.TELEMETRY_SCOPES
    fields = t_telemetry._TelemetryFields()
    assert fields.tfield("shard.ops") == "ops"
    for bad in ("warpcore.ops", "shard.ops"):  # unknown scope; duplicate
        with pytest.raises(ValueError):
            fields.tfield(bad)


# -- the push protocol over gRPC against the reference's manager -------------


class _Manager:
    """The reference's telemetry service over gRPC on the reference's
    ``glue.serve``; ``restart`` starts a fresh plane on a new server."""

    def __init__(self):
        self.server = None
        self.restart()

    def restart(self):
        if self.server is not None:
            self.server.stop(0)
        self.plane = TelemetryPlane(slos=[])
        self.service = TelemetryService(self.plane)
        self.server, port = j_glue.serve({j_glue.TELEMETRY_SERVICE: self.service})
        self.address = f"127.0.0.1:{port}"
        self.channel = t_glue.dial(self.address)
        return t_glue.ServiceClient(self.channel, t_glue.TELEMETRY_SERVICE)

    def counted(self, prefix: str) -> float:
        """Total delta the plane folded for counter series under ``prefix``."""
        return sum(
            d
            for rep in self.plane._reporters.values()
            for b in rep.buckets
            for key, d in b.counters.items()
            if key.startswith(prefix)
        )

    def close(self):
        self.channel.close()
        self.server.stop(0)


@pytest.fixture
def manager():
    m = _Manager()
    yield m
    m.close()


def _reporter(manager, registry=None):
    registry = registry or t_metrics.Registry("t9p")
    counter = registry.counter("scheduler_work_total")
    client = t_glue.ServiceClient(manager.channel, t_glue.TELEMETRY_SERVICE)
    rep = t_telemetry.TelemetryReporter(
        client, service="scheduler", instance="127.0.0.1:1", shard="127.0.0.1:1", interval=0.01,
        registry=registry,
    )
    return rep, counter


def test_push_counts_deltas_once(manager):
    rep, counter = _reporter(manager)
    counter.inc(5)
    assert rep.push_once()  # registration push: baseline only
    assert manager.counted("t9p_scheduler_work_total") == 0.0
    counter.inc(3)
    assert rep.push_once()
    assert manager.counted("t9p_scheduler_work_total") == 3.0
    assert rep.push_once()  # an unchanged interval folds nothing
    assert manager.counted("t9p_scheduler_work_total") == 3.0
    assert (rep.pushes, rep.failures, rep.seq) == (3, 0, 3)


def test_duplicate_delivery_is_dropped(manager):
    rep, counter = _reporter(manager)
    counter.inc(2)
    rep.push_once()
    counter.inc(4)
    rep.push_once()
    assert manager.counted("t9p_scheduler_work_total") == 4.0
    # the last report's seq again (a retry after a lost ack)
    replay = tp.TelemetryReport(
        service="scheduler", instance="127.0.0.1:1", epoch=rep.epoch, seq=rep.seq, interval_s=0.01,
        payload_json=json.dumps({"counters": {"t9p_scheduler_work_total": 6.0}}),
    )
    ack = rep.client.ReportTelemetry(replay)
    assert ack.last_seq == rep.seq
    assert manager.counted("t9p_scheduler_work_total") == 4.0


def test_manager_restart_no_double_counting(manager):
    rep, counter = _reporter(manager)
    counter.inc(10)
    rep.push_once()  # baseline
    counter.inc(3)
    rep.push_once()
    assert manager.counted("t9p_scheduler_work_total") == 3.0
    rep.client = manager.restart()  # a fresh plane, the same reporter
    assert rep.push_once()  # re-registration (ack.registered)
    assert rep._full_next  # the reporter owes a full snapshot
    counter.inc(2)
    rep.push_once()  # the full push: the new plane baselines every series
    counter.inc(4)
    rep.push_once()
    # post-restart deltas counted exactly once, never the history
    assert manager.counted("t9p_scheduler_work_total") == 4.0
    (folded,) = manager.plane._reporters.values()
    assert folded.counters_cum["t9p_scheduler_work_total"] == 19.0


def test_failed_push_keeps_its_baseline(manager):
    rep, counter = _reporter(manager)
    counter.inc(1)
    rep.push_once()
    good = rep.client

    class _Down:
        def ReportTelemetry(self, req, timeout=None):
            raise ConnectionError("manager down")

    counter.inc(5)
    rep.client = _Down()
    assert not rep.push_once()
    assert rep.failures == 1
    counter.inc(2)
    rep.client = good
    assert rep.push_once()
    # both intervals' worth arrives once the manager is back
    assert manager.counted("t9p_scheduler_work_total") == 7.0


def test_reporter_epoch_change_rebaselines(manager):
    rep, counter = _reporter(manager)
    counter.inc(50)
    rep.push_once()
    counter.inc(1)
    rep.push_once()
    assert manager.counted("t9p_scheduler_work_total") == 1.0
    # a restarted process: a new reporter (new epoch), counters from 0
    rep2, c2 = _reporter(manager, t_metrics.Registry("t9p"))
    assert rep2.epoch != rep.epoch
    c2.inc(2)
    rep2.push_once()
    c2.inc(7)
    rep2.push_once()
    assert manager.counted("t9p_scheduler_work_total") == 7.0  # the manager re-baselines, as in the reference


def test_payload_carries_the_sections(manager):
    """The collected sections, and the profiler's and flow ledger's
    sections when they hold anything, ride the payload next to the
    snapshot; a failing collector leaves the metric half intact."""
    from dragonfly2_torch.utils import flows

    rep, counter = _reporter(manager)
    rep.collect_sections = lambda: {"build": {"service": "scheduler"}}
    flows.account("file", "parent", 4096)
    payload, cur = rep.build_payload()
    assert payload["full"] and payload["build"] == {"service": "scheduler"}
    assert payload["counters"] == cur["counters"]
    assert payload["flows"]["planes"]["file"]["bytes"]["parent"] >= 4096
    rep.collect_sections = lambda: 1 / 0
    payload, _ = rep.build_payload()
    assert "build" not in payload and "counters" in payload
    assert rep.push_once()
