"""The port's ``tools/dfstat.py`` against the reference's.

- The same reports (two scheduler shards, one gone stale, with their
  swarm sections and observatory rollups; a trainer; a daemon with its
  flow ledger) folded by both packages' ``TelemetryPlane`` at the same
  clock give snapshots that ``render`` turns into the same text in every
  window; so does the reference's hand-built snapshot of
  ``tests/test_telemetry.py``'s ``test_dfstat_render``.
- ``fetch`` and ``main --once`` read the port's ``ManagerServer`` REST
  (``/api/v1/telemetry``).
"""

import pytest

from dragonfly2_torch.manager.server import ManagerServer, ManagerServerConfig
from dragonfly2_torch.manager.telemetry import TelemetryPlane as TPlane
from dragonfly2_torch.tools import dfstat as t_dfstat
from dragonfly2_tpu.manager.telemetry import TelemetryPlane as JPlane
from dragonfly2_tpu.tools import dfstat as j_dfstat

T0 = 1_700_000_000.0


def _hist(n: int) -> dict:
    edges = {"0.005": 0.4 * n, "0.05": 0.9 * n, "0.5": n, "+Inf": n}
    return {"buckets": edges, "count": n}


def _scheduler(step: int, shard: str, peers: int) -> dict:
    payload = {
        "full": step == 0,
        "counters": {
            "dragonfly_scheduler_schedule_total{result=ok}": 40.0 * step,
            "dragonfly_scheduler_announce_peer_total": 15.0 * step,
        },
        "gauges": {"dragonfly_scheduler_peers": float(peers), "dragonfly_scheduler_tasks": 2.0},
        "hists": {"dragonfly_scheduler_schedule_duration_seconds": _hist(30 * step)},
        "swarms": [
            {"task_id": f"task-{shard[-1]}-{i}", "peers": peers, "seeders": 1, "done_pieces": 3 * step + i,
             "total_pieces": 8, "stragglers": ["peer-slow"] if i else []}
            for i in range(2)
        ],
        "swarm_rollup": {"tasks": 2, "peers": peers, "depth_hist": {"0": 1, "1": peers - 1}, "stragglers": 1},
    }
    return payload


def _trainer(step: int) -> dict:
    return {
        "full": step == 0,
        "counters": {
            "dragonfly_trainer_ingest_records_total": 1000.0 * step,
            "dragonfly_trainer_dataset_bytes_total": 4096.0 * step,
        },
        "gauges": {"dragonfly_trainer_last_fit_timestamp_seconds": T0 - 42.0},
    }


def _daemon(step: int) -> dict:
    return {
        "full": step == 0,
        "counters": {
            "dragonfly_flow_bytes_total{plane=image}": 6000.0 * step,
            "dragonfly_flow_p2p_bytes_total": 4000.0 * step,
            "dragonfly_flow_origin_bytes_total": 2000.0 * step,
        },
        "flows": {
            "planes": {
                "image": {"bytes": {"origin": 100 * step, "parent": 300 * step, "dedup": 50 * step,
                                    "local_cache": 0, "preheat": 0},
                          "served_bytes": 450 * step, "upload_bytes": 300 * step},
                "object": {"bytes": {"origin": 0, "parent": 64 * step, "dedup": 0, "local_cache": 64 * step,
                                     "preheat": 0},
                           "served_bytes": 128 * step, "upload_bytes": 0},
            }
        },
    }


def _fold(plane) -> dict:
    """Four pushes from each reporter 10 s apart; shard b stops after its
    second, so it is stale by the snapshot."""
    for step in range(4):
        now = T0 + 10.0 * step
        for shard, peers in (("10.0.0.1:8002", 5), ("10.0.0.2:8002", 3)):
            if shard.startswith("10.0.0.2") and step > 1:
                continue
            plane.apply("scheduler", shard, shard, "e1", step + 1, 10.0, _scheduler(step, shard, peers), now=now)
        plane.apply("trainer", "10.0.0.3:9000", "", "e1", step + 1, 10.0, _trainer(step), now=now)
        plane.apply("daemon", "d1", "", "e1", step + 1, 10.0, _daemon(step), now=now)
    return plane.snapshot(now=T0 + 45.0)


# tests/test_telemetry.py::test_dfstat_render's snapshot
HAND_BUILT = {
    "cluster": {"schedule_ops_per_s": {"1m": 12.5}, "peers": 4, "tasks": 2},
    "services": [{}, {}],
    "slos": [
        {"name": "download_success", "objective": 0.99, "burn": {"5m": 7.0, "1h": 3.0}, "breached": True},
        {"name": "schedule_p99", "objective": 0.99, "burn": {"5m": 0.0, "1h": 0.0}, "breached": False},
    ],
    "shards": [
        {"shard": "10.0.0.1:8002", "stale": False, "schedule_ops_per_s": {"1m": 10.0},
         "announce_ops_per_s": {"1m": 3.0}, "decision_p99_ms": 4.2, "peers": 3, "tasks": 2},
        {"shard": "10.0.0.2:8002", "stale": True, "schedule_ops_per_s": {"1m": 0.0},
         "announce_ops_per_s": {"1m": 0.0}, "decision_p99_ms": 0.0, "peers": 0, "tasks": 0},
    ],
    "swarms": [
        {"task_id": "task-abc", "peers": 3, "seeders": 1, "done_pieces": 9, "total_pieces": 4,
         "stragglers": ["peer-slow"]},
    ],
    "trainers": [
        {"instance": "10.0.0.3:9000", "stale": False, "ingest_records_per_s": {"1m": 1000.0},
         "fit_freshness_s": 42.0},
    ],
    "daemons": [],
}


@pytest.mark.parametrize("window", ["1m", "5m", "1h"])
def test_render_of_folded_reports_matches_the_reference(window):
    t_snap, j_snap = _fold(TPlane()), _fold(JPlane())
    got = t_dfstat.render(t_snap, window=window)
    assert got == j_dfstat.render(j_snap, window=window)
    assert got == t_dfstat.render(j_snap, window=window)
    assert "scheduler shards" in got and "10.0.0.1:8002" in got and "stale" in got
    assert "shard swarms (observatory rollup)" in got and "task swarms" in got and "peer-slow" in got
    assert "trainers" in got and "daemons" in got and "traffic planes" in got
    lines = got.splitlines()
    image = next(line for line in lines if line.startswith("image"))
    # parent + dedup over every provenance: (300 + 50) / 450 of the last push
    assert image.split()[-1] == "0.78"


def test_render_of_the_hand_built_snapshot_matches_the_reference():
    got = t_dfstat.render(HAND_BUILT)
    assert got == j_dfstat.render(HAND_BUILT)
    assert "BREACH" in got and "download_success" in got and "42s" in got and "ok" in got
    assert t_dfstat.render({}) == j_dfstat.render({})


def test_fetch_and_main_read_the_port_manager(tmp_path, capsys):
    manager = ManagerServer(ManagerServerConfig(data_dir=str(tmp_path / "manager"), rest_port=0,
                                                db_cache_ttl=0.0, issue_certs=False))
    manager.serve()
    try:
        _fold(manager.telemetry)
        snap = t_dfstat.fetch(manager.rest_addr)
        assert {s["shard"] for s in snap["shards"]} == {"10.0.0.1:8002", "10.0.0.2:8002"}
        again = j_dfstat.fetch(f"http://{manager.rest_addr}")
        assert {k: v for k, v in snap.items() if k != "ts"} == {k: v for k, v in again.items() if k != "ts"}
        assert t_dfstat.main(["--manager", manager.rest_addr, "--once", "--window", "5m"]) == 0
        out = capsys.readouterr().out
        assert "10.0.0.1:8002" in out and "sched/s[5m]" in out
    finally:
        manager.stop()
    assert t_dfstat.main(["--manager", manager.rest_addr, "--once"]) == 1
    assert "unreachable" in capsys.readouterr().err
