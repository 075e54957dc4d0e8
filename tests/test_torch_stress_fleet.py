"""The port's shard-kill soak (``tools/stress.shard_kill_soak``) on the CPU,
at the reference's test size and with every assertion of
``tests/test_stress_tool.py``'s shard-kill tests, plus the lossless-failover
gates of the reference's CLI: 3 scheduler processes of the port
(``python -m dragonfly2_torch.scheduler --set device=cpu``) under KV leases,
simulated announce load, one SIGKILLed mid-load, the manager's view of the
kill, and the replicated arm against the rebuild arm. In a file of its own:
the two soaks take about a minute."""

import json

import pytest
import torch

from dragonfly2_torch.tools import stress
from dragonfly2_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # the soak's in-process manager starts the port's stack sampler and
    # leaves it running, as a manager process would; stop it once the
    # module is done so its sweeps do not tax the files run after it
    yield
    profiling.stop()


def test_shard_kill_soak_success_and_bounded_blackout():
    """``tests/test_stress_tool.py::test_shard_kill_soak_success_and_bounded_blackout``
    on the port, with the CLI's lossless-failover gates."""
    lease_ttl, poll = 1.5, 0.3
    probes: list = []
    stats = stress.shard_kill_soak(
        peers=60,
        shards=3,
        workers=8,
        lease_ttl=lease_ttl,
        renew_interval=0.4,
        poll_interval=poll,
        device="cpu",
        probes=probes,
    )
    assert stats["fleet_success_rate"] == 1.0, stats
    assert stats["fleet_hangs"] == 0
    assert stats["fleet_shards"] == 3
    assert 0 <= stats["fleet_blackout_ms"] <= (lease_ttl + poll + 3.0) * 1e3, stats
    assert stats["schedule_ops_per_s"] > 0
    assert stats["fleet_wrong_shard_retries"] > 0  # the window was real
    assert "fleet_telemetry_error" not in stats, stats
    assert stats["fleet_manager_shards"] == 3
    assert 3_000 <= stats["fleet_manager_blackout_ms"] <= 9_000, stats
    assert stats["fleet_manager_schedule_ops_per_s"] > 0
    # the reference CLI's lossless-failover gates
    assert stats["swarm_adopt_outcome"] == "adopted", stats
    assert stats["fleet_victim_fallbacks"] == 0, stats
    assert stats["swarm_replica_diff_clean"] == 1, stats
    assert 0 <= stats["fleet_blackout_ms_replicated"] < stats["fleet_blackout_ms_rebuild"], stats
    assert stress.shard_kill_gates(stats)
    # both arms' shards: the port's scheduler on the CPU, no device probe
    assert len(probes) == 6
    assert all("scheduler.fleet" in p and "scheduler.device" not in p for p in probes)
    json.dumps(stats)


def test_shard_kill_cli_gates_on_success(capsys):
    rc = stress.main(["--chaos", "--shard-kill", "--shard-peers", "30", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    parsed = json.loads(line)
    assert rc == 0, parsed
    assert parsed["fleet_success_rate"] == 1.0
    assert parsed["swarm_replica_diff_clean"] == 1 and parsed["fleet_victim_fallbacks"] == 0

