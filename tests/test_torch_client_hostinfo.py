"""The reference's ``tests/test_hostinfo.py``, case for case, on the port's
modules (``dragonfly2_torch``).

Host stat collection: the daemon must announce live CPU/mem/disk/net
stats (reference client/daemon/announcer/announcer.go:158-303) — these
populate the Download records' host columns and 5 of the 12 MLP pair
features, so dead zeros here mean the model trains on degenerate inputs.
"""

import pytest

from dragonfly2_torch.client import hostinfo
from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_torch.utils import profiling as t_profiling
from dragonfly2_tpu.utils import profiling as j_profiling


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # each package's daemons and servers start its process-wide stack sampler
    # and leave it running, as a server process would; stop both once the
    # module is done so their sweeps do not tax the files run after it in
    # this process
    yield
    t_profiling.stop()
    j_profiling.stop()


def test_collect_returns_live_stats(tmp_path):
    s = hostinfo.collect(data_dir=str(tmp_path))
    assert s.cpu.logical_count > 0
    assert s.memory.total > 0
    assert s.memory.used_percent > 0
    assert s.disk.total > 0
    assert 0 <= s.disk.used_percent <= 100
    # an established TCP connection exists on any box running a test rig;
    # at minimum the count parses without error
    assert s.network.tcp_connection_count >= 0


def test_host_info_carries_stats(tmp_path):
    d = Daemon(
        DaemonConfig(data_dir=str(tmp_path / "d"), scheduler_address="unused")
    )
    info = d.host_info()
    assert info.memory.total > 0
    assert info.memory.used_percent > 0
    assert info.disk.total > 0
    assert info.cpu.logical_count > 0


def test_host_stats_override(tmp_path):
    d = Daemon(
        DaemonConfig(
            data_dir=str(tmp_path / "d"),
            scheduler_address="unused",
            host_stats_override={
                "cpu.percent": 87.5,
                "memory.used_percent": 33.0,
                "network.tcp_connection_count": 41,
            },
        )
    )
    info = d.host_info()
    assert info.cpu.percent == 87.5
    assert info.memory.used_percent == 33.0
    assert info.network.tcp_connection_count == 41
    # non-overridden values still sampled live
    assert info.memory.total > 0


def test_host_stats_override_typo_fails_fast(tmp_path):
    """Regression: a typo'd override path must raise
    at daemon construction, not silently keep the sampled value."""
    import pytest

    from dragonfly2_torch.client.daemon import Daemon, DaemonConfig

    with pytest.raises(ValueError, match="unknown stat path"):
        Daemon(
            DaemonConfig(
                data_dir=str(tmp_path / "d"),
                scheduler_address="127.0.0.1:1",
                host_stats_override={"cpu.percnt": 90.0},  # typo
            )
        )
    with pytest.raises(ValueError, match="unknown stat path"):
        Daemon(
            DaemonConfig(
                data_dir=str(tmp_path / "d2"),
                scheduler_address="127.0.0.1:1",
                host_stats_override={"gpu.percent": 90.0},  # no such group
            )
        )
    # valid path still constructs
    d = Daemon(
        DaemonConfig(
            data_dir=str(tmp_path / "d3"),
            scheduler_address="127.0.0.1:1",
            host_stats_override={"cpu.percent": 90.0},
        )
    )
    assert d.host_stats().cpu.percent == 90.0


def test_inodes_used_percent_round_trips_to_scheduler():
    """Train/serve parity for the inode-pressure feature: the daemon's
    announce carries disk.inodes_used_percent and the scheduler's host
    copy keeps it — otherwise the model trains on a signal serving
    always sees as 0."""
    from dragonfly2_torch.rpc import protos
    common_pb2 = protos.load("common_pb2")

    from dragonfly2_torch.client.hostinfo import HostStats
    from dragonfly2_torch.scheduler.service import _host_from_info

    stats = HostStats()
    assert stats.disk.inodes_used_percent == 0.0  # declared, not dynamic
    info = common_pb2.HostInfo(
        id="h1", disk=common_pb2.DiskStat(inodes_used_percent=37.5)
    )
    host = _host_from_info(info)
    assert host.disk.inodes_used_percent == 37.5


def test_host_stats_override_accepts_inodes_used_percent():
    from dragonfly2_torch.client.daemon import _apply_stat_overrides
    from dragonfly2_torch.client.hostinfo import HostStats

    s = HostStats()
    _apply_stat_overrides(s, {"disk.inodes_used_percent": 42.0})
    assert s.disk.inodes_used_percent == 42.0
