"""Host stat collection for the daemon announcer.

Counterpart of the reference's ``client/hostinfo.py``.

Role parity: upstream client/daemon/announcer/announcer.go:158-303 —
the daemon ships full CPU/memory/network/disk stats (gopsutil there,
psutil/procfs here) with every AnnounceHost, which is what populates the
Download records' host columns and 5 of the 12 MLP pair features
(cpu.percent, memory.used_percent, tcp connection counts,
disk.used_percent). Without this the model trains on dead inputs.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

try:
    import psutil

    # one process handle reused across samples: cpu_percent(interval=None)
    # measures the delta since the *same instance's* previous call — a
    # fresh Process() every sample would report 0.0 forever
    _PROC = psutil.Process()
    _PROC.cpu_percent(interval=None)  # establish the baseline sample
    psutil.cpu_percent(interval=None)
except ImportError:  # pragma: no cover - psutil is in this image
    psutil = None
    _PROC = None


@dataclass
class CpuStats:
    logical_count: int = 0
    physical_count: int = 0
    percent: float = 0.0
    process_percent: float = 0.0


@dataclass
class MemoryStats:
    total: int = 0
    available: int = 0
    used: int = 0
    used_percent: float = 0.0
    process_used_percent: float = 0.0
    free: int = 0


@dataclass
class NetworkStats:
    tcp_connection_count: int = 0
    upload_tcp_connection_count: int = 0


@dataclass
class DiskStats:
    total: int = 0
    free: int = 0
    used: int = 0
    used_percent: float = 0.0
    inodes_total: int = 0
    inodes_used: int = 0
    inodes_used_percent: float = 0.0


@dataclass
class HostStats:
    cpu: CpuStats = field(default_factory=CpuStats)
    memory: MemoryStats = field(default_factory=MemoryStats)
    network: NetworkStats = field(default_factory=NetworkStats)
    disk: DiskStats = field(default_factory=DiskStats)


def collect(data_dir: str = "/", upload_ports: tuple[int, ...] = ()) -> HostStats:
    """One stats sample. ``upload_ports`` classifies established TCP
    connections terminating at the daemon's upload/gRPC ports as upload
    connections (upstream announcer.go tcp stat split)."""
    s = HostStats()
    if psutil is not None:
        s.cpu.logical_count = psutil.cpu_count(logical=True) or 0
        s.cpu.physical_count = psutil.cpu_count(logical=False) or 0
        # interval=None: delta since the previous call — non-blocking
        s.cpu.percent = psutil.cpu_percent(interval=None)
        try:
            s.cpu.process_percent = _PROC.cpu_percent(interval=None)
            s.memory.process_used_percent = _PROC.memory_percent()
        except psutil.Error:  # pragma: no cover - racing process teardown
            pass
        vm = psutil.virtual_memory()
        s.memory.total = vm.total
        s.memory.available = vm.available
        s.memory.used = vm.used
        s.memory.used_percent = vm.percent
        s.memory.free = vm.free
        tcp_total, tcp_upload = _tcp_counts(upload_ports)
        s.network.tcp_connection_count = tcp_total
        s.network.upload_tcp_connection_count = tcp_upload
    try:
        st = os.statvfs(data_dir)
        s.disk.total = st.f_blocks * st.f_frsize
        s.disk.free = st.f_bavail * st.f_frsize
        s.disk.used = s.disk.total - st.f_bfree * st.f_frsize
        if s.disk.total > 0:
            s.disk.used_percent = 100.0 * s.disk.used / s.disk.total
        s.disk.inodes_total = st.f_files
        s.disk.inodes_used = st.f_files - st.f_ffree
        if s.disk.inodes_total > 0:
            s.disk.inodes_used_percent = 100.0 * s.disk.inodes_used / s.disk.inodes_total
    except OSError:  # pragma: no cover - data_dir vanished
        pass
    return s


def _tcp_counts(upload_ports: tuple[int, ...]) -> tuple[int, int]:
    """(established TCP connections, of which terminate at upload_ports).
    Reads /proc/net/tcp* directly — psutil.net_connections needs broad
    /proc access that may be restricted; procfs text is always there on
    Linux."""
    total = upload = 0
    ports = set(upload_ports)
    for path in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(path) as f:
                next(f)  # header
                for line in f:
                    fields = line.split()
                    if len(fields) < 4 or fields[3] != "01":  # 01 = ESTABLISHED
                        continue
                    total += 1
                    try:
                        local_port = int(fields[1].rsplit(":", 1)[1], 16)
                    except (IndexError, ValueError):
                        continue
                    if local_port in ports:
                        upload += 1
        except OSError:
            continue
    return total, upload
