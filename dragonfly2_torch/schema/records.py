"""Host-stat record shapes the scheduler's resource model holds (own copy
of the dataclasses of the reference's ``schema/records.py`` that
``scheduler/resource/host.py`` imports; the training-record schemas come
with the trainer slice)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CPUTimes:
    user: float = 0.0
    system: float = 0.0
    idle: float = 0.0
    nice: float = 0.0
    iowait: float = 0.0
    irq: float = 0.0
    softirq: float = 0.0
    steal: float = 0.0
    guest: float = 0.0
    guest_nice: float = 0.0


@dataclass
class CPU:
    logical_count: int = 0
    physical_count: int = 0
    percent: float = 0.0
    process_percent: float = 0.0
    times: CPUTimes = field(default_factory=CPUTimes)


@dataclass
class Memory:
    total: int = 0
    available: int = 0
    used: int = 0
    used_percent: float = 0.0
    process_used_percent: float = 0.0
    free: int = 0


@dataclass
class Network:
    tcp_connection_count: int = 0
    upload_tcp_connection_count: int = 0
    location: str = ""
    idc: str = ""


@dataclass
class Disk:
    total: int = 0
    free: int = 0
    used: int = 0
    used_percent: float = 0.0
    inodes_total: int = 0
    inodes_used: int = 0
    inodes_free: int = 0
    inodes_used_percent: float = 0.0


@dataclass
class Build:
    git_version: str = ""
    git_commit: str = ""
    go_version: str = ""
    platform: str = ""
