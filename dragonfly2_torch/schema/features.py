"""Feature schema constants the port needs (own copy of the reference's
``schema/features.py`` names; the extraction code is not ported)."""

from __future__ import annotations

MLP_FEATURE_NAMES = (
    "finished_piece_ratio",
    "upload_success_rate",
    "free_upload_ratio",
    "is_seed",
    "idc_match",
    "location_affinity",
    "cpu_percent",
    "mem_used_percent",
    "tcp_connection_log",
    "upload_tcp_connection_log",
    "disk_used_percent",
    "parent_succeeded",
    "cpu_process_percent",
    "mem_available_ratio",
    "inodes_used_percent",
    "child_cpu_percent",
    "child_mem_used_percent",
    "task_size_log",
    # live-topology signal: log1p(estimated child→parent RTT ms)/10, 0.0
    # when no estimate exists (TopologyEngine.rtt_affinity_pairs)
    "rtt_affinity",
)
MLP_FEATURE_DIM = len(MLP_FEATURE_NAMES)

GRU_FEATURE_DIM = 2  # [log1p(cost_ms), piece position / MAX_PIECES]
