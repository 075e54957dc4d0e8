"""Feature schema the port needs (own copy of the reference's
``schema/features.py`` names and its ``location_affinity``; the offline
extraction code comes with the trainer slice)."""

from __future__ import annotations

import numpy as np

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

# Maximum "|"-separated location element depth scored for affinity
# (upstream evaluator_base.go maxElementLen).
MAX_LOCATION_DEPTH = 5


def location_affinity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Shared leading "|"-separated path depth / MAX_LOCATION_DEPTH, elementwise."""
    out = np.zeros(a.shape, dtype=np.float32)
    flat_a, flat_b, flat_o = a.ravel(), b.ravel(), out.ravel()
    # memoize on the (src, dst) string pair — cardinality is tiny vs. N
    cache: dict[tuple[str, str], float] = {}
    for i in range(flat_a.shape[0]):
        key = (flat_a[i], flat_b[i])
        v = cache.get(key)
        if v is None:
            pa, pb = key[0].split("|"), key[1].split("|")
            depth = 0
            if key[0] and key[1]:
                for x, y in zip(pa[:MAX_LOCATION_DEPTH], pb[:MAX_LOCATION_DEPTH]):
                    if x != y:
                        break
                    depth += 1
            v = depth / MAX_LOCATION_DEPTH
            cache[key] = v
        flat_o[i] = v
    return out
