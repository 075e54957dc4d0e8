"""Daemon Prometheus series (counterpart of the reference's
``client/metrics.py``; upstream client daemon metrics: piece traffic by
type, proxy requests, upload serving)."""

from dragonfly2_torch.utils.metrics import default_registry as _r

PIECE_DOWNLOADED_TOTAL = _r.counter(
    "daemon_piece_downloaded_total", "Pieces written locally", ("traffic_type",)
)
PIECE_TRAFFIC_BYTES = _r.counter(
    "daemon_piece_traffic_bytes_total", "Bytes written locally", ("traffic_type",)
)
PIECE_UPLOADED_TOTAL = _r.counter(
    "daemon_piece_uploaded_total", "Pieces served to children over HTTP"
)
PIECE_UPLOAD_BYTES = _r.counter(
    "daemon_piece_upload_bytes_total", "Bytes served to children over HTTP"
)
TASK_TOTAL = _r.counter("daemon_task_total", "Peer tasks started", ("type",))
TASK_FAILURE_TOTAL = _r.counter("daemon_task_failure_total", "Peer tasks failed")
BACK_TO_SOURCE_TOTAL = _r.counter(
    "daemon_back_to_source_total", "Tasks that fell back to the origin"
)
PROXY_REQUEST_TOTAL = _r.counter(
    "daemon_proxy_request_total", "Proxy requests", ("route",)
)
# --- zero-copy data plane (docs/data-plane.md) ---
CHILD_DISCONNECT_TOTAL = _r.counter(
    "daemon_child_disconnect_total",
    "Child peers that dropped the connection mid-response",
)
UPLOAD_CONNECTIONS = _r.gauge(
    "daemon_upload_connections", "Live child connections on the upload loop"
)
PIECE_DEDUP_TOTAL = _r.counter(
    "daemon_piece_dedup_total",
    "Pieces stored as content-addressed refs instead of a second copy",
)
PIECE_DEDUP_BYTES = _r.counter(
    "daemon_piece_dedup_bytes_total", "Bytes saved by content-addressed dedup"
)
PIECE_DEDUP_MIGRATE_TOTAL = _r.counter(
    "daemon_piece_dedup_migrate_total",
    "Owner-piece migrations performed by refcount-safe GC",
)
P2P_INFLIGHT_SHED_TOTAL = _r.counter(
    "daemon_p2p_inflight_shed_total",
    "Transport requests sent direct because the P2P in-flight bound was hit",
)
