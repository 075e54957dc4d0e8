"""Manager Prometheus series (counterpart of the reference's
``manager/metrics.py``; upstream manager/metrics: request
volumes on the control-plane surfaces)."""

from dragonfly2_torch.utils.metrics import default_registry as _r

GRPC_REQUEST_TOTAL = _r.counter(
    "manager_grpc_request_total", "gRPC requests", ("method",)
)
REST_REQUEST_TOTAL = _r.counter(
    "manager_rest_request_total", "REST requests", ("method", "status")
)
KEEPALIVE_TOTAL = _r.counter(
    "manager_keepalive_total", "Keepalive messages", ("source_type",)
)
MODEL_CREATED_TOTAL = _r.counter(
    "manager_model_created_total", "Models uploaded by trainers", ("type",)
)

# -- cluster telemetry plane (manager/telemetry.py, docs/telemetry.md) --
TELEMETRY_REPORTS_TOTAL = _r.counter(
    "manager_telemetry_reports_total",
    "Telemetry reports received, by outcome",
    ("service", "outcome"),  # outcome: applied | registered | duplicate
)
TELEMETRY_REPORTERS = _r.gauge(
    "manager_telemetry_reporters",
    "Reporters known to the telemetry plane",
    ("service",),
)
SLO_BURN_RATE = _r.gauge(
    "manager_slo_burn_rate",
    "Error-budget burn rate per SLO and evaluation window",
    ("slo", "window"),
)
SLO_BREACHED = _r.gauge(
    "manager_slo_breached",
    "1 while the SLO's multi-window burn rate is in breach",
    ("slo",),
)
