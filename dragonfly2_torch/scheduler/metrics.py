"""Scheduler Prometheus series the decision path feeds — the schedule,
scoring-service and wave series of the reference's ``scheduler/metrics.py``
(the announce, register, piece, record and preheat series come with the
server slice)."""

from dragonfly2_torch.utils.metrics import default_registry as _r

SCHEDULE_DURATION = _r.histogram(
    "scheduler_schedule_duration_seconds", "Candidate-parent scheduling latency"
)
SCHEDULE_TOTAL = _r.counter(
    "scheduler_schedule_total", "Scheduling decisions", ("outcome",)
)
CONCURRENT_SCHEDULE_GAUGE = _r.gauge(
    "scheduler_concurrent_schedule", "Scheduling passes in flight"
)

# -- batched scoring service (scheduler/serving.py) -------------------------
SERVING_SUBMITTED_TOTAL = _r.counter(
    "scheduler_serving_submitted_total",
    "Candidate-matrix score submissions by path",
    ("path",),  # batched | immediate | overflow
)
SERVING_BATCHES_TOTAL = _r.counter(
    "scheduler_serving_batches_total", "Micro-batches scored by the serving thread"
)
SERVING_BATCH_OCCUPANCY = _r.histogram(
    "scheduler_serving_batch_occupancy",
    "Candidate feature rows packed per scored micro-batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
SERVING_ERRORS_TOTAL = _r.counter(
    "scheduler_serving_errors_total", "Serving-path score failures (per request)"
)
SERVING_QUEUE_DEPTH = _r.gauge(
    "scheduler_serving_queue_depth",
    "Submission queue depth observed at batch pack time",
)
SERVING_SWAPS_TOTAL = _r.counter(
    "scheduler_serving_swaps_total", "Served-model hot swaps", ("kind",)
)
SERVING_FALLBACK_TOTAL = _r.counter(
    "scheduler_serving_fallback_total",
    "Evaluator degradation-ladder rung drops",
    ("to",),  # mlp | base
)

# -- wave scheduling (scheduler/wave.py): W decisions × C candidates packed
# into one scoring dispatch; occupancy is rows = Σ wave sizes --------------
WAVE_DECISIONS_TOTAL = _r.counter(
    "scheduler_wave_decisions_total",
    "Scheduling decisions submitted via wave packing, by path",
    ("path",),  # batched | immediate | overflow
)
WAVE_OCCUPANCY_ROWS = _r.histogram(
    "scheduler_wave_occupancy_rows",
    "Candidate rows (Σ wave sizes) per scored wave batch",
    buckets=(8, 16, 32, 64, 128, 256, 512, 1024),
)
WAVE_UNPACK_SECONDS = _r.histogram(
    "scheduler_wave_unpack_seconds",
    "Segment-rank unpack wall per wave request",
    buckets=(1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 2e-2),
)
