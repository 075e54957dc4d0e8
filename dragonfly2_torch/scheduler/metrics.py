"""Scheduler Prometheus series the decision path and the preheat plane
feed — the schedule, scoring-service, wave and preheat series of the
reference's ``scheduler/metrics.py`` (the announce, register, piece and
record series come with the server slice)."""

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

# -- predictive preheat plane (dragonfly2_torch/preheat/): demand folding,
# forecast sweeps, planned tasks and the jobs they ride ---------------------
PREHEAT_SWEEPS_TOTAL = _r.counter(
    "scheduler_preheat_sweeps_total",
    "Planner sweeps by outcome",
    ("outcome",),  # planned | empty | error
)
PREHEAT_JOBS_TOTAL = _r.counter(
    "scheduler_preheat_jobs_total",
    "Preheat jobs submitted by the planner, by outcome",
    ("outcome",),  # succeeded | failed
)
PREHEAT_TASKS_PLANNED_TOTAL = _r.counter(
    "scheduler_preheat_tasks_planned_total",
    "Forecast-hot tasks picked for seed placement",
)
PREHEAT_FORECASTS_TOTAL = _r.counter(
    "scheduler_preheat_forecasts_total",
    "Per-task demand forecasts served by the GRU forecaster",
)
PREHEAT_SKIPPED_TOTAL = _r.counter(
    "scheduler_preheat_skipped_total",
    "Forecast-hot tasks the planner declined",
    ("reason",),  # held | inflight | cooldown | budget | no_url
)
PREHEAT_DEMAND_TASKS = _r.gauge(
    "scheduler_preheat_demand_tasks", "Task series resident in the demand window"
)
PREHEAT_DEMAND_OBSERVED_TOTAL = _r.counter(
    "scheduler_preheat_demand_observed_total",
    "Demand observations folded into the window, by source",
    ("source",),  # record | layer
)
PREHEAT_DEMAND_DROPPED_TOTAL = _r.counter(
    "scheduler_preheat_demand_dropped_total",
    "Demand arrivals refused at the window's task cap",
)
PREHEAT_SWEEP_SECONDS = _r.histogram(
    "scheduler_preheat_sweep_seconds",
    "Whole planner sweep wall (forecast + plan + job submit)",
    buckets=(1e-3, 5e-3, 0.02, 0.1, 0.5, 2.0, 10.0),
)
