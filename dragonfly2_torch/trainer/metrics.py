"""Trainer Prometheus series (counterpart of the reference's
``trainer/metrics.py``; upstream trainer/metrics/metrics.go plus fit
duration and ingest visibility). The jit-witness counters of the
reference have no counterpart: eager PyTorch compiles nothing."""

from dragonfly2_torch.utils.metrics import default_registry as _r

TRAIN_TOTAL = _r.counter("trainer_train_total", "Train RPC streams accepted")
TRAIN_FAILURE_TOTAL = _r.counter(
    "trainer_train_failure_total", "Train RPC streams that failed"
)
FIT_TOTAL = _r.counter("trainer_fit_total", "Model fits", ("model", "outcome"))
FIT_DURATION = _r.histogram(
    "trainer_fit_duration_seconds", "Fit wall time", ("model",),
    buckets=(0.1, 0.5, 1, 5, 15, 60, 300, 1200, 3600, float("inf")),
)
INGEST_RECORDS_TOTAL = _r.counter(
    "trainer_ingest_records_total", "Download records decoded for training"
)
# live pipeline splits of the streaming train loop (trainer/ingest.py),
# observed per shard / per superbatch while a fit runs: the same
# decode/transfer/compute attribution StreamStats totals per run
_INGEST_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, float("inf"),
)
INGEST_DECODE_WAIT_SECONDS = _r.histogram(
    "trainer_ingest_decode_wait_seconds",
    "Packing thread blocked on the decode queue, per shard",
    buckets=_INGEST_BUCKETS,
)
INGEST_H2D_SECONDS = _r.histogram(
    "trainer_ingest_h2d_seconds",
    "Host-to-device superbatch transfer, copy issued to copy complete",
    buckets=_INGEST_BUCKETS,
)
INGEST_STEP_SECONDS = _r.histogram(
    "trainer_ingest_step_seconds",
    "Train-step dispatch + prior-step confirmation, per superbatch",
    buckets=_INGEST_BUCKETS,
)
INGEST_BUFFER_WAIT_SECONDS = _r.histogram(
    "trainer_ingest_buffer_wait_seconds",
    "Packing thread blocked on the superbatch buffer pool, per superbatch",
    buckets=_INGEST_BUCKETS,
)
DATASET_BYTES_TOTAL = _r.counter(
    "trainer_dataset_bytes_total", "Dataset bytes received on Train streams", ("kind",)
)
# unix timestamp of the last successful fit per model (fit freshness =
# now - value; 0 = never)
LAST_FIT_TIMESTAMP = _r.gauge(
    "trainer_last_fit_timestamp_seconds",
    "Unix time of the last successful fit",
    ("model",),
)
