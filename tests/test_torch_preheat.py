"""The port's preheat plane (dragonfly2_torch.preheat: the demand window,
the GRU demand forecaster, the planner's forecast→place sweep) against
the JAX package's on the CPU. The window folds the same observations into
the same series; the forecaster's horizon agrees with the reference's
jitted ``_forecast_horizon`` and with the numpy ``_np_forecast_horizon``
at ≤ 1e-3 (the reference's own tolerance); the planner behaves as the
reference's tests require, with a duck-typed job worker and manager, and
builds the same ``CreateJob`` request."""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_torch.models.gru import init_gru as t_init_gru
from dragonfly2_torch.preheat import forecast as t_forecast
from dragonfly2_torch.preheat.demand import DemandWindow
from dragonfly2_torch.preheat.forecast import DEMAND_FEATURE_DIM, DemandForecaster, demand_features
from dragonfly2_torch.preheat.planner import PreheatPlanner
from dragonfly2_torch.scheduler.model_refresher import PlainRequests, ProtoRequests
from dragonfly2_torch.schema import records as R
from dragonfly2_torch.trainer.serving import bucket_rows
from dragonfly2_torch.utils import faults, tracing
from dragonfly2_torch.utils.idgen import URLMeta, task_id_v1
from dragonfly2_torch.weights import gru_from_numpy, module_tree
from dragonfly2_tpu.models.gru import init_gru as j_init_gru
from dragonfly2_tpu.preheat import demand as j_demand
from dragonfly2_tpu.preheat import forecast as j_forecast
from dragonfly2_tpu.preheat import planner as j_planner

torch.set_num_threads(1)

FORECAST_TOL = 1e-3  # tests/test_preheat.py's, between its device and numpy paths


@pytest.fixture
def clean_faults():
    faults.clear()
    yield
    faults.clear()


def _numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


# ---------------------------------------------------------------------------
# demand window
# ---------------------------------------------------------------------------


def test_window_folds_counts_on_bucket_grid():
    w = DemandWindow(bucket_s=10.0, window_buckets=4)
    base = 1000.0  # bucket 100
    w.observe("t1", url="http://o/a", ts=base + 1)
    w.observe("t1", ts=base + 9)  # same bucket
    w.observe("t1", ts=base + 11, count=5.0)  # next bucket
    w.observe("t2", url="http://o/b", ts=base + 35)
    ids, urls, counts = w.series_batch(now=base + 35)
    assert ids == ["t1", "t2"]
    assert urls == ["http://o/a", "http://o/b"]
    assert counts.tolist() == [[2.0, 5.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]]
    assert counts.dtype == np.float32


def test_window_rolls_old_buckets_and_prunes_quiet_tasks():
    w = DemandWindow(bucket_s=1.0, window_buckets=3)
    w.observe("old", ts=100.0)
    w.observe("live", ts=100.0)
    w.observe("live", ts=104.0)
    ids, _, counts = w.series_batch(now=104.0)
    assert ids == ["live"]
    assert counts.tolist() == [[0.0, 0.0, 1.0]]
    assert w.task_count() == 1


def test_task_cap_drops_then_rearms_after_prune():
    from dragonfly2_torch.utils import flight

    since = time.time_ns()
    w = DemandWindow(bucket_s=1.0, window_buckets=2, max_tasks=2)
    assert w.observe("a", ts=100.0)
    assert w.observe("b", ts=100.0)
    assert not w.observe("c", ts=100.0)  # cap refused a NEW series
    assert not w.observe("d", ts=100.0)
    assert w.observe("a", ts=100.5)  # existing tasks always fold
    assert w.stats()["dropped"] == 2
    dropped = [
        e for e in flight.snapshot(["preheat"]).get("preheat", [])
        if e["type"] == "preheat.task_dropped" and e["ts_ns"] >= since
    ]
    assert len(dropped) == 1 and dropped[0]["cap"] == 2  # one transition event
    assert w.observe("c", ts=110.0)
    assert w.task_count() == 1
    assert w.observed == 4


def test_observe_record_and_layer_sources():
    w = DemandWindow(bucket_s=10.0, window_buckets=4)
    rec = R.DownloadRecord(
        id="d1", task=R.TaskRecord(id="task-9", url="http://origin/blob"), created_at=int(2000.0 * 1e9),
    )
    w.observe_record(rec)
    w.observe_layer("sha256:abcd", "http://reg/v2/img/blobs/sha256:abcd", ts=2000.0)
    ids, urls, counts = w.series_batch(now=2000.0)
    assert ids == ["sha256:abcd", "task-9"]
    assert urls[1] == "http://origin/blob"
    assert counts[:, -1].tolist() == [1.0, 1.0]


class _LiveTask:
    url = "http://origin/blob?sig=x"
    tag = "ml"
    application = "batch"
    filters = ["sig"]
    url_range = ""
    digest = "sha256:beef"


def test_observe_record_captures_live_task_meta():
    w = DemandWindow(bucket_s=10.0, window_buckets=4)
    rec = R.DownloadRecord(
        id="d1", task=R.TaskRecord(id="task-9", url="http://origin/blob"), created_at=int(2000.0 * 1e9),
    )
    w.observe_record(rec, task=_LiveTask())
    assert w.meta_for("task-9") == {
        "tag": "ml", "application": "batch", "filter": "sig", "digest": "sha256:beef",
    }
    _, urls, _ = w.series_batch(now=2000.0)
    assert urls == ["http://origin/blob?sig=x"]


def test_observe_layer_keys_on_task_id_when_known():
    w = DemandWindow(bucket_s=10.0, window_buckets=4)
    w.observe_layer(
        "sha256:abcd", "http://mirror/v2/img/blobs/sha256:abcd", ts=3000.0,
        task_id="a" * 64, meta={"tag": "registry"},
    )
    ids, _, _ = w.series_batch(now=3000.0)
    assert ids == ["a" * 64]
    assert w.meta_for("a" * 64) == {"tag": "registry"}
    assert w.meta_for("unknown") == {}


def test_window_matches_the_reference_on_a_seeded_stream():
    rng = np.random.default_rng(4)
    t_w = DemandWindow(bucket_s=5.0, window_buckets=8, max_tasks=40)
    j_w = j_demand.DemandWindow(bucket_s=5.0, window_buckets=8, max_tasks=40)
    ts = 10_000.0
    for _ in range(600):
        ts += float(rng.exponential(0.4))
        tid = f"task-{int(rng.zipf(1.6)) % 60}"
        kw = dict(url=f"http://o/{tid}", ts=ts, count=float(rng.integers(1, 4)),
                  meta={"tag": "t" if rng.random() < 0.5 else ""})
        assert t_w.observe(tid, **kw) == j_w.observe(tid, **kw)
    for now in (ts, ts + 12.0, ts + 39.0):
        got, want = t_w.series_batch(now=now), j_w.series_batch(now=now)
        assert got[0] == want[0] and got[1] == want[1] and np.array_equal(got[2], want[2])
        assert t_w.stats() == j_w.stats()
    assert all(t_w.meta_for(t) == j_w.meta_for(t) for t in got[0])


# ---------------------------------------------------------------------------
# forecaster
# ---------------------------------------------------------------------------


def _ramping_window(n_hot=4, n_cold=4, t=12, seed=0):
    """[N, T] counts: hot rows ramp upward, cold rows stay sparse."""
    rng = np.random.default_rng(seed)
    hot = np.arange(1.0, t + 1.0)[None, :] * (1.0 + rng.random((n_hot, 1)))
    cold = (rng.random((n_cold, t)) < 0.15).astype(np.float64) * 0.5
    return np.concatenate([hot, cold]).astype(np.float32)


def test_forecaster_cold_serves_zeros():
    f = DemandForecaster(window_buckets=8, device="cpu")
    assert not f.ready
    assert f.forecast_demand(np.ones((3, 8), np.float32)).tolist() == [0.0, 0.0, 0.0]
    assert f.forecast_demand(np.zeros((0, 8), np.float32)).shape == (0,)
    assert f.forecast_demand_np(np.ones((2, 8), np.float32)).tolist() == [0.0, 0.0]


def test_fit_ranks_hot_above_cold_and_the_plain_version_agrees():
    counts = _ramping_window(t=12)
    f = DemandForecaster(window_buckets=12, horizon=3, epochs=6, min_examples=4, device="cpu")
    metrics = f.fit(counts)
    assert metrics is not None and f.ready and f.fits == 1
    scores = f.forecast_demand(counts)
    assert scores.shape == (8,)
    assert scores[:4].min() > scores[4:].max()
    np.testing.assert_allclose(scores, f.forecast_demand_np(counts), atol=FORECAST_TOL)
    assert f.stats()["backend"] == "cpu" and f.forecasts == 8


def test_fit_returns_none_on_quiet_window():
    f = DemandForecaster(window_buckets=8, min_examples=4, device="cpu")
    assert f.fit(np.zeros((4, 8), np.float32)) is None
    assert not f.ready


def test_demand_features_fixed_history_rung():
    f = DemandForecaster(window_buckets=12, horizon=3, device="cpu")
    assert f.hist_rows == bucket_rows(12 + 3) == 16
    feats = demand_features(np.ones((2, 12), np.float32), f.hist_rows)
    assert feats.shape == (2, 16, DEMAND_FEATURE_DIM)
    assert feats[0, 11, 0] == pytest.approx(np.log1p(1.0))
    assert feats[0, 12:, 0].tolist() == [0.0] * 4
    np.testing.assert_array_equal(feats, j_forecast.demand_features(np.ones((2, 12), np.float32), 16))


def test_horizon_must_be_positive_and_device_defaults_to_the_card():
    with pytest.raises(ValueError):
        DemandForecaster(window_buckets=8, horizon=0, device="cpu")
    if torch.cuda.is_available():
        assert DemandForecaster(window_buckets=8).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            DemandForecaster(window_buckets=8)


@pytest.mark.parametrize("horizon,window,n,t_real", [(3, 12, 8, 12), (1, 8, 3, 5), (5, 30, 20, 30), (3, 32, 70, 32)])
def test_forecast_horizon_matches_the_references_both_versions(horizon, window, n, t_real):
    """The port's horizon on the CPU against the reference's jitted one and
    both numpy versions, on one padded feature tensor: ≤ 1e-3."""
    hist = bucket_rows(window + horizon)
    rows = bucket_rows(n)
    counts = np.abs(np.random.default_rng(n).normal(3.0, 2.0, (n, t_real))).astype(np.float32)
    feats = np.zeros((rows, hist, DEMAND_FEATURE_DIM), np.float32)
    feats[:n] = demand_features(counts, hist)
    tree = _numpy(j_init_gru(jax.random.PRNGKey(horizon), DEMAND_FEATURE_DIM, 16))
    tree["head"]["layers"][-1]["b"] = np.full((1,), 1.2, np.float32)
    model = gru_from_numpy(tree, device="cpu")
    before = feats.copy()
    got = t_forecast._forecast_horizon(horizon, model, torch.from_numpy(feats), n, t_real).numpy()
    assert np.array_equal(feats, before)  # the writes went to a copy
    want = np.asarray(j_forecast._forecast_horizon(horizon, tree, jnp.asarray(feats), n, t_real))
    twin = j_forecast._np_forecast_horizon(horizon, tree, feats, n, t_real)
    np.testing.assert_allclose(got, want, atol=FORECAST_TOL, rtol=0)
    np.testing.assert_allclose(got, twin, atol=FORECAST_TOL, rtol=0)
    np.testing.assert_array_equal(t_forecast._np_forecast_horizon(horizon, tree, feats, n, t_real), twin)
    assert got.shape == (rows,) and (got >= 0).all()


def test_forecaster_matches_the_reference_forecaster():
    """The same params installed in both packages' forecasters: the sweep
    on the CPU agrees with the reference's jitted sweep and its numpy
    version (≤ 1e-3)."""
    tree = _numpy(j_init_gru(jax.random.PRNGKey(0), DEMAND_FEATURE_DIM, 16))
    counts = _ramping_window(t=12, seed=3)
    f = DemandForecaster(window_buckets=12, horizon=3, device="cpu")
    f.set_params(tree)
    ref = j_forecast.DemandForecaster(window_buckets=12, horizon=3, use_device=True)
    ref.set_params(tree)
    got = f.forecast_demand(counts)
    np.testing.assert_allclose(got, ref.forecast_demand(counts), atol=FORECAST_TOL)
    np.testing.assert_allclose(got, ref.forecast_demand_np(counts), atol=FORECAST_TOL)
    np.testing.assert_allclose(f.forecast_demand_np(counts), ref.forecast_demand_np(counts), atol=1e-6)
    # a module installs like its tree
    g = DemandForecaster(window_buckets=12, horizon=3, device="cpu")
    g.set_params(gru_from_numpy(tree, device="cpu"))
    np.testing.assert_array_equal(g.forecast_demand(counts), got)


def test_fit_matches_the_reference_from_its_init():
    """The same prefix examples, and the fit from the reference's init
    (``fit(init=...)``): the same holdout metrics (rel 1e-4) and the same
    forecast (≤ 1e-3)."""
    counts = _ramping_window(n_hot=5, n_cold=6, t=16, seed=2)
    kw = dict(window_buckets=16, horizon=3, epochs=4, min_examples=4)
    f = DemandForecaster(device="cpu", **kw)
    ref = j_forecast.DemandForecaster(use_device=True, **kw)
    for a, b in zip(f._examples(counts), ref._examples(counts)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    init = _numpy(j_init_gru(jax.random.PRNGKey(f.seed), DEMAND_FEATURE_DIM, f.hidden_dim))
    got, want = f.fit(counts, init=init), ref.fit(counts)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    np.testing.assert_allclose(f.forecast_demand(counts), ref.forecast_demand(counts), atol=FORECAST_TOL)


def test_max_examples_caps_longest_prefix_first():
    counts = _ramping_window(t=10)
    f = DemandForecaster(window_buckets=10, max_examples=5, device="cpu")
    ref = j_forecast.DemandForecaster(window_buckets=10, max_examples=5, use_device=False)
    for a, b in zip(f._examples(counts), ref._examples(counts)):
        assert len(a) == 5 and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


class _SumForecaster:
    """Deterministic forecaster double: score = window mass."""

    min_examples = 10**9  # the planner never tries to fit this one
    ready = True

    def forecast_demand(self, series):
        return series.sum(axis=1)

    def stats(self):
        return {"backend": "stub"}


class _SeedStub:
    def __init__(self):
        self.inflight = set()
        self.refuse = False
        self.triggered = []
        self.triggered_ids = []
        self.trigger_kwargs = []

    def seed_hosts(self):
        return ["seed-a"]

    def is_inflight(self, task_id):
        return task_id in self.inflight

    def trigger(self, task_id, url, **kw):
        if self.refuse:
            return False
        self.triggered.append(url)
        self.triggered_ids.append(task_id)
        self.trigger_kwargs.append(kw)
        return True


class _JobWorker:
    """The scheduler JobWorker's inline preheat, duck-typed: each task spec
    triggers the seed under its own id and URLMeta context inside a
    ``preheat.seed_trigger`` span."""

    def __init__(self, seed):
        self.seed = seed
        self.jobs = []

    def execute_now(self, job_type, args):
        self.jobs.append((job_type, args))
        entries = [dict(t) for t in args.get("tasks") or [] if t.get("url")]
        if not entries:
            return "failed", {"error": "no urls in job args"}
        triggered = []
        with tracing.maybe_span("scheduler", "preheat.seed_trigger", urls=len(entries)):
            for e in entries:
                meta = {k: e.get(k, "") for k in ("tag", "application", "filter", "range", "digest")}
                task_id = e.get("task_id") or task_id_v1(e["url"], URLMeta(**meta))
                if self.seed.trigger(task_id, e["url"], **meta):
                    triggered.append(e["url"])
        if not triggered:
            return "failed", {"error": "every trigger refused", "count": 0}
        return "succeeded", {"count": len(triggered)}


class _TaskStub:
    def __init__(self, held):
        self._held = held

    def load_seed_peer(self):
        return object() if self._held else None


class _ResourceStub:
    def __init__(self):
        self.held = set()
        self.task_manager = self

    def load(self, task_id):
        return _TaskStub(task_id in self.held)


def _planner(demand, seed=None, resource=None, **kw):
    seed = seed if seed is not None else _SeedStub()
    kw.setdefault("min_score", 0.5)
    kw.setdefault("interval_s", 3600)
    worker = _JobWorker(seed)
    return (
        PreheatPlanner(demand, _SumForecaster(), resource=resource, job_worker=worker, seed_client=seed, **kw),
        seed,
    )


def _feed(demand, tasks, now, count=3.0):
    for i, tid in enumerate(tasks):
        demand.observe(tid, url=f"http://o/{tid}", ts=now, count=count + i)


def test_sweep_plans_triggers_and_links_one_trace(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    now = 500.0
    _feed(demand, ["t1", "t2"], now)
    planner, seed = _planner(demand, budget_per_sweep=4)
    out = planner.sweep_once(now=now)
    assert out["outcome"] == "planned"
    assert out["forecast"] == 2
    assert out["planned"] == 2 and out["triggered"] == 2
    assert sorted(seed.triggered) == ["http://o/t1", "http://o/t2"]
    sweeps = [s for s in tracing.get("preheat").finished if s.name == "preheat.sweep"]
    assert sweeps, "sweep span must be sampled and finished"
    tid = sweeps[-1].trace_id
    names = {
        s.name
        for svc in ("preheat", "scheduler")
        for s in tracing.get(svc).finished
        if s.trace_id == tid
    }
    assert {"preheat.sweep", "preheat.forecast", "preheat.plan", "preheat.job", "preheat.seed_trigger"} <= names


def test_budget_caps_a_sweep(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    now = 600.0
    _feed(demand, [f"t{i}" for i in range(6)], now)
    planner, seed = _planner(demand, budget_per_sweep=2)
    out = planner.sweep_once(now=now)
    assert out["planned"] == 2 and len(seed.triggered) == 2
    assert out["skipped"] >= 1
    assert sorted(seed.triggered) == ["http://o/t4", "http://o/t5"]


def test_skip_reasons_held_inflight_cooldown(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    now = 700.0
    _feed(demand, ["held", "inflight", "fresh"], now)
    resource = _ResourceStub()
    resource.held.add(task_id_v1("http://o/held"))
    seed = _SeedStub()
    seed.inflight.add(task_id_v1("http://o/inflight"))
    planner, seed = _planner(demand, seed=seed, resource=resource, budget_per_sweep=4)
    out = planner.sweep_once(now=now)
    assert out["planned"] == 1 and out["skipped"] == 2
    assert seed.triggered == ["http://o/fresh"]
    out2 = planner.sweep_once(now=now + 1)
    assert out2["outcome"] == "empty"
    assert planner.stats()["cooling"] == 1
    later = now + planner.cooldown_s + 1
    _feed(demand, ["fresh"], later)
    assert planner.sweep_once(now=later)["planned"] == 1


def test_failed_job_releases_cooldown_for_retry(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    now = 800.0
    _feed(demand, ["t1"], now)
    planner, seed = _planner(demand, budget_per_sweep=4)
    seed.refuse = True
    out = planner.sweep_once(now=now)
    assert out["outcome"] == "planned" and out["triggered"] == 0
    assert planner.stats()["cooling"] == 0
    seed.refuse = False
    out2 = planner.sweep_once(now=now + 1)
    assert out2["triggered"] == 1 and seed.triggered == ["http://o/t1"]


def test_preheat_triggers_under_demanded_task_identity(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    now = 1000.0
    url = "http://origin/model.bin"
    demanded_id = task_id_v1(url, URLMeta(tag="ml", application="batch"))
    demand.observe(demanded_id, url=url, ts=now, count=5.0, meta={"tag": "ml", "application": "batch"})
    planner, seed = _planner(demand, budget_per_sweep=4)
    assert planner.sweep_once(now=now)["triggered"] == 1
    assert seed.triggered_ids == [demanded_id]
    kw = seed.trigger_kwargs[0]
    assert kw["tag"] == "ml" and kw["application"] == "batch"


def test_layer_series_without_task_id_derives_client_identity(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    now = 1100.0
    url = "http://mirror/v2/img/blobs/sha256:abcd"
    demand.observe_layer("sha256:abcd", url, ts=now, meta={"tag": "registry"})
    demand.observe("sha256:abcd", ts=now, count=4.0)
    planner, seed = _planner(demand, budget_per_sweep=4)
    assert planner.sweep_once(now=now)["triggered"] == 1
    assert seed.triggered_ids == [task_id_v1(url, URLMeta(tag="registry"))]
    assert seed.trigger_kwargs[0]["tag"] == "registry"
    seed.inflight.add(task_id_v1(url, URLMeta(tag="registry")))
    later = now + planner.cooldown_s + 1
    demand.observe("sha256:abcd", url=url, ts=later, count=4.0)
    out2 = planner.sweep_once(now=later)
    assert out2["planned"] == 0 and out2["skipped"] == 1


def test_plan_fault_lands_in_error_outcome(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    now = 900.0
    _feed(demand, ["t1"], now)
    planner, seed = _planner(demand)
    faults.configure("preheat.plan=error")
    out = planner.sweep_once(now=now)
    assert out["outcome"] == "error"
    assert seed.triggered == []
    faults.clear()
    assert planner.sweep_once(now=now)["outcome"] == "planned"


def test_planner_stats_shape(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    planner, _ = _planner(demand)
    planner.sweep_once(now=950.0)
    s = planner.stats()
    assert s["sweeps"] == 1 and s["jobs"] == 0
    assert s["demand"]["tasks"] == 0
    assert s["forecaster"] == {"backend": "stub"}


def test_planner_start_stop_runs_in_background(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    demand.observe("t1", url="http://o/t1", count=5.0)
    planner, seed = _planner(demand, interval_s=0.02)
    planner.start()
    deadline = time.time() + 5.0
    while planner.sweeps == 0 and time.time() < deadline:
        time.sleep(0.01)
    planner.stop()
    assert planner.sweeps >= 1
    assert seed.triggered == ["http://o/t1"]


def test_refit_moves_off_the_sweep_thread_single_flight(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    planner, _ = _planner(demand)
    started, release = threading.Event(), threading.Event()
    fits = []

    class _SlowFit:
        def fit(self, series):
            fits.append(series)
            started.set()
            assert release.wait(5.0)

    planner.forecaster = _SlowFit()
    planner._refit_async([[1.0]])
    assert started.wait(5.0)
    planner._refit_async([[2.0]])  # in flight: skipped, not queued
    assert planner.refits_async == 1 and planner.refits_skipped == 1
    release.set()
    deadline = time.time() + 5.0
    while planner._refit_flight.locked() and time.time() < deadline:
        time.sleep(0.01)
    started.clear()
    planner._refit_async([[3.0]])
    assert started.wait(5.0)
    assert planner.refits_async == 2 and len(fits) == 2


def test_sweep_refit_boundary_is_asynchronous(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    now = 990.0
    _feed(demand, ["t1", "t2"], now)
    planner, _ = _planner(demand, refit_every=1)
    release = threading.Event()

    class _ReadySlow:
        min_examples = 1
        ready = True

        def forecast_demand(self, series):
            return series.sum(axis=1)

        def fit(self, series):
            assert release.wait(5.0)

        def stats(self):
            return {"backend": "stub"}

    planner.forecaster = _ReadySlow()
    out = planner.sweep_once(now=now)  # must not block on the held fit
    assert out["outcome"] == "planned" and planner.refits_async == 1
    release.set()


def test_first_fit_is_inline_with_a_real_forecaster(clean_faults):
    """A cold GRU forecaster fits inline on the first sweep, then the hot
    ramps are planned first."""
    demand = DemandWindow(bucket_s=1.0, window_buckets=12)
    counts = _ramping_window(n_hot=3, n_cold=6, t=12, seed=1)
    now = 5000.0
    for i, row in enumerate(counts):
        for b, c in enumerate(row):
            if c > 0:
                demand.observe(f"task-{i}", url=f"http://o/{i}", ts=now - 11 + b, count=float(c))
    forecaster = DemandForecaster(window_buckets=12, epochs=6, min_examples=4, device="cpu")
    seed = _SeedStub()
    planner = PreheatPlanner(
        demand, forecaster, job_worker=_JobWorker(seed), seed_client=seed, budget_per_sweep=3, min_score=0.0,
    )
    out = planner.sweep_once(now=now)
    assert forecaster.fits == 1 and out["outcome"] == "planned"
    assert sorted(seed.triggered) == ["http://o/0", "http://o/1", "http://o/2"]


class _Manager:
    def __init__(self, fail=False):
        self.jobs = []
        self.fail = fail

    def CreateJob(self, request):
        if self.fail:
            raise ConnectionError("manager down")
        self.jobs.append(request)
        return type("Job", (), {"id": len(self.jobs)})()


class _Engine:
    """A topology engine whose centrality ranks three hosts."""

    def centrality(self, candidates=None):
        return [{"host_id": f"seed-{i}", "mean_rtt_ms": 1.0 + i} for i in range(3)]


@pytest.mark.parametrize("requests", ["proto", "plain"])
def test_manager_path_builds_the_references_create_job(clean_faults, requests):
    """With a manager attached the job goes out as ``CreateJob``, its
    request built by the factory: the protobuf message is byte for byte
    the reference planner's for the same sweep, and carries the engine's
    RTT seed ranking."""
    now = 1200.0
    topo = type("NT", (), {"engine": _Engine()})()
    factory = ProtoRequests() if requests == "proto" else PlainRequests()
    built = {}
    for name, window_cls, planner_cls, kw in (
        ("torch", DemandWindow, PreheatPlanner, dict(requests=factory)),
        ("jax", j_demand.DemandWindow, j_planner.PreheatPlanner, {}),
    ):
        demand = window_cls(bucket_s=1.0, window_buckets=4)
        _feed(demand, ["a", "b", "c"], now)
        manager = _Manager()
        planner = planner_cls(
            demand, _SumForecaster(), manager_client=manager, topology=topo, cluster_id=7,
            budget_per_sweep=2, min_score=0.5, **kw,
        )
        out = planner.sweep_once(now=now)
        assert out["outcome"] == "planned" and out["triggered"] == 2 and len(manager.jobs) == 1
        built[name] = manager.jobs[0]
    got, want = built["torch"], built["jax"]
    if requests == "proto":
        assert got.SerializeToString() == want.SerializeToString()
    assert (got.type, got.scheduler_cluster_id) == ("preheat", 7)
    args = json.loads(got.args_json)
    assert args == json.loads(want.args_json)
    assert [r["host_id"] for r in args["seed_ranking"]] == ["seed-0", "seed-1", "seed-2"]
    assert sorted(args["urls"]) == ["http://o/b", "http://o/c"]
    assert {t["task_id"] for t in args["tasks"]} == {task_id_v1("http://o/b"), task_id_v1("http://o/c")}


def test_a_dead_manager_fails_the_job_and_keeps_no_cooldown(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    _feed(demand, ["t1"], 1300.0)
    planner = PreheatPlanner(
        demand, _SumForecaster(), manager_client=_Manager(fail=True), requests=PlainRequests(), min_score=0.5,
    )
    out = planner.sweep_once(now=1300.0)
    assert out["outcome"] == "planned" and out["triggered"] == 0
    assert planner.stats()["cooling"] == 0


def test_no_job_path_fails_the_job(clean_faults):
    demand = DemandWindow(bucket_s=1.0, window_buckets=4)
    _feed(demand, ["t1"], 1400.0)
    planner = PreheatPlanner(demand, _SumForecaster(), min_score=0.5)
    out = planner.sweep_once(now=1400.0)
    assert out["jobs"] == 1 and out["triggered"] == 0


def test_forecaster_fit_output_installs_a_gru_module():
    counts = _ramping_window(t=8)
    f = DemandForecaster(window_buckets=8, epochs=2, min_examples=4, device="cpu")
    f.fit(counts)
    init = t_init_gru(torch.Generator().manual_seed(0), DEMAND_FEATURE_DIM, f.hidden_dim)
    assert module_tree(f._model).keys() == module_tree(init).keys()
    assert f._model.wz.requires_grad is False
