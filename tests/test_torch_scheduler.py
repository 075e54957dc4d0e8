"""The port's scheduler decision path (dragonfly2_torch.scheduler: the
resource model, ``pair_features``, ``MLEvaluator``, ``ScoringService``,
``Scheduling``) against the JAX package's, on the CPU. The same seeded
swarm is built in both resource models, the same npz bytes load into both
scorers and the same probes feed both topology engines; the port must
rank every decision as the reference does on every rung of the ladder."""

import random
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from dragonfly2_torch.rpc import resilience as t_resilience
from dragonfly2_torch.scheduler import evaluator as t_evaluator
from dragonfly2_torch.scheduler import metrics as t_metrics
from dragonfly2_torch.scheduler import resource as t_res
from dragonfly2_torch.scheduler import scheduling as t_scheduling
from dragonfly2_torch.scheduler import serving as t_serving
from dragonfly2_torch.topology import TopologyConfig as TConfig
from dragonfly2_torch.topology import TopologyEngine as TEngine
from dragonfly2_torch.trainer import serving as t_scorers
from dragonfly2_torch.utils import faults as t_faults
from dragonfly2_torch.utils import flight as t_flight
from dragonfly2_tpu.models.mlp import init_mlp
from dragonfly2_tpu.rpc import resilience as j_resilience
from dragonfly2_tpu.scheduler import evaluator as j_evaluator
from dragonfly2_tpu.scheduler import metrics as j_metrics
from dragonfly2_tpu.scheduler import resource as j_res
from dragonfly2_tpu.scheduler import scheduling as j_scheduling
from dragonfly2_tpu.scheduler import serving as j_serving
from dragonfly2_tpu.schema.features import MLP_FEATURE_DIM
from dragonfly2_tpu.topology import TopologyConfig, TopologyEngine
from dragonfly2_tpu.trainer import serving as j_scorers
from dragonfly2_tpu.utils import faults as j_faults
from dragonfly2_tpu.utils import flight as j_flight

torch.set_num_threads(1)

MS = 1_000_000  # ns per ms
HOSTS = 30

PORT = SimpleNamespace(
    name="port",
    res=t_res,
    evaluator=t_evaluator,
    serving=t_serving,
    scheduling=t_scheduling,
    resilience=t_resilience,
    faults=t_faults,
    flight=t_flight,
    metrics=t_metrics,
    scorer=lambda blob: t_scorers.MLPScorer(t_scorers.deserialize_params_auto(blob), device="cpu"),
    engine=lambda: TEngine(TConfig(flush_threshold=10**9, num_landmarks=4), device="cpu"),
)
REF = SimpleNamespace(
    name="reference",
    res=j_res,
    evaluator=j_evaluator,
    serving=j_serving,
    scheduling=j_scheduling,
    resilience=j_resilience,
    faults=j_faults,
    flight=j_flight,
    metrics=j_metrics,
    scorer=lambda blob: j_scorers.MLPScorer(j_scorers.deserialize_params_auto(blob)),
    engine=lambda: TopologyEngine(
        TopologyConfig(backend="numpy", flush_threshold=10**9, num_landmarks=4)
    ),
)
SIDES = (PORT, REF)


@pytest.fixture(autouse=True)
def clean_state():
    for side in SIDES:
        side.faults.clear()
        side.resilience.reset()
    yield
    for side in SIDES:
        side.faults.clear()
        side.resilience.reset()


@pytest.fixture(scope="module")
def blob():
    params = jax.tree_util.tree_map(
        np.asarray, init_mlp(jax.random.PRNGKey(4), [MLP_FEATURE_DIM, 32, 32, 1])
    )
    return j_scorers.serialize_params(params)


def _swarm(side, seed=0, tasks=2, peers=20):
    """A seeded swarm in ``side``'s resource model over hosts h0..h29 (the
    probe stream's ids): varied host stats, seed hosts, ``tasks`` tasks of
    ``peers`` peers on distinct hosts; a quarter succeeded, the rest running
    with one succeeded parent each → (running peers, {task id: peers})."""
    R = side.res
    rng = np.random.default_rng(seed)
    resource = R.Resource()
    for i in range(HOSTS):
        h = R.Host(id=f"h{i}", type=R.HostType.SUPER if i % 7 == 0 else R.HostType.NORMAL)
        h.cpu.percent = float(rng.uniform(0, 100))
        h.cpu.process_percent = float(rng.uniform(0, 50))
        h.memory.total = int(rng.integers(1 << 30, 1 << 36))
        h.memory.available = int(rng.integers(0, h.memory.total))
        h.memory.used_percent = float(rng.uniform(0, 100))
        h.network.tcp_connection_count = int(rng.integers(0, 5000))
        h.network.upload_tcp_connection_count = int(rng.integers(0, 500))
        h.network.location = ["cn|sh|a", "cn|sh|b", "cn|bj|a", "", "us|ca|x"][i % 5]
        h.network.idc = ["idc-0", "idc-1", ""][i % 3]
        h.disk.used_percent = float(rng.uniform(0, 100))
        h.disk.inodes_used_percent = float(rng.uniform(0, 100))
        h.upload_count = int(rng.integers(0, 100))
        h.upload_failed_count = int(rng.integers(0, h.upload_count + 1))
        h.concurrent_upload_count = int(rng.integers(0, 4))
        resource.host_manager.store(h)
    running, by_task = [], {}
    for t in range(tasks):
        task = R.Task(f"task-{t}", f"https://origin/blob-{t}")
        task.content_length = int(rng.integers(1 << 20, 1 << 30))
        task.total_piece_count = -(-task.content_length // task.piece_length)
        resource.task_manager.store(task)
        done, fed = [], []
        for k, hi in enumerate(rng.choice(HOSTS, peers, replace=False)):
            p = R.Peer(f"peer-{t}-{k}", task, resource.host_manager.load(f"h{hi}"))
            p.fsm.event(R.PEER_EVENT_REGISTER_NORMAL)
            p.fsm.event(R.PEER_EVENT_DOWNLOAD)
            for cost in rng.lognormal(np.log(40.0), 0.5, int(rng.integers(0, 6))):
                p.append_piece_cost(float(cost))
            if k < peers // 4:
                p.fsm.event(R.PEER_EVENT_DOWNLOAD_SUCCEEDED)
                p.finished_pieces = set(range(task.total_piece_count))
                done.append(p)
            else:
                p.finished_pieces = set(range(int(rng.integers(0, task.total_piece_count))))
                fed.append(p)
            resource.peer_manager.store(p)
        for p in fed:
            task.add_peer_edge(done[int(rng.integers(len(done)))], p)
        running += fed
        by_task[task.id] = done + fed
    return running, by_task


def _probes(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(HOSTS - 4):  # the last four hosts are never probed
        for j in rng.choice(HOSTS - 4, 3, replace=False):
            if j != i:
                out.append((f"h{i}", f"h{j}", int(rng.lognormal(np.log(15e6), 0.5))))
    return out


def _engine(side, seed=0):
    eng = side.engine()
    for s, d, rtt in _probes(seed):
        eng.enqueue(s, d, rtt, created_at=1000.0)
    eng.flush(now=1001.0)
    return eng


WIDTHS = [3, 7, 12, 1, 0, 9, 5, 15, 2]  # ragged, one empty decision


def _wave(side, seed=0):
    """Children and ragged candidate sets (rotations of each child's own
    task's peers) → (children, sets, totals)."""
    running, by_task = _swarm(side, seed)
    children = running[:: max(1, len(running) // len(WIDTHS))][: len(WIDTHS)]
    sets = []
    for j, (child, w) in enumerate(zip(children, WIDTHS)):
        pool = [p for p in by_task[child.task.id] if p is not child]
        sets.append((pool[j:] + pool[:j])[:w])
    return children, sets, [c.task.total_piece_count for c in children]


def _ids(ranked):
    return [[p.id for p in r] for r in ranked]


def test_pair_features_match_column_for_column():
    port, ref = _wave(PORT), _wave(REF)
    rows = 0
    for (pc, ps, pt), (rc, rs, rt) in zip(zip(*port), zip(*ref)):
        for pp, rp in zip(ps, rs):
            for kw in ({}, {"rtt_affinity": 0.25}, {"loc_affinity": 0.4}):
                got = t_evaluator.pair_features(pp, pc, pt, **kw)
                want = j_evaluator.pair_features(rp, rc, rt, **kw)
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want)
            rows += 1
    assert rows == sum(WIDTHS)


def test_pack_wave_matches_column_for_column():
    sides = {}
    for side in SIDES:
        children, sets, totals = _wave(side)
        ev = side.evaluator.MLEvaluator(topology=_engine(side))
        sides[side.name] = ev._pack_wave(children, sets, totals)
    (got, got_pairs), (want, want_pairs) = sides["port"], sides["reference"]
    assert got_pairs == want_pairs
    assert got.shape == want.shape == (sum(WIDTHS), MLP_FEATURE_DIM)
    np.testing.assert_array_equal(got[:, :-1], want[:, :-1])
    # rtt_affinity: the same estimate, float32 log1p one ulp apart at most
    np.testing.assert_array_equal(got[:, -1] == 0.0, want[:, -1] == 0.0)
    np.testing.assert_array_max_ulp(got[:, -1], want[:, -1], maxulp=1)
    assert (want[:, -1] > 0).any() and (want[:, -1] == 0).any()
    assert len(np.unique(want[:, 5])) > 1  # location affinity varies


def _evaluator(side, blob, rung):
    """``side``'s MLEvaluator set up to serve from ``rung`` → (evaluator,
    service or None)."""
    engine = _engine(side)
    if rung == "base":
        return side.evaluator.MLEvaluator(topology=engine), None
    scorer = side.scorer(blob)
    if rung == "mlp":
        return side.evaluator.MLEvaluator(scorer, topology=engine), None
    svc = side.serving.ScoringService()
    svc.start()
    svc.install(side.serving.MLPServed(scorer), version="mlp/v1")
    return side.evaluator.MLEvaluator(scorer, topology=engine, serving=svc), svc


@pytest.mark.parametrize("rung", ["serving", "mlp", "base"])
def test_evaluate_wave_ranks_as_the_reference_on_each_rung(blob, rung):
    got = {}
    for side in SIDES:
        children, sets, totals = _wave(side)
        ev, svc = _evaluator(side, blob, rung)
        try:
            ranked = ev.evaluate_wave(children, sets, totals)
            assert ev._rung == rung
            assert ev.evaluate_wave([], [], []) == []
            if svc is not None:
                assert svc.snapshot()["waves"] == 1
        finally:
            if svc is not None:
                svc.stop()
        assert [len(r) for r in ranked] == WIDTHS
        got[side.name] = _ids(ranked)
    assert got["port"] == got["reference"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_candidate_parents_wave_matches_under_random_seed(blob, seed):
    got = {}
    for side in SIDES:
        running, by_task = _swarm(side, seed)
        ev, svc = _evaluator(side, blob, "serving")
        try:
            sched = side.scheduling.Scheduling(ev)
            # running children of both tasks, one succeeded peer (wrong
            # state: ([], False)) and one blocked parent
            succeeded = by_task["task-0"][0]
            peers = running[::2] + [succeeded]
            random.seed(seed)
            found = sched.find_candidate_parents_wave(peers, blocklist={by_task["task-1"][1].id})
            random.seed(seed + 100)
            one = sched.find_candidate_parents(running[1])
            random.seed(seed + 200)
            success = sched.find_success_parent(running[3])
            assert ev._rung == "serving"
        finally:
            svc.stop()
        assert found[-1] == ([], False)
        assert all(ok for _, ok in found[:-1])
        got[side.name] = (
            [([p.id for p in r], ok) for r, ok in found],
            [p.id for p in one[0]],
            success.id if success is not None else None,
        )
    assert got["port"] == got["reference"]
    assert any(len(ids) == 4 for ids, _ in got["port"][0])  # cut to the limit


class _Broken:
    """A scorer whose forward fails (a lost device, a corrupt model)."""

    feature_dim = MLP_FEATURE_DIM

    def predict(self, feats):
        raise RuntimeError("mlp down")

    def predict_ranked(self, feats, seg):
        raise RuntimeError("mlp down")


def _ladder(side, blob):
    """Walk ``side``'s evaluator down and up the degradation ladder →
    per step (rung, degraded map, ranked ids), the fallback counts and the
    rung-change events."""
    children, sets, totals = _wave(side)
    ev, svc = _evaluator(side, blob, "serving")
    scorer = ev._model
    comp = side.evaluator.MLEvaluator.DEGRADED_COMPONENT
    fallbacks = side.metrics.SERVING_FALLBACK_TOTAL
    before = {r: fallbacks.labels(r).value for r in ("mlp", "base")}
    t0 = time.time_ns()
    steps = []

    def step():
        ranked = ev.evaluate_wave(children, sets, totals)
        deg = side.resilience.degraded()
        steps.append((ev._rung, deg.get(comp), _ids(ranked)))

    try:
        step()  # serving, healthy
        side.faults.configure("scheduler.serving_score=error")
        step()  # serving faulted → per-call mlp
        ev._model = _Broken()
        step()  # mlp broken too → base
        side.faults.clear()
        ev._model = scorer
        step()  # recovered → serving
        svc.stop()
        step()  # service stopped → mlp
        ev._model = _Broken()
        step()  # scorer raising, no service → base
        ev.set_model(None)
        step()  # no model → base
    finally:
        svc.stop()
    events = [
        (e["from_rung"], e["to_rung"], e["reason"])
        for e in side.flight.snapshot(["scheduler"])["scheduler"]
        if e["type"] == "scheduler.serving_fallback" and e["ts_ns"] >= t0
    ]
    counts = {r: fallbacks.labels(r).value - before[r] for r in ("mlp", "base")}
    return steps, counts, events


def test_serving_ladder_transitions_match_the_reference(blob):
    port = _ladder(PORT, blob)
    ref = _ladder(REF, blob)
    assert port == ref
    steps, counts, events = port
    assert [s[0] for s in steps] == ["serving", "mlp", "base", "serving", "mlp", "base", "base"]
    assert [s[1] for s in steps][:4] == [
        None,
        "serving unavailable; per-call mlp ranking",
        "ml predict failed; base evaluator ranking",
        None,
    ]
    assert counts == {"mlp": 2.0, "base": 2.0}
    assert len(events) == 6  # edge-triggered: one event per rung change
    # every ranked step ranked every decision
    assert all([len(r) for r in s[2]] == WIDTHS for s in steps)


def test_concurrent_waves_rank_as_the_immediate_path(blob):
    """Waves evaluated from several threads at once through one service
    (co-batched) rank exactly as the service's immediate path, which is
    taken inside a deadline too short to wait for co-batching, and as the
    reference's per-call path."""
    running, by_task = _swarm(PORT, seed=5)
    rng = np.random.default_rng(5)
    waves = []
    for _ in range(8):
        kids = [running[int(i)] for i in rng.choice(len(running), 6, replace=False)]
        sets = [
            [p for p in by_task[k.task.id] if p is not k][: int(rng.integers(1, 12))] for k in kids
        ]
        waves.append((kids, sets, [k.task.total_piece_count for k in kids]))
    ev, svc = _evaluator(PORT, blob, "serving")
    results: dict = {}
    barrier = threading.Barrier(len(waves))

    def work(i):
        barrier.wait()
        results[i] = _ids(ev.evaluate_wave(*waves[i]))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(waves))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(20.0)
        assert len(results) == len(waves) and ev._rung == "serving"
        rows = sum(len(c) for _, sets, _ in waves for c in sets)
        assert svc.wave_rows == rows  # every wave went through the service
        with t_resilience.deadline_scope(0.005):
            immediate = [_ids(ev.evaluate_wave(*w)) for w in waves]
        assert svc.wave_rows == rows  # the immediate path skips the queue
    finally:
        svc.stop()
    assert [results[i] for i in range(len(waves))] == immediate
    ref_ev, _ = _evaluator(REF, blob, "mlp")
    ref_running, ref_by_task = _swarm(REF, seed=5)
    index = {p.id: p for ps in ref_by_task.values() for p in ps}
    for (kids, sets, totals), got in zip(waves, immediate):
        ref_wave = ([index[k.id] for k in kids], [[index[p.id] for p in s] for s in sets], totals)
        assert _ids(ref_ev.evaluate_wave(*ref_wave)) == got


def test_stop_releases_waiting_waves(blob):
    """A stopping service fails the queued waves out (each falls back a
    rung) and strands no caller."""
    scorer = PORT.scorer(blob)
    entered, release = threading.Event(), threading.Event()

    class Slow(t_serving.MLPServed):
        def score_ranked(self, features, pairs, seg_ids):
            entered.set()
            assert release.wait(5.0)
            return super().score_ranked(features, pairs, seg_ids)

    svc = t_serving.ScoringService(t_serving.ServingConfig(window_s=0.001))
    svc.start()
    svc.install(Slow(scorer), version="slow/v1")
    outcomes = []

    def work():
        feats = np.zeros((5, MLP_FEATURE_DIM), np.float32)
        try:
            svc.score_wave(feats, None, [2, 3])
            outcomes.append("scored")
        except t_serving.ServingError as e:
            outcomes.append(str(e))

    threads = [threading.Thread(target=work) for _ in range(5)]
    threads[0].start()
    assert entered.wait(5.0)  # the first wave is in its slow forward
    for t in threads[1:]:
        t.start()  # these queue behind it
    deadline = time.monotonic() + 5.0
    while svc._queue.qsize() < 4 and time.monotonic() < deadline:
        time.sleep(0.005)
    threading.Timer(0.1, release.set).start()  # the first wave finishes mid-stop
    svc.stop()
    for t in threads:
        t.join(5.0)
    assert not any(t.is_alive() for t in threads)
    assert sorted(outcomes) == ["scored"] + ["scoring service stopped"] * 4
