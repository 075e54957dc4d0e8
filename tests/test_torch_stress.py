"""The port's ``tools/stress.py`` against the reference's on the CPU.

- ``_serving_swarm`` builds the same parents and children in both
  packages' resource models.
- One model in both packages (params drawn with numpy from a seed, loaded
  into the reference's ``MLPScorer`` and, from the same npz bytes, into the
  port's): every child's ``MLEvaluator`` ranking is equal between the
  packages, per call and as one wave through the port's scoring service,
  and the scores agree to 1e-5.
- ``serving_soak`` and ``wave_soak`` at the reference's test sizes lose no
  submission, rank as per-peer and co-batch, and report the reference's
  keys. Their throughput and p99 gates depend on the host's speed (the
  reference's own p99 tests fail on a loaded host) and are measured on the
  card by ``chip_smoke.py``, not held here.
- ``chaos_soak`` at ``tests/test_fault_injection.py``'s size holds its
  gates and the swarm observatory's identity; ``registry_soak`` gives the
  reference's bytes in every plane and provenance cell, dedup ratio and
  P2P share; the data-plane soak and race at ``tests/test_data_plane.py``'s
  sizes; ``preheat_soak`` at ``bench.py``'s size, fitted from the
  reference's init tree, holds the same hot tasks and gates as the
  reference's run; ``run`` drives a port daemon's gRPC and its proxy as
  ``tests/test_stress_tool.py`` does.
- The CLI prints one JSON line for every mode, exiting by the mode's
  gates; the card is the default device, and asking for it without one
  raises.
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

from dragonfly2_torch.scheduler.evaluator import MLEvaluator as TEvaluator
from dragonfly2_torch.scheduler.serving import MLPServed, ScoringService, ServingConfig
from dragonfly2_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_torch.preheat.forecast import DemandForecaster
from dragonfly2_torch.rpc import resilience as tresilience
from dragonfly2_torch.rpc.glue import serve as tserve
from dragonfly2_torch.scheduler import resource as tres
from dragonfly2_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_torch.scheduler.scheduling import Scheduling, SchedulingConfig
from dragonfly2_torch.scheduler.service import SERVICE_NAME as SCHED_SERVICE
from dragonfly2_torch.scheduler.service import SchedulerService
from dragonfly2_torch.tools import stress as tstress
from dragonfly2_torch.trainer import serving as tserving
from dragonfly2_torch.utils import faults as tfaults
from dragonfly2_torch.utils import flows as tflows
from dragonfly2_torch.utils import profiling as tprofiling
from dragonfly2_tpu.models.gru import init_gru as j_init_gru
from dragonfly2_tpu.preheat.forecast import DEFAULT_HIDDEN, DEMAND_FEATURE_DIM
from dragonfly2_tpu.scheduler.evaluator import MLEvaluator as JEvaluator
from dragonfly2_tpu.schema.features import MLP_FEATURE_DIM
from dragonfly2_tpu.tools import stress as jstress
from dragonfly2_tpu.trainer import serving as jserving
from dragonfly2_tpu.utils import flows as jflows
from dragonfly2_tpu.utils import profiling as jprofiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def samplers_stop_with_the_module():
    # each package's daemons start its process-wide stack sampler and leave
    # it running, as a daemon process would; stop both once the module is
    # done so their sweeps do not tax the files run after it in this process
    yield
    tprofiling.stop()
    jprofiling.stop()

# tests/test_torch_serving.py's tolerance: float32 on both sides, summation order only
SCORE_TOL = 1e-5


def _swarm_view(parents, children):
    def peer(p):
        return (
            p.id, p.host.id, p.host.type.name, p.host.network.idc, p.host.network.location,
            p.fsm.current, sorted(p.finished_pieces),
        )

    return [peer(p) for p in parents], [peer(c) for c in children]


@pytest.mark.parametrize("candidates,peers", [(12, 32), (5, 3)])
def test_serving_swarm_matches_the_reference(candidates, peers):
    tp, tc, tt = tstress._serving_swarm(candidates, peers)
    jp, jc, jt = jstress._serving_swarm(candidates, peers)
    assert _swarm_view(tp, tc) == _swarm_view(jp, jc)
    assert (tt.id, tt.content_length, tt.total_piece_count) == (jt.id, jt.content_length, jt.total_piece_count)
    assert len(tp) == candidates and len(tc) == peers


def _numpy_params(seed=3):
    rng = np.random.default_rng(seed)
    dims = [MLP_FEATURE_DIM, 64, 1]
    return {
        "layers": [
            {"w": rng.normal(0, 0.3, (a, b)).astype(np.float32), "b": rng.normal(0, 0.1, b).astype(np.float32)}
            for a, b in zip(dims[:-1], dims[1:])
        ]
    }


@pytest.mark.parametrize("path", ["per_call", "wave"])
def test_one_model_ranks_alike_in_both_packages(path):
    params = _numpy_params()
    blob = jserving.serialize_params(params)
    ref_scorer = jserving.MLPScorer(jserving.deserialize_params_auto(blob))
    port_scorer = tserving.MLPScorer(tserving.deserialize_params_auto(blob), device="cpu")
    tp, tc, tt = tstress._serving_swarm(12, 8)
    jp, jc, jt = jstress._serving_swarm(12, 8)
    ref = JEvaluator(ref_scorer)
    svc = None
    if path == "wave":
        svc = ScoringService(ServingConfig())
        svc.start()
        svc.install(MLPServed(port_scorer, kind="torch"), version="parity/v1")
    try:
        port = TEvaluator(port_scorer, serving=svc)
        if path == "wave":
            got = port.evaluate_wave(tc, [tp] * len(tc), [tt.total_piece_count] * len(tc))
        else:
            got = [port.evaluate_parents(tp, c, tt.total_piece_count) for c in tc]
        want = [ref.evaluate_parents(jp, c, jt.total_piece_count) for c in jc]
        assert [[p.id for p in r] for r in got] == [[p.id for p in r] for r in want]
        if svc is not None:
            assert svc.batches > 0 and svc.waves > 0
    finally:
        if svc is not None:
            svc.stop()
    for t_child, j_child in zip(tc, jc):
        t_feats, _ = port._pack_wave([t_child], [tp], [tt.total_piece_count])
        j_feats, _ = ref._pack_wave([j_child], [jp], [jt.total_piece_count])
        np.testing.assert_allclose(t_feats, j_feats, atol=0)
        np.testing.assert_allclose(
            port_scorer.predict(t_feats), ref_scorer.predict(j_feats), atol=SCORE_TOL, rtol=SCORE_TOL
        )


@pytest.fixture(scope="module")
def reference_keys():
    """The reference's output keys, from its soaks at a tiny size."""
    serving = jstress.serving_soak(peers=2, decisions_per_peer=2)
    wave = jstress.wave_soak(peers=2, decisions_per_peer=2)
    return set(serving), set(wave)


def test_serving_soak_loses_nothing_and_co_batches(reference_keys):
    stats = tstress.serving_soak(peers=32, decisions_per_peer=15, device="cpu")
    assert stats["serving_lost"] == 0, stats
    # co-batching really happened: more than one request per batch
    assert stats["evaluator_batch_occupancy"] > stats["serving_candidates"], stats
    assert stats["serving_backend"] == "torch"
    assert stats["schedule_ops_per_s"] > 0 and stats["schedule_ops_per_s_per_call"] > 0, stats
    assert set(stats) == reference_keys[0]
    json.dumps(stats)


def test_wave_soak_ranks_as_per_peer_and_loses_nothing(reference_keys):
    scorers = []
    stats = tstress.wave_soak(peers=24, decisions_per_peer=12, device="cpu", scorers=scorers)
    assert stats["wave_lost"] == 0, stats
    assert stats["wave_rankings_match"] == 1, stats
    assert stats["wave_occupancy_rows"] > stats["wave_candidates"], stats
    assert stats["wave_unpack_p99_us"] > 0, stats
    assert set(stats) == reference_keys[1]
    assert [s.device.type for s in scorers] == ["cpu"]
    json.dumps(stats)


@pytest.mark.parametrize("wave", [False, True], ids=["serving", "wave"])
def test_cli_prints_one_json_line(capsys, wave):
    argv = ["--serving", "--serving-peers", "16", "--serving-decisions", "10", "--device", "cpu"]
    rc = tstress.main(argv + (["--wave"] if wave else []))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    parsed = json.loads(lines[0])
    assert rc == (0 if (tstress.wave_gates if wave else tstress.serving_gates)(parsed) else 1)
    assert parsed["wave_lost" if wave else "serving_lost"] == 0, parsed
    if wave:
        assert parsed["wave_rankings_match"] == 1, parsed


@pytest.mark.parametrize(
    "call",
    [lambda: tstress.serving_soak(peers=2, decisions_per_peer=1),
     lambda: tstress.wave_soak(peers=2, decisions_per_peer=1),
     lambda: tstress.main(["--serving", "--serving-peers", "2", "--serving-decisions", "1"]),
     lambda: tstress.shard_kill_soak(peers=2, shards=1),
     lambda: tstress.preheat_soak(tasks=4, hot=2),
     lambda: tstress.main(["--preheat"])],
    ids=["serving_soak", "wave_soak", "main", "shard_kill_soak", "preheat_soak", "main_preheat"],
)
def test_the_card_is_the_default_and_raises_without_one(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only machine")
    with pytest.raises(RuntimeError, match="cuda"):
        call()


# ---------------------------------------------------------------------------
# the chaos, registry, data-plane and preheat soaks
# ---------------------------------------------------------------------------


@pytest.fixture
def clean_resilience():
    """Disarm the fault plane and drop breaker/budget/degraded/policy
    state after the test: the resilience registries are process-global."""
    saved = dict(tresilience._POLICIES)
    yield
    tfaults.clear()
    tresilience._POLICIES.clear()
    tresilience._POLICIES.update(saved)
    tresilience.reset()


def test_chaos_soak_acceptance(clean_resilience):
    """``tests/test_fault_injection.py::test_chaos_soak_acceptance`` on the
    port: the scheduler restart, 5% RPC errors and the parent kill over a
    download swarm; every download completes with correct bytes, no hang,
    and the swarm observatory's identity holds at every sample."""
    stats = tstress.chaos_soak(downloads=4, piece=16 * 1024, deadline_s=30.0)
    assert stats["chaos_success_rate"] == 1.0, stats
    assert stats["chaos_hangs"] == 0, stats
    assert stats["chaos_faults_injected"] >= 1, stats
    assert stats["chaos_swarm_samples"] >= 3, stats
    assert stats["chaos_swarm_consistent"] == 1, stats
    assert tstress.chaos_gates(stats), stats


def _planes(snap: dict) -> dict:
    return {plane: (row["bytes"], row["served_bytes"]) for plane, row in snap["planes"].items()}


# the soak's numbers that do not depend on the host's clock
REGISTRY_KEYS = ("registry_pulls", "registry_bad_bytes", "layer_dedup_ratio", "p2p_efficiency", "flow_conserved",
                 "object_p2p_bytes", "object_cache_bytes")


def test_registry_soak_matches_the_reference():
    """Both packages' ``registry_soak`` at its defaults: the same bytes in
    every plane and provenance cell of the flow ledger, the same dedup
    ratio, P2P share, conservation and bad bytes, and the gates of
    ``tests/test_flows.py::TestRegistrySoak``."""
    got = tstress.registry_soak()
    t_planes = _planes(tflows.snapshot())
    want = jstress.registry_soak()
    j_planes = _planes(jflows.snapshot())
    assert {k: got[k] for k in REGISTRY_KEYS} == {k: want[k] for k in REGISTRY_KEYS}, (got, want)
    assert t_planes == j_planes
    assert set(got) == set(want)
    assert got["registry_bad_bytes"] == 0
    assert got["layer_dedup_ratio"] > 0
    assert got["p2p_efficiency"] > 0.5
    assert got["flow_conserved"] == 1
    assert got["object_p2p_bytes"] > 0 and got["object_cache_bytes"] > 0
    img = t_planes["image"][0]
    assert img["origin"] > 0 and img["parent"] > 0 and img["dedup"] > 0
    # the registry workload must not leak into the file plane
    assert t_planes["file"][1] == 0
    assert tstress.registry_gates(got)


def test_data_plane_soak_small_scale_clean():
    s = tstress.data_plane_soak(children=64, duration_s=1.5)
    assert s["data_plane_hangs"] == 0
    assert s["data_plane_errors"] == 0
    assert s["data_plane_connections"] == 64
    assert s["data_plane_requests"] > 0
    assert s["data_plane_bytes_per_s"] > 0
    assert s["piece_serve_p99_us"] > 0
    assert s["daemon_rss_mb"] > 0


def test_data_plane_race_reports_both_arms():
    s = tstress.data_plane_race(children=32, duration_s=1.0, repeats=1)
    assert s["data_plane_sendfile"] in (True, False)
    assert s["data_plane_bytes_per_s"] > 0
    assert s["data_plane_bytes_per_s_buffered"] > 0
    assert s["data_plane_hangs"] == 0
    assert s["data_plane_errors"] == 0


class _Held:
    """Records every seed-client stub a soak builds, so a test can read the
    task ids it was asked to seed."""

    def __init__(self, stub_class):
        self.stubs = []
        held = self

        class Recording(stub_class):
            def __init__(self):
                super().__init__()
                held.stubs.append(self)

        self.cls = Recording


# the soak's numbers that do not depend on the host's clock
PREHEAT_KEYS = ("preheat_hit_ratio", "preheat_lost", "preheat_trace_linked", "preheat_retraces", "preheat_tasks",
                "preheat_planned", "preheat_triggers")


def test_preheat_soak_from_the_reference_init_matches_the_reference(monkeypatch):
    """``bench.py``'s preheat size (12 tasks, 6 hot, 4 epochs, 2 steady
    sweeps). The port's forecaster fits from the reference's init tree
    (``DemandForecaster.fit(init=)``, patched in for the soak's fits), so
    both plans seed the same tasks: the held task ids, the clock-free keys
    and the gates agree, and the steady sweeps install no model and upload
    once a sweep."""
    kw = dict(tasks=12, hot=6, epochs=4, steady_sweeps=2)
    init = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), j_init_gru(jax.random.PRNGKey(0), DEMAND_FEATURE_DIM, DEFAULT_HIDDEN)
    )
    held = {}
    for name, module in (("torch", tstress), ("jax", jstress)):
        rec = _Held(module._PreheatSeedStub)
        monkeypatch.setattr(module, "_PreheatSeedStub", rec.cls)
        if name == "torch":
            fit = DemandForecaster.fit
            monkeypatch.setattr(DemandForecaster, "fit", lambda self, counts, init_=None: fit(self, counts, init=init))
            forecasters = []
            got = module.preheat_soak(device="cpu", forecasters=forecasters, **kw)
        else:
            want = module.preheat_soak(**kw)
        (stub,) = rec.stubs
        held[name] = sorted(stub.held_ids)
    assert held["torch"] == held["jax"] and held["torch"]
    assert {k: got[k] for k in PREHEAT_KEYS} == {k: want[k] for k in PREHEAT_KEYS}, (got, want)
    assert set(got) == set(want)
    assert tstress.preheat_gates(got) == tstress.preheat_gates(want) is True
    assert got["preheat_retraces"] == 0 and got["preheat_h2d_per_sweep"] == 1.0
    (forecaster,) = forecasters
    assert forecaster.stats()["installs"] == forecaster.stats()["fits"] == 1
    assert got["preheat_backend"] == "cpu"


def test_preheat_soak_counts_an_install_in_the_steady_sweeps(monkeypatch):
    """``preheat_retraces`` can fail: a model installed during the steady
    sweeps (here a refit at every sweep) is counted and fails the gate."""
    from dragonfly2_torch.preheat import planner as tplanner

    monkeypatch.setattr(tplanner.PreheatPlanner, "_refit_async", lambda self, series: self.forecaster.fit(series))
    real_init = tplanner.PreheatPlanner.__init__

    def every_sweep(self, *a, **kw):
        kw["refit_every"] = 1
        real_init(self, *a, **kw)

    monkeypatch.setattr(tplanner.PreheatPlanner, "__init__", every_sweep)
    got = tstress.preheat_soak(tasks=12, hot=6, epochs=1, steady_sweeps=2, device="cpu")
    assert got["preheat_retraces"] == 2, got
    assert not tstress.preheat_gates(got)


# ---------------------------------------------------------------------------
# the drive modes against a port cluster (tests/test_stress_tool.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def cluster(tmp_path):
    payload = os.urandom(64 * 1024)

    class Origin(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_HEAD(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Accept-Ranges", "bytes")
            self.end_headers()

    origin = ThreadingHTTPServer(("127.0.0.1", 0), Origin)
    threading.Thread(target=origin.serve_forever, daemon=True).start()

    service = SchedulerService(tres.Resource(), Scheduling(BaseEvaluator(), SchedulingConfig(retry_interval=0.05)))
    server, port = tserve({SCHED_SERVICE: service})
    d = Daemon(
        DaemonConfig(
            data_dir=str(tmp_path / "d"),
            scheduler_address=f"127.0.0.1:{port}",
            hostname="stress-host",
            ip="127.0.0.1",
            announce_interval=60.0,
            proxy_port=0,
            proxy_rules=[{"regex": ".*"}],
        )
    )
    d.start()
    yield {
        "daemon": f"127.0.0.1:{d.port}",
        "proxy": f"127.0.0.1:{d.proxy.port}",
        "origin": f"http://127.0.0.1:{origin.server_port}",
        "payload": payload,
    }
    d.stop()
    server.stop(0)
    origin.shutdown()
    origin.server_close()


def test_stress_daemon_mode_counts_and_percentiles(cluster):
    stats = tstress.run(cluster["origin"] + "/obj-{i}.bin", daemon=cluster["daemon"], connections=3, requests=12)
    assert stats["requests"] >= 12 and stats["failures"] == 0
    assert stats["bytes"] >= 12 * 64 * 1024
    lat = stats["latency_s"]
    assert 0 < lat["min"] <= lat["p50"] <= lat["p90"] <= lat["p99"] <= lat["max"]
    assert stats["rps"] > 0 and stats["throughput_mb_s"] > 0


def test_stress_proxy_mode_counts_bytes(cluster):
    stats = tstress.run(cluster["origin"] + "/via-proxy-{i}.bin", proxy=cluster["proxy"], connections=2, requests=6)
    assert stats["requests"] >= 6 and stats["failures"] == 0, stats
    assert stats["bytes"] == stats["requests"] * len(cluster["payload"])


def test_stress_duration_stop_and_csv(cluster, tmp_path):
    out = tmp_path / "samples.csv"
    stats = tstress.run(cluster["origin"] + "/one.bin", daemon=cluster["daemon"], connections=2, duration=2.0,
                        output=str(out))
    assert stats["requests"] > 0
    lines = out.read_text().strip().splitlines()
    assert lines[0] == "ok,seconds,bytes,error"
    assert len(lines) == stats["requests"] + 1


def test_stress_cli_json_line(cluster, capsys):
    rc = tstress.main(["--url", cluster["origin"] + "/cli-{i}.bin", "--daemon", cluster["daemon"], "-c", "2", "-n", "4"])
    assert rc == 0
    parsed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert parsed["failures"] == 0 and parsed["requests"] >= 4


def test_stress_requires_exactly_one_target():
    with pytest.raises(ValueError):
        tstress.run("http://x", daemon="a", proxy="b", requests=1)
    with pytest.raises(ValueError):
        tstress.run("http://x", requests=1)
    with pytest.raises(SystemExit):
        tstress.main(["--daemon", "127.0.0.1:1"])
    with pytest.raises(SystemExit):
        tstress.main(["--url", "http://x", "--daemon", "127.0.0.1:1"])


@pytest.mark.parametrize(
    "argv,gates",
    [(["--chaos"], lambda s: tstress.chaos_gates(s)),
     (["--registry"], lambda s: tstress.registry_gates(s)),
     (["--data-plane", "--data-plane-children", "48", "--data-plane-duration", "0.5"],
      lambda s: tstress.data_plane_gates(s, 48)),
     (["--preheat", "--preheat-tasks", "12", "--preheat-hot", "6", "--device", "cpu"],
      lambda s: tstress.preheat_gates(s))],
    ids=["chaos", "registry", "data-plane", "preheat"],
)
def test_every_mode_prints_one_json_line_and_exits_by_its_gates(capsys, clean_resilience, argv, gates):
    rc = tstress.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    parsed = json.loads(lines[0])
    assert rc == (0 if gates(parsed) else 1), parsed
    # the gates that do not hang on the host's clock hold in every mode
    if argv[0] == "--data-plane":
        assert parsed["data_plane_hangs"] == parsed["data_plane_errors"] == 0, parsed
        assert parsed["data_plane_connections"] >= 48, parsed
    else:
        assert rc == 0, parsed
