"""The port's topology plane (dragonfly2_torch.topology) against the JAX
package's: ``TorchKernels`` against the numpy spec ``NumpyKernels``, the
port's engine against the reference engine on one probe stream, and the
whole scoring slice — the reference's ``MLEvaluator.evaluate_wave`` with
the port's scorer and engine plugged in ranks as with the reference's."""

import jax
import numpy as np
import pytest
import torch

from dragonfly2_torch.topology import TopologyConfig as TConfig
from dragonfly2_torch.topology import TopologyEngine as TEngine
from dragonfly2_torch.topology.kernels import INF_MS as T_INF_MS
from dragonfly2_torch.topology.kernels import TorchKernels
from dragonfly2_torch.trainer import serving as tserving
from dragonfly2_tpu.models.mlp import init_mlp
from dragonfly2_tpu.rpc import resilience
from dragonfly2_tpu.scheduler import resource as res
from dragonfly2_tpu.scheduler.evaluator import MLEvaluator
from dragonfly2_tpu.schema.features import MLP_FEATURE_DIM
from dragonfly2_tpu.topology import TopologyConfig, TopologyEngine
from dragonfly2_tpu.topology.kernels import INF_MS, NumpyKernels
from dragonfly2_tpu.trainer import serving as jserving
from dragonfly2_tpu.utils import faults

torch.set_num_threads(1)

MS = 1_000_000  # ns per ms


def _graph(seed, n_nodes=40, n_edges=160, ncap=64, ecap=256):
    """A padded edge list with two components (nodes ≥ n_nodes//2 + 4 only
    link among themselves, so some landmark distances stay INF_MS)."""
    rng = np.random.default_rng(seed)
    half = n_nodes // 2
    src = np.zeros(ecap, np.int32)
    dst = np.zeros(ecap, np.int32)
    src[:n_edges // 2] = rng.integers(0, half, n_edges // 2)
    dst[:n_edges // 2] = rng.integers(0, half, n_edges // 2)
    src[n_edges // 2 : n_edges] = rng.integers(half + 4, n_nodes, n_edges - n_edges // 2)
    dst[n_edges // 2 : n_edges] = rng.integers(half + 4, n_nodes, n_edges - n_edges // 2)
    valid = np.zeros(ecap, np.float32)
    valid[:n_edges] = (rng.random(n_edges) < 0.9).astype(np.float32)
    rtt_ms = rng.lognormal(np.log(20.0), 0.6, ecap).astype(np.float32)
    age = rng.uniform(0, 7200, ecap).astype(np.float32)
    lm_idx = np.array([0, 3, 7, 0], np.int32)
    lm_valid = np.array([1, 1, 1, 0], np.float32)
    return dict(
        src=src, dst=dst, valid=valid, rtt_ms=rtt_ms,
        rtt_log=np.log1p(rtt_ms).astype(np.float32), age=age,
        lm_idx=lm_idx, lm_valid=lm_valid, ncap=ncap,
    )


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernels_match_numpy_spec(seed):
    g = _graph(seed)
    npk, tk = NumpyKernels(), TorchKernels()
    assert T_INF_MS == INF_MS

    w_np = npk.decay_weights(g["age"], g["valid"], 1800.0)
    w_t = tk.decay_weights(_t(g["age"]), _t(g["valid"]), 1800.0)
    np.testing.assert_allclose(w_t.numpy(), w_np, atol=1e-6)

    kh_np = npk.khop_rtt(g["src"], g["dst"], g["rtt_log"], w_np, g["ncap"], 2)
    kh_t = tk.khop_rtt(_t(g["src"]), _t(g["dst"]), _t(g["rtt_log"]), _t(w_np), g["ncap"], 2)
    np.testing.assert_allclose(kh_t.numpy(), kh_np, atol=1e-6)

    D_np = npk.landmark_distances(
        g["src"], g["dst"], g["rtt_ms"], g["valid"], g["lm_idx"], g["lm_valid"], g["ncap"], 3
    )
    D_t = tk.landmark_distances(
        _t(g["src"]), _t(g["dst"]), _t(g["rtt_ms"]), _t(g["valid"]),
        _t(g["lm_idx"]), _t(g["lm_valid"]), g["ncap"], 3,
    )
    np.testing.assert_array_equal(D_t.numpy(), D_np)  # adds and mins only
    assert (D_np >= INF_MS / 2).any() and (D_np < INF_MS / 2).any()

    rng = np.random.default_rng(seed + 100)
    n = 96
    s_idx = rng.integers(0, 40, n).astype(np.int32)
    d_idx = rng.integers(0, 40, n).astype(np.int32)
    direct = rng.uniform(1, 30, n).astype(np.float32)
    has_direct = (rng.random(n) < 0.3).astype(np.float32)
    known = (rng.random(n) < 0.85).astype(np.float32)  # unknown hosts → 0.0
    np.testing.assert_array_equal(
        tk.est_from_landmarks(D_t, _t(s_idx), _t(d_idx)).numpy(),
        npk.est_from_landmarks(D_np, s_idx, d_idx),
    )
    aff_np = npk.gather_rtt_affinity(D_np, s_idx, d_idx, direct, has_direct, known)
    aff_t = tk.gather_rtt_affinity(
        D_t, _t(s_idx), _t(d_idx), _t(direct), _t(has_direct), _t(known)
    )
    assert aff_t.dtype == torch.float32
    # the estimate and the missing-value mask are exact; float32 log1p is
    # numpy's libm against torch's vectorized one, at most one ulp apart
    np.testing.assert_array_equal(aff_t.numpy() == 0.0, aff_np == 0.0)
    np.testing.assert_array_max_ulp(aff_t.numpy(), aff_np, maxulp=1)
    assert (aff_np == 0.0).any() and (aff_np > 0.0).any()


def _probe_stream(seed, hosts=30, per_host=3):
    rng = np.random.default_rng(seed)
    ids = [f"h{i}" for i in range(hosts)]
    out = []
    for rnd in range(2):  # two rounds: the second folds through the EWMA
        for i in range(hosts - 4):  # the last four hosts are never probed
            for j in rng.choice(hosts - 4, per_host, replace=False):
                if j != i:
                    rtt = int(rng.lognormal(np.log(15e6), 0.5))
                    out.append((ids[i], ids[j], rtt, 1000.0 + rnd))
    # an island pair: known hosts with no path to the rest
    out.append(("island-a", "island-b", 3 * MS, 1001.0))
    return out


def _engines(seed, num_landmarks=4):
    ref = TopologyEngine(
        TopologyConfig(backend="numpy", flush_threshold=10**9, num_landmarks=num_landmarks)
    )
    port = TEngine(TConfig(flush_threshold=10**9, num_landmarks=num_landmarks), device="cpu")
    for s, d, rtt, at in _probe_stream(seed):
        ref.enqueue(s, d, rtt, created_at=at)
        port.enqueue(s, d, rtt, created_at=at)
    ref.flush(now=1002.0)
    port.flush(now=1002.0)
    return ref, port


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_matches_reference_engine(seed):
    ref, port = _engines(seed)
    names = [f"h{i}" for i in range(30)] + ["island-a", "island-b", "ghost"]
    rng = np.random.default_rng(seed)
    src = [names[i] for i in rng.integers(0, len(names), 300)]
    dst = [names[i] for i in rng.integers(0, len(names), 300)]
    src[:3], dst[:3] = ["h1", "ghost", "h2"], ["h1", "h2", "island-a"]
    got = port.rtt_affinity_pairs(src, dst)
    want = ref.rtt_affinity_pairs(src, dst)
    assert got.dtype == np.float32 and got.shape == (300,)
    np.testing.assert_allclose(got, want, atol=1e-6)
    provenance = set()
    for s, d in zip(src, dst):
        assert port.est_rtt_ns(s, d) == ref.est_rtt_ns(s, d)
        provenance.add(port.est_rtt_detail(s, d)[1])
        assert port.rtt_affinity(s, d) == pytest.approx(ref.rtt_affinity(s, d), abs=1e-6)
    assert provenance == {"self", "direct", "inferred", "none"}
    for h in ("h0", "h5", "island-a", "ghost"):
        a, b = port.khop_rtt_log_ms(h), ref.khop_rtt_log_ms(h)
        assert (a is None) == (b is None)
        if a is not None:
            assert a == pytest.approx(b, abs=1e-6)
        assert port.neighbors(h) == [
            dict(r, age_s=pytest.approx(r["age_s"], abs=5.0)) for r in ref.neighbors(h)
        ]
    assert port.centrality() == ref.centrality()
    ps, rs = port.stats(), ref.stats()
    for key in ("hosts", "edges", "flushes", "landmarks", "pending_deltas"):
        assert ps[key] == rs[key]
    assert ps["kernel_pairs"] == 300


def test_engine_delete_host_and_batch_join_match_reference():
    ref, port = _engines(3)
    for eng in (ref, port):
        eng.delete_host("h2")
        eng.adopt("h0", "h9", 7 * MS, 1003.0)
        eng.flush(now=1004.0)
    children = np.array(["h0", "h2", "h9"])
    parents = np.array([["h9", "h1"], ["h0", "h3"], ["h7", "h9"]])
    np.testing.assert_allclose(
        port.rtt_affinity_batch(children, parents),
        ref.rtt_affinity_batch(children, parents),
        atol=1e-6,
    )
    assert port.est_rtt_ns("h0", "h9") == ref.est_rtt_ns("h0", "h9") == 7 * MS


@pytest.fixture
def clean_state():
    faults.clear()
    resilience.reset()
    yield
    faults.clear()
    resilience.reset()


def _wave(n_children=12, n_parents=15):
    task = res.Task("torch-port-wave", "https://origin/x")
    task.content_length = 64 * 1024 * 1024
    task.total_piece_count = 16
    parents = []
    for i in range(n_parents):
        h = res.Host(id=f"h{i + 2}", type=res.HostType.SUPER if i % 3 else res.HostType.NORMAL)
        h.network.idc = f"idc-{i % 2}"
        h.network.location = f"a|b{i % 3}"
        p = res.Peer(f"parent-{i}", task, h)
        p.fsm.event(res.PEER_EVENT_REGISTER_NORMAL)
        p.fsm.event(res.PEER_EVENT_DOWNLOAD)
        p.fsm.event(res.PEER_EVENT_DOWNLOAD_SUCCEEDED)
        p.finished_pieces |= set(range(i % 16 + 1))
        parents.append(p)
    kids = []
    for i in range(n_children):
        c = res.Peer(f"child-{i}", task, res.Host(id=f"h{(i * 7) % 30}"))
        c.fsm.event(res.PEER_EVENT_REGISTER_NORMAL)
        kids.append(c)
    # ragged candidate sets, rotated so every decision differs
    sets = [
        (parents[j % n_parents :] + parents[: j % n_parents])[: 3 + (j * 5) % 13]
        for j in range(n_children)
    ]
    return kids, sets


def test_evaluate_wave_ranks_alike_with_port_scorer_and_engine(clean_state):
    params = jax.tree_util.tree_map(
        np.asarray, init_mlp(jax.random.PRNGKey(3), [MLP_FEATURE_DIM, 32, 32, 1])
    )
    blob = jserving.serialize_params(params)
    ref_engine, port_engine = _engines(5)
    kids, sets = _wave()
    totals = [16] * len(kids)
    ref_ev = MLEvaluator(
        model=jserving.MLPScorer(jserving.deserialize_params_auto(blob)), topology=ref_engine
    )
    port_ev = MLEvaluator(
        model=tserving.MLPScorer(tserving.deserialize_params_auto(blob), device="cpu"),
        topology=port_engine,
    )
    want = ref_ev.evaluate_wave(kids, sets, totals)
    got = port_ev.evaluate_wave(kids, sets, totals)
    assert port_ev._rung == ref_ev._rung == "mlp"
    assert [[p.id for p in r] for r in got] == [[p.id for p in r] for r in want]
    assert port_engine.stats()["kernel_pairs"] == sum(len(s) for s in sets)
    # the rtt column really varied: some pairs direct/inferred, some missing
    feats, _ = port_ev._pack_wave(kids, sets, totals)
    assert (feats[:, -1] > 0).any()
