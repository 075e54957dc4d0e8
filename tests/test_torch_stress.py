"""The port's scoring soaks (``dragonfly2_torch.tools.stress``) against the
reference's ``tools/stress.py`` on the CPU.

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
- The CLI prints one JSON line; every mode that is not ported raises
  ``NotImplementedError`` naming A1(b); the card is the default device, and
  asking for it without one raises.
"""

import json

import numpy as np
import pytest
import torch

from dragonfly2_torch.scheduler.evaluator import MLEvaluator as TEvaluator
from dragonfly2_torch.scheduler.serving import MLPServed, ScoringService, ServingConfig
from dragonfly2_torch.tools import stress as tstress
from dragonfly2_torch.trainer import serving as tserving
from dragonfly2_tpu.scheduler.evaluator import MLEvaluator as JEvaluator
from dragonfly2_tpu.schema.features import MLP_FEATURE_DIM
from dragonfly2_tpu.tools import stress as jstress
from dragonfly2_tpu.trainer import serving as jserving

torch.set_num_threads(1)

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
    "argv",
    [["--chaos"], ["--chaos", "--shard-kill"], ["--data-plane"], ["--preheat"], ["--registry"],
     ["--url", "http://o/{i}", "--daemon", "127.0.0.1:1"], ["--url", "http://o/x", "--proxy", "127.0.0.1:1"],
     ["--url", "http://o/x"]],
    ids=lambda a: " ".join(a),
)
def test_unported_modes_raise_naming_their_item(argv):
    with pytest.raises(NotImplementedError, match=r"A1\(b\)"):
        tstress.main(argv)


@pytest.mark.parametrize(
    "call",
    [lambda: tstress.serving_soak(peers=2, decisions_per_peer=1),
     lambda: tstress.wave_soak(peers=2, decisions_per_peer=1),
     lambda: tstress.main(["--serving", "--serving-peers", "2", "--serving-decisions", "1"])],
    ids=["serving_soak", "wave_soak", "main"],
)
def test_the_card_is_the_default_and_raises_without_one(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only machine")
    with pytest.raises(RuntimeError, match="cuda"):
        call()
