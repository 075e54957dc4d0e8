"""The port on an NVIDIA card: both CUDA flash kernels against their plain
PyTorch version (strided inputs, alignment checks, the tf32x3 pre-pass bit
for bit and per-kernel launch counting included), and the serving and
topology planes on the card against the same port on the CPU, and one wave
of the scheduler's ``ml`` decision path on the card.

Every test here needs a card and skips without one. It imports neither jax
nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import random

import numpy as np
import pytest
import torch

from dragonfly2_torch.models.mlp import init_mlp
from dragonfly2_torch.ops import flash
from dragonfly2_torch.scheduler import resource as res
from dragonfly2_torch.scheduler import wave
from dragonfly2_torch.scheduler.evaluator import MLEvaluator
from dragonfly2_torch.scheduler.scheduling import Scheduling
from dragonfly2_torch.scheduler.serving import MLPServed, ScoringService
from dragonfly2_torch.topology import TopologyConfig, TopologyEngine
from dragonfly2_torch.trainer.serving import MLPScorer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# O per element within atol + rtol·|ref| (another f32 summation order; in
# bfloat16 a rounding point between the two f32 sums and one step more);
# the sm90 kernel rounds P to bfloat16 before P·V, which adds at most
# 2⁻⁸·(P·|V|)/l (``flash.p_rounding_term``). LSE is float32 on both sides.
O_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2**-6)}
P_ROUNDING = 2**-8
LSE_TOL = 1e-4


def _assert_o_close(o, ref, term=None):
    atol, rtol = O_TOL[ref.dtype]
    diff = (o.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs()
    if term is not None:
        limit = limit + P_ROUNDING * term
    assert (diff <= limit).all(), (diff / limit).max().item()


def _check_against_plain(q, k, v, causal):
    """One call through the wrapper, held against the plain version with the
    limit of the kernel it took → that kernel's name."""
    kernel = flash.kernel_for(q.dtype, q.shape[-1])
    before = dict(flash.LAUNCHES_BY)
    with torch.no_grad():
        o, lse = flash.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash.flash_attention_reference(q, k, v, causal=causal)
        term = flash.p_rounding_term(q, k, v, causal) if kernel == "sm90" else None
    assert flash.LAUNCHES_BY == {**before, kernel: before[kernel] + 1}
    assert o.shape == q.shape and o.dtype == q.dtype and lse.dtype == torch.float32
    _assert_o_close(o, o_ref, term)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL
    return kernel


def _qkv(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((2, 129, 3, 64), torch.float32),  # one row past a tile
        ((1, 31, 2, 8), torch.float32),  # shorter than a key tile
        ((1, 300, 2, 128), torch.bfloat16),
        ((3, 64, 1, 16), torch.bfloat16),
        ((1, 250, 4, 32), torch.float32),
        ((1, 8192, 2, 128), torch.float32),  # tf32x3's widest head at the encoder's length
        ((1, 8192, 2, 8), torch.bfloat16),  # tf32x3's bf16 role at the encoder's length
        ((1, 1, 2, 16), torch.float32),  # one row
        ((2, 77, 3, 16), torch.float32),
    ],
)
def test_kernel_matches_plain_version(cuda, shape, dtype, causal):
    q, k, v = _qkv(shape, dtype, seed=sum(shape))
    before = flash.LAUNCHES
    _check_against_plain(q, k, v, causal)
    assert flash.LAUNCHES == before + 1


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape",
    [
        (1, 1, 2, 64),  # one row
        (1, 129, 2, 64),  # one row past a tile
        (2, 512, 4, 64),
        (1, 300, 2, 128),
        (1, 333, 2, 32),
        (1, 77, 2, 16),
        (32, 130, 3, 32),  # B·H = 96
        (1, 8192, 2, 64),  # the encoder's length
        (1, 8190, 1, 16),  # long, ragged
    ],
)
def test_sm90_kernel_matches_plain_version(cuda, shape, causal):
    q, k, v = _qkv(shape, torch.bfloat16, seed=sum(shape) + causal)
    assert _check_against_plain(q, k, v, causal) == "sm90"


@pytest.mark.parametrize("d", [16, 64, 128])
def test_sm90_kernel_reads_packed_qkv(cuda, d):
    """q, k, v as views of one packed [B, T, 3, H, D] bf16 projection: the
    tensor maps walk their strides instead of copying."""
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = torch.randn((2, 200, 3, 4, d), generator=g, device="cuda").bfloat16().unbind(dim=2)
    assert not q.is_contiguous()
    assert _check_against_plain(q, k, v, causal=True) == "sm90"


@pytest.mark.parametrize(
    "dtype,d,kernel",
    [(torch.bfloat16, 64, "sm90"), (torch.float32, 64, "tf32x3"), (torch.bfloat16, 8, "tf32x3")],
)
def test_launches_are_counted_by_kernel(cuda, dtype, d, kernel):
    q, k, v = _qkv((1, 100, 2, d), dtype, seed=d)
    assert _check_against_plain(q, k, v, causal=False) == kernel


def test_sm90_kernel_refuses_unaligned_inputs(cuda):
    k = v = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16, device="cuda")
    wide = torch.zeros((1, 16, 2, 68), dtype=torch.bfloat16, device="cuda")
    flat = torch.zeros(1 + 16 * 2 * 64, dtype=torch.bfloat16, device="cuda")
    before = dict(flash.LAUNCHES_BY)
    for q in (wide[..., :64], flat[1:].view(1, 16, 2, 64)):  # H stride 136 B; address + 2 B
        with pytest.raises(ValueError, match="16-byte"):
            flash.flash_attention(q, k, v)
    assert flash.LAUNCHES_BY == before


def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as views of one packed [B, T, 3, H, D] float32 projection:
    the tf32x3 kernel's pre-pass walks their strides instead of copying."""
    b, t, h, d = 2, 100, 4, 32
    g = torch.Generator(device="cuda").manual_seed(5)
    qkv = torch.randn((b, t, 3, h, d), generator=g, device="cuda")
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    with torch.no_grad():
        o = flash.flash_attention(q, k, v, causal=True)
        want, _ = flash.flash_attention_reference(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=True
        )
    _assert_o_close(o, want)


@pytest.mark.parametrize(
    "shape,dtype,packed",
    [
        ((2, 129, 3, 64), torch.float32, False),
        ((1, 8190, 2, 128), torch.float32, False),
        ((2, 100, 4, 32), torch.float32, True),
        ((1, 333, 2, 8), torch.bfloat16, False),
    ],
)
def test_tf32x3_prepass_matches_its_plain_split_bit_for_bit(cuda, shape, dtype, packed):
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    if packed:
        b, t, h, d = shape
        q, k, v = torch.randn((b, t, 3, h, d), generator=g, device="cuda").to(dtype).unbind(dim=2)
    else:
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3))
    before = dict(flash.LAUNCHES_BY)
    with torch.no_grad():
        got = flash.tf32x3_prepass(q, k, v)
        torch.cuda.synchronize()
        want = flash.tf32x3_prepass_reference(q, k, v)
    assert flash.LAUNCHES_BY == before  # a check, not a forward
    for g_, w in zip(got, want):
        assert g_.shape == w.shape
        assert torch.equal(g_.view(torch.int32), w.contiguous().view(torch.int32))


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 16, 2, 24), torch.float32, seed=1)  # D=24 not built
    with pytest.raises(ValueError):
        flash.flash_attention(q, k, v)
    q, k, v = _qkv((1, 16, 2, 32), torch.float32, seed=1)
    wide = torch.zeros((1, 16, 2, 64), device="cuda")
    with pytest.raises(ValueError):  # head dimension not contiguous
        flash.flash_attention(wide[..., ::2], k, v)
    with pytest.raises(TypeError):
        flash.flash_attention(q.half(), k.half(), v.half())


def test_scorer_on_the_card_matches_the_cpu(cuda):
    mlp = init_mlp(torch.Generator().manual_seed(0), [19, 128, 128, 1])
    rng = np.random.default_rng(0)
    counts = [15] * 16 + [3]
    x = rng.random((sum(counts), 19)).astype(np.float32)
    seg = wave.segment_ids(counts)
    s, order = MLPScorer(mlp, device="cuda").predict_ranked(x, seg)
    assert np.array_equal(order, wave.rank_order(s, seg))
    np.testing.assert_allclose(s, MLPScorer(mlp, device="cpu").predict(x), atol=2e-2)


def test_engine_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(1)
    engines = [
        TopologyEngine(TopologyConfig(flush_threshold=10**9, num_landmarks=4), device=d)
        for d in ("cuda", "cpu")
    ]
    for i in range(200):
        for j in rng.choice(200, 4, replace=False):
            rtt = int(rng.lognormal(np.log(15e6), 0.5))
            for eng in engines:
                eng.enqueue(f"h{i}", f"h{j}", rtt, created_at=1000.0)
    for eng in engines:
        eng.flush(now=1001.0)
    assert engines[0]._D.is_cuda
    src = [f"h{i}" for i in rng.integers(0, 210, 500)]
    dst = [f"h{i}" for i in rng.integers(0, 210, 500)]
    np.testing.assert_allclose(
        engines[0].rtt_affinity_pairs(src, dst), engines[1].rtt_affinity_pairs(src, dst), atol=1e-6
    )
    for s, d in zip(src[:50], dst[:50]):
        assert engines[0].est_rtt_ns(s, d) == engines[1].est_rtt_ns(s, d)


def test_one_wave_of_the_decision_path_on_the_card(cuda):
    """Scheduling → MLEvaluator → ScoringService → MLPScorer on the card:
    the wave is served (rung ``serving``), each decision is the head of
    ``rank_order`` of the card's scores for its candidates, and the scores
    are within 2e-2 of the same features scored on the CPU."""
    rng = np.random.default_rng(2)
    task = res.Task("layer", "https://registry.example/blob")
    task.content_length = 64 << 20
    task.total_piece_count = 16
    peers = []
    for i in range(48):
        host = res.Host(id=f"h{i}", type=res.HostType.SUPER if i % 8 == 0 else res.HostType.NORMAL)
        host.cpu.percent = float(rng.uniform(0, 100))
        host.memory.used_percent = float(rng.uniform(0, 100))
        host.network.location = f"cn|r{i % 3}|z{i % 5}"
        peer = res.Peer(f"p{i}", task, host)
        peer.fsm.event(res.PEER_EVENT_REGISTER_NORMAL)
        peer.fsm.event(res.PEER_EVENT_DOWNLOAD)
        if i < 12:
            peer.fsm.event(res.PEER_EVENT_DOWNLOAD_SUCCEEDED)
        peer.finished_pieces = set(range(int(rng.integers(0, 17))))
        task.store_peer(peer)
        peers.append(peer)
    for peer in peers[12:]:
        task.add_peer_edge(peers[int(rng.integers(12))], peer)
    mlp = init_mlp(torch.Generator().manual_seed(0), [19, 128, 128, 1])
    scorer = MLPScorer(mlp, device="cuda")

    class Recording(ScoringService):
        def score_wave(self, features, pairs, counts, budget_s=None):
            self.last = (features, super().score_wave(features, pairs, counts, budget_s))
            return self.last[1]

    class Evaluator(MLEvaluator):
        def evaluate_wave(self, children, candidate_sets, totals):
            self.last_sets = candidate_sets
            return super().evaluate_wave(children, candidate_sets, totals)

    service = Recording()
    service.start()
    try:
        service.install(MLPServed(scorer), version="mlp/v1")
        evaluator = Evaluator(scorer, serving=service)
        scheduling = Scheduling(evaluator)
        children = peers[12:44]
        random.seed(0)
        scheduling.find_candidate_parents_wave(children)  # warms the service thread
        random.seed(1)
        found = scheduling.find_candidate_parents_wave(children)
        assert evaluator._rung == "serving"
        assert service.snapshot()["waves"] == 2
        features, scored = service.last
        for (parents, ok), cands, (scores, ranking) in zip(found, evaluator.last_sets, scored):
            assert ok and len(scores) == len(cands) and np.isfinite(scores).all()
            assert np.array_equal(ranking, wave.rank_order(scores, np.zeros(len(scores))))
            assert [p.id for p in parents] == [cands[int(k)].id for k in ranking[:4]]
        np.testing.assert_allclose(
            np.concatenate([s for s, _ in scored]),
            MLPScorer(mlp, device="cpu").predict(features),
            atol=2e-2,
        )
    finally:
        service.stop()
