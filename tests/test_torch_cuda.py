"""The port on an NVIDIA card: both CUDA flash kernels against their plain
PyTorch version (strided inputs, alignment checks, the tf32x3 pre-passes bit
for bit and per-kernel launch counting included), the flash backward
kernels of each route against their plain version and Ulysses training through both over
an sp = 1 NCCL group, and the serving and
topology planes on the card against the same port on the CPU, one wave
of the scheduler's ``ml`` decision path on the card, the trainer's
fits (streamed, batch, GNN) on the card against the CPU with the pinned
buffers' reuse rule, and the live scheduler and trainer servers on the
card (``chip_smoke.server_leg`` at a reduced size: every decision served,
scores as on the CPU, the trained models installed).

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


@pytest.mark.parametrize(
    "shape,dtype,packed",
    [
        ((2, 129, 3, 64), torch.float32, False),
        ((1, 333, 2, 128), torch.float32, False),
        ((2, 100, 4, 32), torch.float32, True),
        ((1, 333, 2, 8), torch.bfloat16, False),
    ],
)
def test_tf32x3_bwd_prepass_matches_its_plain_split_bit_for_bit(cuda, shape, dtype, packed):
    """The backward's pre-pass: Q, K, V, dO as stored and Q, dO, K
    transposed, hi/lo planes (ragged T, a packed view, bf16's one plane)."""
    g = torch.Generator(device="cuda").manual_seed(sum(shape) + 1)
    if packed:
        b, t, h, d = shape
        q, k, v, do = torch.randn((b, t, 4, h, d), generator=g, device="cuda").to(dtype).unbind(dim=2)
    else:
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(4))
    before = dict(flash.LAUNCHES_BY)
    with torch.no_grad():
        got = flash.tf32x3_bwd_prepass(q, k, v, do)
        torch.cuda.synchronize()
        want = flash.tf32x3_bwd_prepass_reference(q, k, v, do)
    assert flash.LAUNCHES_BY == before  # a check, not a backward
    assert len(got) == len(want) == 7
    for g_, w in zip(got, want):
        assert g_.shape == w.shape
        assert torch.equal(g_.view(torch.int32), w.contiguous().view(torch.int32))


# a backward kernel against flash_backward_reference on the same (O, LSE,
# dO), per element rtol·|ref| + atol·max|ref| (chip_smoke.BWD_TOL: another
# float32 summation order; in bfloat16 one rounding step and one more);
# bwd_sm90 rounds P and dS to bfloat16 before its products, which adds at
# most 2⁻⁸ times ``flash.bwd_rounding_terms``
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2**-6, 1e-5)}


@pytest.mark.parametrize(
    "shape,dtype,packed,kernel",
    [
        ((2, 129, 3, 64), torch.float32, False, "bwd_tf32x3"),
        ((1, 70, 2, 16), torch.float32, False, "bwd_tf32x3"),
        ((1, 96, 8, 128), torch.float32, False, "bwd_tf32x3"),
        ((2, 150, 4, 32), torch.float32, True, "bwd_tf32x3"),  # views of one [B, T, 3, H, D]
        ((1, 100, 2, 32), torch.bfloat16, False, "bwd_sm90"),
        ((1, 77, 2, 16), torch.bfloat16, False, "bwd_sm90"),
        ((2, 129, 3, 64), torch.bfloat16, False, "bwd_sm90"),
        ((1, 300, 2, 128), torch.bfloat16, False, "bwd_sm90"),
        ((2, 150, 4, 64), torch.bfloat16, True, "bwd_sm90"),  # views of one [B, T, 3, H, D]
        ((2, 100, 4, 8), torch.bfloat16, False, "bwd_tf32x3"),  # its bf16 role
    ],
)
def test_backward_kernel_matches_plain_version(cuda, shape, dtype, packed, kernel):
    """Ragged T, causal: dQ, dK, dV from the kernel of the route and from
    the plain version on the forward kernel's O and LSE; one launch, counted
    under that kernel."""
    assert flash.bwd_kernel_for(dtype, shape[-1]) == kernel
    if packed:
        b, t, h, d = shape
        g = torch.Generator(device="cuda").manual_seed(sum(shape))
        q, k, v = torch.randn((b, t, 3, h, d), generator=g, device="cuda").to(dtype).unbind(dim=2)
    else:
        q, k, v = _qkv(shape, dtype, seed=sum(shape))
    do = _qkv(shape, dtype, seed=sum(shape) + 1)[0]
    with torch.no_grad():
        o, lse = flash.launch_kernel(q, k, v, True)
    before = dict(flash.LAUNCHES_BY)
    got = flash.flash_backward(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert flash.LAUNCHES_BY == {**before, kernel: before[kernel] + 1}
    want = flash.flash_backward_reference(q, k, v, o, lse, do, causal=True)
    terms = flash.bwd_rounding_terms(q, k, v, o, lse, do, True) if kernel == "bwd_sm90" else (0, 0, 0)
    rtol, atol = BWD_TOL[dtype]
    for g, w, term in zip(got, want, terms):
        assert g.shape == q.shape and g.dtype == dtype
        diff = (g.float() - w.float()).abs()
        limit = rtol * w.float().abs() + atol * w.float().abs().max() + P_ROUNDING * term
        assert (diff <= limit).all(), (diff / limit).max().item()


def test_ulysses_gradient_on_the_card(cuda):
    """Ulysses over an sp = 1 NCCL group with the flash kernels as its
    per-device compute: one forward and one backward launch, gradients as
    ``local_attention``'s under autograd (float32: summation order only)."""
    import torch.distributed as dist

    from dragonfly2_torch.ops.ring import local_attention
    from dragonfly2_torch.ops.ulysses import make_ulysses_attention
    from dragonfly2_torch.parallel import make_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        uly = make_ulysses_attention(make_mesh(sp=1), "sp", causal=True, use_kernel=True)
        base = _qkv((2, 300, 4, 64), torch.float32, seed=3)
        grads = []
        for fn in (uly, lambda q, k, v: local_attention(q, k, v, causal=True)):
            q, k, v = (x.clone().requires_grad_(True) for x in base)
            flash.reset_launches()
            (fn(q, k, v) ** 2).sum().backward()
            torch.cuda.synchronize()
            grads.append([x.grad for x in (q, k, v)])
            if not grads[1:]:
                assert flash.LAUNCHES_BY == {
                    "sm90": 0, "tf32x3": 1, "bwd": 0, "bwd_sm90": 0, "bwd_tf32x3": 1
                }
        for g, w in zip(*grads):
            torch.testing.assert_close(g, w, atol=1e-4 * w.abs().max().item(), rtol=1e-3)
    finally:
        dist.destroy_process_group()


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


@pytest.mark.parametrize("rows", [5, 64, 74, 300])
def test_scorer_graph_replays_the_forward_bit_for_bit(cuda, rows):
    """The captured ranked forward (a rung below, at and past the
    pre-captured ones) gives what ``score_ranked`` gives op by op, also
    with four threads replaying the same rung at once."""
    import threading

    from dragonfly2_torch.trainer.serving import bucket_rows, score_ranked

    mlp = init_mlp(torch.Generator().manual_seed(0), [19, 128, 128, 1])
    scorer = MLPScorer(mlp, device="cuda")
    rng = np.random.default_rng(rows)
    inputs = [rng.random((rows, 19)).astype(np.float32) for _ in range(4)]
    seg = np.repeat(np.arange(rows // 5 + 1), 5)[:rows]

    def eager(x):
        packed = np.full((bucket_rows(rows), 20), seg[-1] + 1, np.float32)
        packed[:rows, :-1], packed[:rows, -1] = x, seg
        with torch.no_grad():
            s, order = score_ranked(scorer._mlp, torch.from_numpy(packed).cuda())
        return s.cpu().numpy()[:rows], order.cpu().numpy()[:rows]

    got = [None] * 4

    def replay(k):
        for _ in range(20):
            got[k] = scorer.predict_ranked(inputs[k], seg)

    threads = [threading.Thread(target=replay, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for x, (s, order) in zip(inputs, got):
        want_s, want_order = eager(x)
        np.testing.assert_array_equal(s, want_s)
        np.testing.assert_array_equal(order, want_order)
        assert order.dtype == np.int64
    assert bucket_rows(rows) in scorer._graphs


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


# -- the trainer's fit path ----------------------------------------------------
#
# Fits on the card (bfloat16 matmul inputs) against the same fits on the CPU
# (float32), from one init, held at 5e-2 relative (chip_smoke.FIT_TOL):
# bf16 inputs emulated on the CPU stay within half of it
# (tests/test_torch_ingest.py); the GNN's SAGE layers are bf16 on both.

FIT_TOL = 5e-2


@pytest.fixture(scope="module")
def train_file(tmp_path_factory):
    from dragonfly2_torch.schema import synth, wire

    recs = synth.make_download_records(512, seed=4)
    path = tmp_path_factory.mktemp("fit") / "download.dfb"
    path.write_bytes(b"".join(wire.encode_train_block(recs[i : i + 64]) for i in range(0, 512, 64)))
    return path


def _init_tree(dims):
    from dragonfly2_torch.weights import module_tree

    return module_tree(init_mlp(torch.Generator().manual_seed(0), dims))


@pytest.mark.parametrize("k", [1, 4])
def test_streamed_fit_steps_on_the_card_match_the_cpu(cuda, train_file, k):
    from dragonfly2_torch.trainer.ingest import stream_train_mlp

    kw = dict(passes=2, batch_size=128, hidden_dims=(32, 32), workers=1, steps_per_call=k,
              transfer_dtype=np.float32, init=_init_tree([19, 32, 32, 1]))
    mlp, card = stream_train_mlp(train_file, device=cuda, **kw)
    _, cpu = stream_train_mlp(train_file, device="cpu", **kw)
    assert next(mlp.parameters()).device.type == "cuda"
    assert (card.steps, card.pairs, card.eval_pairs) == (cpu.steps, cpu.pairs, cpu.eval_pairs)
    assert card.steps >= 8 and card.h2d_s > 0
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=FIT_TOL)
    assert card.metrics["mse"] == pytest.approx(cpu.metrics["mse"], rel=FIT_TOL)


def test_batch_fit_on_the_card_matches_the_cpu(cuda):
    from dragonfly2_torch.schema import synth
    from dragonfly2_torch.schema.columnar import records_to_columns
    from dragonfly2_torch.schema.features import extract_pair_features
    from dragonfly2_torch.trainer.train import FitConfig, train_mlp

    pairs = extract_pair_features(records_to_columns(synth.make_download_records(200, seed=2)))
    cfg = FitConfig(hidden_dims=(32,), batch_size=64, epochs=2, init=_init_tree([19, 32, 1]))
    card = train_mlp(pairs.features, pairs.labels, cfg, device=cuda)
    cpu = train_mlp(pairs.features, pairs.labels, cfg, device="cpu")
    assert next(card.params.parameters()).device.type == "cuda"
    np.testing.assert_allclose(card.history, cpu.history, rtol=FIT_TOL)
    assert card.metrics["mse"] == pytest.approx(cpu.metrics["mse"], rel=FIT_TOL)


def test_one_gnn_epoch_on_the_card_matches_the_cpu(cuda):
    from dragonfly2_torch.models.gnn import init_graphsage
    from dragonfly2_torch.schema import synth
    from dragonfly2_torch.schema.columnar import records_to_columns
    from dragonfly2_torch.schema.features import build_probe_graph
    from dragonfly2_torch.trainer.train import GNNFitConfig, train_gnn
    from dragonfly2_torch.weights import module_tree

    graph = build_probe_graph(
        records_to_columns(synth.make_topology_records(300, num_hosts=40, seed=3)), max_degree=8
    )
    init = init_graphsage(torch.Generator().manual_seed(0), 7, (16, 16), num_nodes=graph.num_nodes)
    cfg = GNNFitConfig(hidden_dims=(16, 16), batch_size=64, epochs=1, init=module_tree(init))
    card = train_gnn(graph, cfg, device=cuda)
    cpu = train_gnn(graph, cfg, device="cpu")
    assert next(card.params.parameters()).device.type == "cuda"
    np.testing.assert_allclose(card.history, cpu.history, rtol=FIT_TOL)
    for key in ("mse", "mae"):
        assert card.metrics[key] == pytest.approx(cpu.metrics[key], rel=FIT_TOL)


def test_pinned_buffers_are_never_rewritten_while_their_copy_is_in_flight(cuda, train_file, monkeypatch):
    """Every superbatch buffer is pinned, and each one the packing thread
    takes back after a copy has its copy's event complete (the pool
    raises otherwise); with 6 buffers and ~30 superbatches each is reused
    several times."""
    from dragonfly2_torch.trainer import ingest

    pools = []
    init = ingest._BufferPool.__init__

    def recording_init(pool, *args):
        init(pool, *args)
        pools.append(pool)
        assert all(buf.is_pinned() for buf in pool.free.queue)

    monkeypatch.setattr(ingest._BufferPool, "__init__", recording_init)
    _, stats = ingest.stream_train_mlp(
        train_file, passes=2, batch_size=64, hidden_dims=(32, 32), workers=1, device=cuda
    )
    assert stats.steps >= 24
    assert len(pools) == 1 and pools[0].checked >= stats.steps - ingest._POOL_BUFFERS


def test_a_training_round_on_the_card_uploads_both_models_and_traces_them(cuda, tmp_path):
    import json

    from dragonfly2_torch.scheduler.model_refresher import ManagerUploader, PlainRequests
    from dragonfly2_torch.schema import synth, wire
    from dragonfly2_torch.trainer.service import PlainMessages, TrainerService
    from dragonfly2_torch.trainer.storage import TrainerStorage
    from dragonfly2_torch.trainer.train import FitConfig, GNNFitConfig
    from dragonfly2_torch.trainer.training import Training, TrainingConfig

    class Stub:
        def __init__(self):
            self.requests = []

        def CreateModel(self, request):
            self.requests.append(request)

    recs = synth.make_download_records(256, seed=1)
    blocks = b"".join(wire.encode_train_block(recs[i : i + 64]) for i in range(0, 256, 64))
    topo = wire.encode_topology_block(synth.make_topology_records(200, num_hosts=40, seed=2))
    messages = PlainMessages()
    stub = Stub()
    cfg = TrainingConfig(
        mlp=FitConfig(hidden_dims=(32,), batch_size=128, epochs=2),
        gnn=GNNFitConfig(hidden_dims=(16, 16), batch_size=64, epochs=2),
        gru=False, streaming_workers=1, streaming_threshold_bytes=0,
        profile_dir=str(tmp_path / "prof"),
    )
    storage = TrainerStorage(tmp_path / "storage")
    training = Training(storage, ManagerUploader(stub, PlainRequests()), cfg, device=cuda)
    TrainerService(storage, training, synchronous=True, messages=messages).Train(
        iter([messages.train_request("10.0.0.9", "s", "train_mlp_binary", blocks),
              messages.train_request("10.0.0.9", "s", "train_gnn_binary", topo)]),
        None,
    )
    assert sorted(r.type for r in stub.requests) == ["gnn", "mlp"]
    assert all(np.isfinite(r.evaluation.mse) for r in stub.requests)
    (trace,) = (tmp_path / "prof").iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)  # CUDA kernels in the round's trace


# -- GNN and GRU serving, the preheat forecaster --------------------------------
#
# The GRU computes in float32 on both devices with TF32 off: only the
# summation order differs. The GNN's SAGE layers are bfloat16 on both; its
# head takes the device's policy (bfloat16 inputs on the card), so scores
# are held at the scorer's 2e-2 as the MLP's are.

GRU_TOL = 2e-5
FORECAST_TOL = 1e-3


def _gru_tree(in_dim, hidden, seed=0):
    from dragonfly2_torch.models.gru import init_gru
    from dragonfly2_torch.weights import module_tree

    return module_tree(init_gru(torch.Generator().manual_seed(seed), in_dim, hidden))


def test_gru_forward_on_the_card_matches_the_cpu(cuda):
    """``predict_next_cost`` on length-masked histories and ``GRUScorer``
    on histories past ``GRU_MAX_SEQ`` (with the zero-length pad rows of the
    bucket rung), card against CPU."""
    from dragonfly2_torch.models.gru import predict_next_cost
    from dragonfly2_torch.schema.features import GRU_MAX_SEQ
    from dragonfly2_torch.trainer.serving import GRUScorer
    from dragonfly2_torch.weights import gru_from_numpy

    tree = _gru_tree(2, 32)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((70, 9, 2)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(0, 10, 70))
    with torch.no_grad():
        card = predict_next_cost(gru_from_numpy(tree, device=cuda), x.to(cuda), lengths.to(cuda))
        cpu = predict_next_cost(gru_from_numpy(tree, device="cpu"), x, lengths)
    assert card.device.type == "cuda"
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=GRU_TOL, rtol=0)
    hists = [list(rng.lognormal(np.log(40.0), 0.6, n)) for n in (1, 3, GRU_MAX_SEQ, GRU_MAX_SEQ + 7, 40)]
    scorer = GRUScorer(tree, device=cuda)
    assert next(scorer._model.parameters()).device.type == "cuda"
    np.testing.assert_allclose(
        scorer.predict_next_log_cost(hists),
        GRUScorer(tree, device="cpu").predict_next_log_cost(hists),
        atol=GRU_TOL, rtol=0,
    )


def test_forecaster_on_the_card_matches_the_cpu(cuda):
    """One set of demand-GRU params in a forecaster on the card and one on
    the CPU: the horizon forecast agrees with both and with the numpy
    version (≤ 1e-3, the reference's limit between its paths)."""
    from dragonfly2_torch.preheat.forecast import DEMAND_FEATURE_DIM, DemandForecaster

    tree = _gru_tree(DEMAND_FEATURE_DIM, 16, seed=1)
    tree["head"]["layers"][-1]["b"] = np.full((1,), 1.2, np.float32)
    rng = np.random.default_rng(1)
    counts = np.abs(rng.normal(3.0, 2.0, (70, 32))).astype(np.float32)
    card, cpu = DemandForecaster(32, device=cuda), DemandForecaster(32, device="cpu")
    card.set_params(tree)
    cpu.set_params(tree)
    got = card.forecast_demand(counts)
    assert got.shape == (70,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, cpu.forecast_demand(counts), atol=FORECAST_TOL, rtol=0)
    np.testing.assert_allclose(got, card.forecast_demand_np(counts), atol=FORECAST_TOL, rtol=0)


def test_a_gnn_installs_on_the_card_and_serves_its_waves(cuda):
    """The refresher installs an active GNN on the card — its embeddings
    made at swap time over the engine's export — and the service scores
    host pairs with it as the same GNN on the CPU does (≤ 2e-2)."""
    from types import SimpleNamespace

    from dragonfly2_torch.models.gnn import init_graphsage
    from dragonfly2_torch.scheduler.model_refresher import ModelRefresher, PlainRequests
    from dragonfly2_torch.scheduler.networktopology import NetworkTopology
    from dragonfly2_torch.schema.columnar import records_to_columns
    from dragonfly2_torch.schema.features import GNN_NODE_FEATURE_DIM, build_probe_graph
    from dragonfly2_torch.trainer.serving import GNNScorer, serialize_params
    from dragonfly2_torch.utils.kvstore import KVStore

    hosts = 40
    resource = res.Resource()
    for i in range(hosts):
        resource.host_manager.store(res.Host(id=f"h{i}", hostname=f"h{i}", ip=f"10.0.0.{i}"))
    rng = np.random.default_rng(2)
    engine = TopologyEngine(TopologyConfig(flush_threshold=10**9), device=cuda, clock=lambda: 1000.0)
    for i in range(hosts):
        for j in rng.choice([k for k in range(hosts) if k != i], 6, replace=False):
            engine.enqueue(f"h{i}", f"h{j}", int(rng.integers(1, 80) * 1e6), created_at=990.0)
    topology = NetworkTopology(KVStore(), resource.host_manager, engine=engine)
    graph = build_probe_graph(records_to_columns(topology.export_records()))
    gnn = init_graphsage(torch.Generator().manual_seed(0), GNN_NODE_FEATURE_DIM, (16, 16),
                         num_nodes=graph.num_nodes)
    blobs = {"mlp": serialize_params(init_mlp(torch.Generator().manual_seed(0), [19, 16, 1])),
             "gnn": serialize_params(gnn)}

    class Manager:
        def ListModels(self, request):
            return SimpleNamespace(models=[
                SimpleNamespace(model_id=f"{k}-model", type=k, version=1, state="active",
                                updated_at_ns=1, created_at_ns=1)
                for k in blobs
            ])

        def GetModelWeights(self, request):
            return SimpleNamespace(weights=blobs[request.model_id.split("-")[0]])

    service = ScoringService()
    service.start()
    try:
        refresher = ModelRefresher(Manager(), MLEvaluator(serving=service), serving=service,
                                   networktopology=topology, device=cuda, requests=PlainRequests())
        assert refresher.refresh_once()
        assert refresher.loaded_gnn_version == ("gnn-model", 1) and service.model_kind() == "gnn"
        served = service._served[0]._scorer
        assert served._emb.device.type == "cuda"
        pairs = [(f"h{a}", f"h{b}") for a, b in rng.integers(0, hosts, (50, 2))]
        got = service.score(np.zeros((50, 19), np.float32), pairs)
        want = GNNScorer(gnn, graph, device="cpu").predict_rtt_log_ms(
            [a for a, _ in pairs], [b for _, b in pairs]
        )
        np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    finally:
        service.stop()


def test_live_servers_on_the_card(cuda):
    """The scheduler and trainer servers built on the card (the engine,
    the scorers the refresher installs and the fits), driven over gRPC by
    ``chip_smoke.server_leg`` at a reduced size: the leg's own checks —
    legal parents, no decision below the serving rung after the warm-up,
    ``rank_order`` of the card scores, the MLP within 2e-2 and the GNN
    within 5e-2 of the CPU, the three uploads installed — raise on any
    failure."""
    import chip_smoke

    out = chip_smoke.server_leg(
        "cuda", hosts=128, probes=16, tasks=8, peers=64, concurrency=8, phase2=16,
        probe_rounds=4, mlp_batch=16, gnn_epochs=300,
    )
    assert out["edges"] == 128 * 16
    assert out["phase1"]["served"] > 0 and out["phase2"]["served"] > 0
    assert out["score_err"]["mlp"] <= chip_smoke.SCORE_TOL
    assert out["score_err"]["gnn"] <= chip_smoke.GNN_SCORE_TOL
