"""The port on an NVIDIA card: the CUDA flash kernel against its plain
PyTorch version (strided inputs and launch counting included), and the
serving and topology planes on the card against the same port on the CPU.

Every test here needs a card and skips without one. It imports neither jax
nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dragonfly2_torch.models.mlp import init_mlp
from dragonfly2_torch.ops import flash
from dragonfly2_torch.scheduler import wave
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
# LSE is float32 on both sides
O_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2**-6)}
LSE_TOL = 1e-4


def _assert_o_close(o, ref):
    atol, rtol = O_TOL[ref.dtype]
    diff = (o.float() - ref.float()).abs()
    assert (diff <= atol + rtol * ref.float().abs()).all(), diff.max().item()


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
    ],
)
def test_kernel_matches_plain_version(cuda, shape, dtype, causal):
    q, k, v = _qkv(shape, dtype, seed=sum(shape))
    before = flash.LAUNCHES
    with torch.no_grad():
        o, lse = flash.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash.flash_attention_reference(q, k, v, causal=causal)
    assert flash.LAUNCHES == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    _assert_o_close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as views of one packed [B, T, 3, H, D] projection: the
    kernel walks their strides instead of copying."""
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
