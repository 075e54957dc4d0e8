"""The port's flash attention (dragonfly2_torch.ops.flash) against the JAX
package's Pallas kernel in interpret mode, on the same seeded inputs. On
the CPU the port's wrapper takes its plain PyTorch version; the CUDA kernel
itself is held against that plain version on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_torch import resolve_device
from dragonfly2_torch.models.attention import init_transformer
from dragonfly2_torch.models.mlp import init_mlp
from dragonfly2_torch.ops import flash as tflash
from dragonfly2_torch.ops.ring import local_attention as t_local_attention
from dragonfly2_torch.topology import TopologyConfig, TopologyEngine
from dragonfly2_torch.trainer.serving import MLPScorer
from dragonfly2_torch.weights import mlp_from_numpy, module_tree, transformer_from_numpy
from dragonfly2_tpu.ops.flash import _flash_forward, flash_attention
from dragonfly2_tpu.ops.ring import local_attention

torch.set_num_threads(1)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "shape",
    [
        (2, 128, 4, 64),  # block-aligned
        (2, 200, 4, 64),  # ragged tail: the reference pads and masks keys
        (1, 64, 2, 32),  # shorter than one default block
    ],
)
def test_plain_path_matches_pallas_interpret(shape, causal):
    q, k, v = _qkv(shape)
    want_o = np.asarray(flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True))
    _, want_lse = _flash_forward(
        *map(jnp.asarray, (q, k, v)), causal, 128, 128, True
    )
    o, lse = tflash.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (shape[0], shape[2], shape[1])
    # summation order differs (f32): the reference's own oracle tolerance
    np.testing.assert_allclose(o.numpy(), want_o, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_bfloat16_plain_path_matches_pallas_interpret(causal):
    q, k, v = _qkv((2, 256, 4, 64), seed=3)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(flash_attention(jq, jk, jv, causal=causal, interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=causal)
    assert out.dtype == torch.bfloat16
    # the two f32 sums may land on either side of a bf16 rounding point:
    # one step (2^-7·|O|) apart, with room for one more
    np.testing.assert_allclose(out.float().numpy(), want, atol=1e-5, rtol=2**-6)


@pytest.mark.parametrize("causal", [False, True])
def test_local_attention_matches_reference(causal):
    q, k, v = _qkv((2, 100, 4, 16), seed=5)
    want = np.asarray(local_attention(*map(jnp.asarray, (q, k, v)), causal=causal))
    got = t_local_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_block_hints_do_not_change_the_result():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 100, 2, 32), seed=11))
    a = tflash.flash_attention(q, k, v, causal=True)
    b = tflash.flash_attention(q, k, v, causal=True, block_q=64, block_k=48)
    assert torch.equal(a, b)


def test_plain_path_does_not_count_launches():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 64, 2, 32)))
    before = tflash.LAUNCHES
    tflash.flash_attention(q, k, v)
    assert tflash.LAUNCHES == before


def test_cuda_requested_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only machine")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")


@pytest.mark.parametrize(
    "entry",
    [
        lambda: resolve_device(),
        lambda: mlp_from_numpy(module_tree(init_mlp(torch.Generator(), [19, 8, 1]))),
        lambda: transformer_from_numpy(
            module_tree(init_transformer(torch.Generator(), 2, 16, 2, 1))
        ),
        lambda: MLPScorer(init_mlp(torch.Generator(), [19, 8, 1])),
        lambda: TopologyEngine(TopologyConfig()),
    ],
    ids=["resolve_device", "mlp_from_numpy", "transformer_from_numpy", "MLPScorer",
         "TopologyEngine"],
)
def test_entry_points_default_to_the_card(entry):
    """Called without ``device=``, every entry point asks for the card and
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only machine")
    with pytest.raises(RuntimeError, match="cuda"):
        entry()


def test_requires_grad_input_raises():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 64, 2, 32)))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        tflash.flash_attention(q, k, v)
    with torch.no_grad():  # inference through the same tensors is fine
        assert tflash.flash_attention(q, k, v).shape == q.shape


@pytest.mark.parametrize(
    "bad",
    [
        lambda q: (q, q[:, :10], q),  # mismatched shapes
        lambda q: (q.double(), q.double(), q.double()),  # unsupported dtype
        lambda q: (q[0], q[0], q[0]),  # not [B, T, H, D]
    ],
)
def test_bad_inputs_raise(bad):
    q = torch.zeros(1, 16, 2, 8)
    with pytest.raises((ValueError, TypeError)):
        tflash.flash_attention(*bad(q))
