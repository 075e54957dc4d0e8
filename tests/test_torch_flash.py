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
        (2, 100, 4, 8),  # the tf32x3 kernel's smallest head
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
def test_head_dim_8_bfloat16_plain_path_matches_pallas_interpret(causal):
    """bf16 at D = 8 is the tf32x3 kernel's other role."""
    q, k, v = _qkv((2, 100, 4, 8), seed=9)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(flash_attention(jq, jk, jv, causal=causal, interpret=True), np.float32)
    _, want_lse = _flash_forward(jq, jk, jv, causal, 128, 128, True)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out, lse = tflash.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, atol=1e-5, rtol=2**-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5)


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
    """Kept under its old name: an input that requires grad no longer
    raises. A gradient flows back through the plain backward, and inference
    without a gradient gives the same output as before."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 64, 2, 32)))
    with torch.no_grad():
        plain = tflash.flash_attention(q, k, v)
    q.requires_grad_(True)
    out = tflash.flash_attention(q, k, v)
    assert out.requires_grad and torch.equal(out.detach(), plain)
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape and torch.isfinite(q.grad).all()
    with torch.no_grad():  # inference through the same tensors is unchanged
        again = tflash.flash_attention(q, k, v)
    assert not again.requires_grad and torch.equal(again, plain)


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


def _tensor_core_emulation(q, k, v, causal, l_from_rounded_p=False, block=128):
    """The sm90 kernel's arithmetic in plain torch: 128-key tiles, online
    softmax in base 2 on float32 scores, P rounded to bfloat16 before P·V,
    and l summed from the float32 P (or, to pin the trap, from the rounded
    P) → (O in bfloat16, LSE float32)."""
    b, t, h, d = q.shape
    scale_log2 = (1.0 / d**0.5) * 1.4426950408889634
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((b, h, t), tflash.NEG_INF)
    l = torch.zeros(b, h, t)
    acc = torch.zeros(b, h, t, d)
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, block):
        s = qf @ kf[:, :, k0 : k0 + block].transpose(-1, -2)
        if causal:
            s = s.masked_fill(torch.arange(k0, min(k0 + block, t))[None, :] > rows, tflash.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * scale_log2)
        p = torch.exp2(s * scale_log2 - (m_new * scale_log2)[..., None])
        p_bf16 = p.bfloat16().float()
        l = l * alpha + (p_bf16 if l_from_rounded_p else p).sum(-1)
        acc = acc * alpha[..., None] + p_bf16 @ vf[:, :, k0 : k0 + block]
        m = m_new
    o = (acc / l.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3).bfloat16()
    lse = torch.where(
        l > 0, (m * scale_log2 + torch.log2(l)) * 0.6931471805599453, torch.full_like(m, tflash.NEG_INF)
    )
    return o, lse


def _bf16_qkv(shape, seed):
    return [torch.from_numpy(x).bfloat16() for x in _qkv(shape, seed)]


# the sm90 kernel's O limit per element: the bf16 limit of the plain path
# plus the worst case of rounding P to bfloat16, 2⁻⁸·(P·|V|)/l
def _sm90_o_share(o, ref, term):
    diff = (o.float() - ref.float()).abs()
    return (diff / (1e-5 + 2**-6 * ref.float().abs() + 2**-8 * term)).max().item()


@pytest.mark.parametrize("causal", [False, True])
def test_rounding_p_stays_inside_the_sm90_limit(causal):
    q, k, v = _bf16_qkv((1, 1024, 2, 64), seed=21)
    o_ref, lse_ref = tflash.flash_attention_reference(q, k, v, causal)
    term = tflash.p_rounding_term(q, k, v, causal)
    o, lse = _tensor_core_emulation(q, k, v, causal)
    assert _sm90_o_share(o, o_ref, term) <= 1.0
    assert (lse - lse_ref).abs().max().item() <= 1e-4
    # the plain path's own bf16 limit has no room for the rounded P
    diff = (o.float() - o_ref.float()).abs()
    assert (diff > 1e-5 + 2**-6 * o_ref.float().abs()).any()


@pytest.mark.parametrize("causal", [False, True])
def test_l_from_rounded_p_breaks_the_lse_limit(causal):
    q, k, v = _bf16_qkv((1, 1024, 2, 64), seed=21)
    _, lse_ref = tflash.flash_attention_reference(q, k, v, causal)
    _, lse = _tensor_core_emulation(q, k, v, causal, l_from_rounded_p=True)
    assert (lse - lse_ref).abs().max().item() > 1e-4


def test_p_rounding_term_is_the_weighted_mean_of_abs_v():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 50, 2, 16), seed=4))
    got = tflash.p_rounding_term(q, k, v, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    s = s.masked_fill(~torch.ones(50, 50, dtype=torch.bool).tril(), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.abs())
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    assert (got >= 0).all()


@pytest.mark.parametrize(
    "dtype,d,kernel",
    [
        (torch.bfloat16, 16, "sm90"),
        (torch.bfloat16, 32, "sm90"),
        (torch.bfloat16, 64, "sm90"),
        (torch.bfloat16, 128, "sm90"),
        (torch.bfloat16, 8, "tf32x3"),
        (torch.float32, 64, "tf32x3"),
        (torch.float32, 8, "tf32x3"),
    ],
)
def test_kernel_is_chosen_by_dtype_and_head_dim(dtype, d, kernel):
    assert tflash.kernel_for(dtype, d) == kernel


@pytest.mark.parametrize(
    "make",
    [
        lambda: torch.zeros((1, 16, 2, 68), dtype=torch.bfloat16)[..., :64],  # 136-byte H stride
        lambda: torch.zeros(1 + 16 * 2 * 64, dtype=torch.bfloat16)[1:].view(1, 16, 2, 64),  # address
    ],
    ids=["stride", "address"],
)
def test_sm90_refuses_unaligned_tma_inputs_before_launching(make):
    """Checked before anything is built or launched, so it runs here too."""
    q = make()
    k = v = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    before = dict(tflash.LAUNCHES_BY)
    with pytest.raises(ValueError, match="16-byte"):
        tflash.launch_kernel(q, k, v, causal=False)
    assert tflash.LAUNCHES_BY == before


def test_reset_launches():
    tflash.LAUNCHES_BY["sm90"] += 3
    tflash.LAUNCHES_BY["bwd_sm90"] += 2
    tflash.reset_launches()
    assert tflash.LAUNCHES == 0 and tflash.LAUNCHES_BY == {"sm90": 0, "tf32x3": 0, "bwd": 0, "bwd_sm90": 0}


@pytest.mark.parametrize(
    "dtype,d,error",
    [
        (torch.float32, 24, ValueError),  # no float32 build at D = 24
        (torch.bfloat16, 64, ValueError),  # tf32x3 takes bfloat16 at D = 8 only
        (torch.float16, 8, TypeError),
    ],
)
def test_tf32x3_refuses_what_it_does_not_take_before_launching(dtype, d, error):
    q = torch.zeros((1, 16, 2, d), dtype=dtype)
    before = dict(tflash.LAUNCHES_BY)
    with pytest.raises(error):
        tflash.launch_kernel(q, q, q, causal=False, kernel="tf32x3")
    assert tflash.LAUNCHES_BY == before


def test_sm90_refuses_float32_before_launching():
    q = torch.zeros((1, 16, 2, 64))
    with pytest.raises(TypeError):
        tflash.launch_kernel(q, q, q, causal=False, kernel="sm90")


# --- 3xTF32: the plain split and an emulation of the tf32x3 kernel ---


def _wide_floats(n, seed):
    """float32 values over 40 decades, both signs, every mantissa pattern."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0 ** rng.uniform(-20, 20, n)
    return torch.from_numpy(x.astype(np.float32))


def test_tf32_split_parts_are_tf32_and_sum_back_to_x():
    x = _wide_floats(200_000, seed=1)
    hi, lo = tflash.tf32_split(x)
    for part in (hi, lo):  # 11 significant bits: the 13 low mantissa bits are 0
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    # hi + lo holds x to 2^-23·|x| (lo drops the last bits of x − hi) ...
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0**-23 * x.double().abs()).all()
    assert (lo.abs() <= 2.0**-11 * hi.abs()).all()
    # ... and exactly when x has at most 22 significant bits
    x22 = (x.view(torch.int32) & -4).view(torch.float32)
    hi, lo = tflash.tf32_split(x22)
    assert torch.equal(hi + lo, x22)


def test_tf32_round_is_to_nearest_with_ties_away_from_zero():
    one_ulp = 2.0**-10  # TF32's step at 1.0
    x = torch.tensor(
        [1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2**-23, 1 + one_ulp / 2 + 2**-23,
         2 - one_ulp / 4],  # the last carries into the exponent
        dtype=torch.float32,
    )
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp, 2.0], dtype=torch.float32)
    assert torch.equal(tflash.tf32_round(x), want)


def _products(a, b, products):
    """a @ b as the tf32x3 kernel multiplies: three TF32 products (lo·hi,
    hi·lo, hi·hi; each exact in float32, summed in float32), or one product
    of the TF32 roundings."""
    if products == 1:
        return tflash.tf32_round(a) @ tflash.tf32_round(b)
    (ah, al), (bh, bl) = tflash.tf32_split(a), tflash.tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def _tf32x3_emulation(q, k, v, causal, products=3, block=64):
    """The tf32x3 kernel's arithmetic in plain torch: 64-key tiles, S and
    P·V in ``products`` TF32 products each, online softmax in base 2 on
    float32 S, l from the float32 P → (O in q's dtype, LSE float32). In
    bfloat16 the lo parts of Q, K and V are 0, so three products are
    S = Q·Kᵀ and P_lo·V + P_hi·V, and one product rounds P to TF32."""
    b, t, h, d = q.shape
    scale_log2 = (1.0 / d**0.5) * 1.4426950408889634
    qf, kf, vf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v))
    m = torch.full((b, h, t), tflash.NEG_INF)
    l = torch.zeros(b, h, t)
    acc = torch.zeros(b, h, t, d)
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, block):
        s = _products(qf, kf[:, :, k0 : k0 + block].transpose(-1, -2), products)
        if causal:
            s = s.masked_fill(torch.arange(k0, min(k0 + block, t))[None, :] > rows, tflash.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * scale_log2)
        p = torch.exp2(s * scale_log2 - (m_new * scale_log2)[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _products(p, vf[:, :, k0 : k0 + block], products)
        m = m_new
    o = (acc / l.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    lse = torch.where(
        l > 0, (m * scale_log2 + torch.log2(l)) * 0.6931471805599453, torch.full_like(m, tflash.NEG_INF)
    )
    return o, lse


# the plain path's limits (PERF.md §2): O per element, LSE absolute
_O_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-5, 2**-6)}


def _limit_shares(o, lse, o_ref, lse_ref):
    atol, rtol = _O_TOL[o_ref.dtype]
    diff = (o.float() - o_ref.float()).abs()
    return (diff / (atol + rtol * o_ref.float().abs())).max().item(), (
        (lse - lse_ref).abs().max().item() / 1e-4
    )


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 1024, 2, 64), (1, 1024, 2, 8)])
def test_three_tf32_products_keep_the_float32_limits_and_one_does_not(shape, causal):
    q, k, v = (torch.from_numpy(x) for x in _qkv(shape, seed=31))
    o_ref, lse_ref = tflash.flash_attention_reference(q, k, v, causal)
    o_share, lse_share = _limit_shares(*_tf32x3_emulation(q, k, v, causal), o_ref, lse_ref)
    assert o_share <= 0.25 and lse_share <= 0.25  # 0.013–0.051 and 0.0095 here
    o_share, lse_share = _limit_shares(
        *_tf32x3_emulation(q, k, v, causal, products=1), o_ref, lse_ref
    )
    assert o_share > 1.0 and lse_share > 1.0  # 12–52× and 1.7–34× here


@pytest.mark.parametrize("causal", [False, True])
def test_bfloat16_at_d8_needs_p_split_for_its_limit(causal):
    q, k, v = _bf16_qkv((1, 1024, 2, 8), seed=31)
    o_ref, lse_ref = tflash.flash_attention_reference(q, k, v, causal)
    o_share, lse_share = _limit_shares(*_tf32x3_emulation(q, k, v, causal), o_ref, lse_ref)
    assert o_share <= 0.6 and lse_share <= 0.25  # 0.42 and 0.0095 here
    o_share, _ = _limit_shares(*_tf32x3_emulation(q, k, v, causal, products=1), o_ref, lse_ref)
    assert o_share > 1.0  # 2.3–3.5× here: P in one TF32 product


def test_vt_key_order_lets_p_registers_stand_as_they_lie():
    """The kernel hands the S accumulator's registers to the tf32 A
    fragment of P·V as they lie: A register r of a thread reads accumulator
    register ((r & 1) << 1) + (r >> 1). In each group of 8 keys the
    accumulator holds keys (2t, 2t+1) of rows (g, g+8) for quad thread t,
    and the fragment reads positions (t, t+4) of rows (g, g+8). Vᵀ from the
    pre-pass, with its keys in ``VT_KEY_ORDER``, gives back P·V."""
    t8 = 40
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.random((64, t8), dtype=np.float32))
    frag = torch.empty_like(p)  # P as the A fragments hold it, by position
    for t in range(4):
        for r in range(4):
            src = ((r & 1) << 1) + (r >> 1)
            assert src >> 1 == (r & 1)  # the same row half (g or g+8)
            key, pos = 2 * t + (src & 1), t + 4 * (r >> 1)
            assert tflash.VT_KEY_ORDER[pos] == key
            frag[:, pos::8] = p[:, key::8]
    v = torch.from_numpy(rng.standard_normal((1, t8 - 5, 1, 16)).astype(np.float32))
    _, _, vt = tflash.tf32x3_prepass_reference(v, v, v)
    assert vt.shape == (2, 1, 16, t8)
    assert (vt[:, :, :, t8 - 8 :][..., [3, 7]] == 0).all()  # keys 35 and 39 lie past T = 35
    vfull = vt[0, 0] + vt[1, 0]  # hi + lo, [D, T8]
    want = p[:, : t8 - 5] @ v[0, :, 0]
    torch.testing.assert_close(frag @ vfull.T, want, atol=1e-5, rtol=1e-5)
    # the keys in their own order would pair each weight with another key's row
    assert not torch.allclose(p @ vfull.T, want, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tf32x3_prepass_reference_layout(dtype):
    b, t, h, d = 2, 13, 3, 8
    qkv = torch.from_numpy(np.random.default_rng(5).standard_normal((b, t, 3, h, d)).astype(np.float32))
    q, k, v = qkv.to(dtype).unbind(dim=2)  # views of a packed projection
    qs, ks, vt = tflash.tf32x3_prepass_reference(q, k, v)
    planes = 2 if dtype == torch.float32 else 1
    assert qs.shape == ks.shape == (planes, b * h, t, d) and vt.shape == (planes, b * h, d, 16)
    assert qs.dtype == ks.dtype == vt.dtype == torch.float32
    heads_major = k.float().permute(0, 2, 1, 3).reshape(b * h, t, d)
    got = ks.sum(0)
    if dtype == torch.bfloat16:  # the exact upcast, no lo plane
        assert torch.equal(got, heads_major)
    else:
        assert ((got - heads_major).abs() <= 2.0**-23 * heads_major.abs()).all()
    order = list(tflash.VT_KEY_ORDER)
    first = v.float()[1, :8, 2].T  # batch 1, head 2, keys 0..7 → [D, 8]
    assert torch.allclose(vt.sum(0)[1 * h + 2, :, :8], first[:, order], atol=0, rtol=2.0**-22)
