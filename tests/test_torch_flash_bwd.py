"""The port's flash-attention gradient (dragonfly2_torch.ops.flash: the
``torch.autograd.Function``, ``flash_backward`` and its plain version
``flash_backward_reference``) against ``jax.grad`` of the JAX package's
``flash_attention`` in interpret mode — its ``custom_vjp`` with
``_blockwise_bwd`` — and of its ``local_attention``, on the same seeded
inputs and cotangents. On the CPU the wrapper takes the plain forward and
the plain backward; the CUDA backward kernel itself is held against the
plain version on the card (chip_smoke.py, tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_torch.ops import flash as tflash
from dragonfly2_tpu.ops.flash import _blockwise_bwd, _flash_forward, flash_attention
from dragonfly2_tpu.ops.ring import local_attention

torch.set_num_threads(1)


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _port_grads(q, k, v, g, causal, dtype=torch.float32, **kw):
    """(dq, dk, dv) of sum(flash_attention(q, k, v) ⊙ g) through autograd,
    as float32 numpy, and the dtype the gradients came back in."""
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=causal, **kw)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return [x.grad.float().numpy() for x in (tq, tk, tv)], tq.grad.dtype


def _jax_grads(fn, q, k, v, g, dtype=jnp.float32):
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    grads = jax.grad(
        lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * g), argnums=(0, 1, 2)
    )(*args)
    return [np.asarray(x, np.float32) for x in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [64, 70, 256])
def test_gradients_match_pallas_interpret(t, causal):
    """The reference's own test (tests/test_flash.py) on the port: ragged
    lengths included, within its limit 2e-3."""
    q, k, v, g = _arrays((2, t, 2, 16), seed=t + causal)
    want = _jax_grads(
        lambda *a: flash_attention(*a, causal=causal, interpret=True), q, k, v, g
    )
    got, dtype = _port_grads(q, k, v, g, causal)
    assert dtype == torch.float32
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=2e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 64, 2, 16), (1, 70, 2, 32), (2, 100, 4, 8)])
def test_bfloat16_gradients_match_pallas_interpret(shape, causal):
    """bfloat16 in both packages (D = 8 included, the tf32x3 kernel's other
    role): each side rounds q, k, v and O to bfloat16 and computes the
    backward in float32 from them, then rounds the gradients. The rounded O
    may differ by one step (the two forwards sum in other orders), and
    δ = rowsum(dO ⊙ O) carries that into dS = P ⊙ (dP − δ): within 2⁻⁶ of
    each entry and 2e-2 of the largest."""
    q, k, v, g = _arrays(shape, seed=sum(shape) + causal)
    want = _jax_grads(
        lambda *a: flash_attention(*a, causal=causal, interpret=True), q, k, v, g, jnp.bfloat16
    )
    got, dtype = _port_grads(q, k, v, g, causal, torch.bfloat16)
    assert dtype == torch.bfloat16
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(
            a, b, atol=2e-2 * np.abs(b).max(), rtol=2**-6, err_msg=f"d{name}"
        )


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 100, 4, 8), (1, 33, 2, 64), (1, 128, 1, 128)])
def test_gradients_match_local_attention(shape, causal):
    """The flash gradient against the oracle's (autograd through the whole
    [T, T] softmax in JAX), float32."""
    q, k, v, g = _arrays(shape, seed=7 + sum(shape) + causal)
    want = _jax_grads(lambda *a: local_attention(*a, causal=causal), q, k, v, g)
    got, _ = _port_grads(q, k, v, g, causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("block_k", [8, 48, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_reference_matches_blockwise_bwd(causal, block_k):
    """``flash_backward_reference`` on the same (q, k, v, O, LSE, dO) as the
    reference's ``_blockwise_bwd``, at tiles that split T = 100 raggedly."""
    q, k, v, do = _arrays((2, 100, 2, 16), seed=block_k + causal)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = _flash_forward(jq, jk, jv, causal, 128, 128, True)
    want = _blockwise_bwd(jq, jk, jv, o, lse, jdo, causal, block_k)
    got = tflash.flash_backward_reference(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, do)), causal, block_k
    )
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5, err_msg=f"d{name}")


def test_masked_pairs_never_reach_the_exp():
    """A masked (query, key) pair whose score would overflow exp() leaves
    the gradient finite and equal to the oracle's: masked pairs take the
    -1e30 sentinel before the exp."""
    q, k, v, g = _arrays((1, 16, 1, 8), seed=3)
    q[0, 0, 0] = k[0, 5, 0] = 300.0  # key 5 lies above row 0's causal diagonal
    got, _ = _port_grads(q, k, v, g, True)
    want = _jax_grads(lambda *a: local_attention(*a, causal=True), q, k, v, g)
    for name, a, b in zip("qkv", got, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3, err_msg=f"d{name}")


@pytest.mark.parametrize("block_k", [16, 64, 128])
def test_block_k_moves_only_the_summation_order(block_k):
    q, k, v, g = _arrays((1, 150, 2, 32), seed=5)
    ref, _ = _port_grads(q, k, v, g, True)
    got, _ = _port_grads(q, k, v, g, True, block_k=block_k)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_autograd_calls_the_plain_backward_on_the_saved_forward():
    q, k, v, g = _arrays((2, 40, 2, 16), seed=11)
    got, _ = _port_grads(q, k, v, g, True)
    tq, tk, tv, tg = map(torch.from_numpy, (q, k, v, g))
    o, lse = tflash.flash_attention_reference(tq, tk, tv, True)
    want = tflash.flash_backward(tq, tk, tv, o, lse, tg, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


def test_lse_output_carries_no_gradient():
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _arrays((1, 20, 2, 8), 1, 3))
    o, lse = tflash.flash_attention_with_lse(q, k, v, causal=True)
    assert o.requires_grad and not lse.requires_grad


def test_gradient_flows_to_the_inputs_that_ask_for_it():
    q, k, v = (torch.from_numpy(x) for x in _arrays((1, 20, 2, 8), 2, 3))
    k.requires_grad_(True)
    tflash.flash_attention(q, k, v, causal=True).sum().backward()
    assert k.grad is not None and k.grad.shape == k.shape
    assert q.grad is None and v.grad is None


def test_plain_backward_counts_no_launch():
    q, k, v, g = _arrays((1, 32, 2, 16), seed=4)
    tflash.reset_launches()
    _port_grads(q, k, v, g, True)
    assert tflash.LAUNCHES == 0 and tflash.LAUNCHES_BY == {"sm90": 0, "tf32x3": 0, "bwd": 0, "bwd_sm90": 0}


# --- the kernel's contract, checked before anything is built or launched ---


def _cpu_operands(dtype=torch.float32, d=16, t=16):
    q = torch.zeros((1, t, 2, d), dtype=dtype)
    lse = torch.zeros((1, 2, t), dtype=torch.float32)
    return q, q.clone(), q.clone(), q.clone(), lse, q.clone()


def test_launch_backward_refuses_a_cpu_tensor():
    """The kernel's launcher never takes the plain path: a tensor that is
    not on the card raises instead."""
    before = dict(tflash.LAUNCHES_BY)
    with pytest.raises(ValueError, match="cuda"):
        tflash.launch_backward(*_cpu_operands(), causal=True)
    assert tflash.LAUNCHES_BY == before


def test_flash_backward_refuses_other_devices():
    q, k, v, o, lse, do = (x.to("meta") for x in _cpu_operands())
    with pytest.raises(ValueError, match="cpu or cuda"):
        tflash.flash_backward(q, k, v, o, lse, do)


@pytest.mark.parametrize(
    "dtype,d,error",
    [
        (torch.float16, 16, TypeError),  # not built
        (torch.float32, 24, ValueError),  # no head dim 24
        (torch.bfloat16, 256, ValueError),
    ],
)
def test_backward_kernel_refuses_what_it_does_not_take(dtype, d, error):
    """A wrong dtype or head dim raises before anything is built or
    launched, so it shows here too."""
    before = dict(tflash.LAUNCHES_BY)
    with pytest.raises(error):
        tflash.launch_backward(*_cpu_operands(dtype, d), causal=False)
    assert tflash.LAUNCHES_BY == before


def test_backward_kernel_refuses_a_wrong_lse():
    q, k, v, o, lse, do = _cpu_operands()
    with pytest.raises(ValueError, match="lse"):
        tflash.launch_backward(q, k, v, o, lse.transpose(1, 2).contiguous().transpose(1, 2), do, False)
    with pytest.raises(ValueError, match="lse"):
        tflash.launch_backward(q, k, v, o, lse.double(), do, False)


# --- the tensor-core backward (bwd_sm90): its limit and its routing ---

_LOG2E = 1.4426950408889634
# chip_smoke.BWD_TOL[bf16] as (rtol, atol), and the worst case of rounding
# P and dS to bfloat16 before the dV, dK and dQ products
_BWD_TOL_BF16 = (2**-6, 1e-5)
_ROUNDING = 2**-8


def _sm90_bwd_emulation(q, k, v, o, lse, do, causal, block=64):
    """The bwd_sm90 kernel's arithmetic in plain torch: 64-key tiles, S and
    dP float32 from the bf16 operands, P = exp2(s·scale·log2 e − LSE·log2 e)
    and dS = P (dP − δ) in float32, both rounded to bfloat16 before the dV,
    dK and dQ products (float32 sums), dQ summed tile by tile and scaled at
    the end → (dQ, dK, dV) in bfloat16."""
    t, d = q.shape[1], q.shape[3]
    scale = 1.0 / d**0.5
    qf, kf, vf, of, dof = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, o, do))
    delta = (dof * of).sum(-1)
    lse2 = torch.where(lse > -5e29, lse * _LOG2E, torch.full_like(lse, float("inf")))
    rows = torch.arange(t)[:, None]
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(qf), torch.empty_like(qf)
    for k0 in range(0, t, block):
        k_j, v_j = kf[:, :, k0 : k0 + block], vf[:, :, k0 : k0 + block]
        p = torch.exp2((qf @ k_j.transpose(-1, -2)) * (scale * _LOG2E) - lse2[..., None])
        if causal:
            p = p.masked_fill(torch.arange(k0, k0 + k_j.shape[2])[None, :] > rows, 0.0)
        ds = p * (dof @ v_j.transpose(-1, -2) - delta[..., None])
        p, ds = p.bfloat16().float(), ds.bfloat16().float()
        dv[:, :, k0 : k0 + block] = p.transpose(-1, -2) @ dof
        dk[:, :, k0 : k0 + block] = scale * (ds.transpose(-1, -2) @ qf)
        dq += ds @ k_j
    return tuple(x.permute(0, 2, 1, 3).bfloat16() for x in (scale * dq, dk, dv))


def _bf16_backward_case(shape, causal, seed):
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in _arrays(shape, seed))
    o, lse = tflash.flash_attention_reference(q, k, v, causal)
    return q, k, v, o, lse, do


def _limit_shares(got, want, terms):
    """Per gradient: (worst share of BWD_TOL[bf16] + 2⁻⁸·term, worst share
    of BWD_TOL[bf16] alone); a share <= 1 passes."""
    rtol, atol = _BWD_TOL_BF16
    out = []
    for g, w, term in zip(got, want, terms):
        diff = (g.float() - w.float()).abs()
        base = rtol * w.float().abs() + atol * w.float().abs().max()
        out.append(((diff / (base + _ROUNDING * term)).max().item(), (diff / base).max().item()))
    return out


@pytest.mark.parametrize("causal", [False, True])
def test_rounding_p_and_ds_stays_inside_the_bwd_sm90_limit(causal):
    """The emulated kernel against the plain version on the same (O, LSE,
    dO): inside BWD_TOL[bf16] + 2⁻⁸·bwd_rounding_terms for dQ, dK and dV."""
    case = _bf16_backward_case((1, 1024, 2, 64), causal, seed=31 + causal)
    want = tflash.flash_backward_reference(*case, causal)
    terms = tflash.bwd_rounding_terms(*case, causal)
    got = _sm90_bwd_emulation(*case, causal)
    for name, (share, _) in zip(("dq", "dk", "dv"), _limit_shares(got, want, terms)):
        assert share <= 1.0, (name, share)


@pytest.mark.parametrize("causal", [False, True])
def test_rounding_p_and_ds_breaks_bwd_tol_alone(causal):
    """The term is needed and not slack: the same emulation leaves the plain
    bf16 limit for every gradient."""
    case = _bf16_backward_case((1, 1024, 2, 64), causal, seed=31 + causal)
    want = tflash.flash_backward_reference(*case, causal)
    terms = tflash.bwd_rounding_terms(*case, causal)
    got = _sm90_bwd_emulation(*case, causal)
    for name, (_, share_alone) in zip(("dq", "dk", "dv"), _limit_shares(got, want, terms)):
        assert share_alone > 1.0, (name, share_alone)


@pytest.mark.parametrize("block_k", [16, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_rounding_terms_match_the_whole_score_matrix(causal, block_k):
    """``bwd_rounding_terms`` against its [T, T] formula: P = softmax of
    the scaled scores, dS = P ⊙ (dO·Vᵀ − δ), then scale·|dS|·|K|,
    scale·|dS|ᵀ·|Q| and Pᵀ·|dO|."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays((2, 50, 2, 16), seed=12 + causal))
    o, lse = tflash.flash_attention_reference(q, k, v, causal)
    got = tflash.bwd_rounding_terms(q, k, v, o, lse, do, causal, block_k)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    if causal:
        s = s.masked_fill(~torch.ones(50, 50, dtype=torch.bool).tril(), float("-inf"))
    p = torch.softmax(s, -1)
    delta = torch.einsum("bqhd,bqhd->bhq", do, o)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta[..., None])
    want = (
        torch.einsum("bhqk,bkhd->bqhd", ds.abs(), k.abs()) / 4.0,
        torch.einsum("bhqk,bqhd->bkhd", ds.abs(), q.abs()) / 4.0,
        torch.einsum("bhqk,bqhd->bkhd", p, do.abs()),
    )
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and (a >= 0).all()
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=name)


@pytest.mark.parametrize("d", tflash.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_is_chosen_by_dtype_and_head_dim(dtype, d):
    """bf16 at the sm90 forward's head dims takes the tensor-core backward;
    float32 everywhere and bf16 at D = 8 stay on flash_bwd.cu."""
    want = "bwd_sm90" if dtype == torch.bfloat16 and d != 8 else "bwd"
    assert tflash.bwd_kernel_for(dtype, d) == want
    assert (want == "bwd_sm90") == (tflash.kernel_for(dtype, d) == "sm90")


@pytest.mark.parametrize("operand", [0, 3, 5], ids=["q", "o", "do"])
@pytest.mark.parametrize(
    "make",
    [
        lambda: torch.zeros((1, 16, 2, 68), dtype=torch.bfloat16)[..., :64],  # 136-byte H stride
        lambda: torch.zeros(1 + 16 * 2 * 64, dtype=torch.bfloat16)[1:].view(1, 16, 2, 64),  # address
    ],
    ids=["stride", "address"],
)
def test_bwd_sm90_refuses_unaligned_tma_inputs_before_launching(make, operand):
    """Checked before anything is built or launched, so it runs here too;
    the error names the kernel."""
    args = list(_cpu_operands(torch.bfloat16, 64))
    args[operand] = make()
    before = dict(tflash.LAUNCHES_BY)
    with pytest.raises(ValueError, match="bwd_sm90 kernel's TMA loads need a 16-byte"):
        tflash.launch_backward(*args, causal=True)
    assert tflash.LAUNCHES_BY == before


@pytest.mark.parametrize(
    "dtype,d,kernel,error",
    [
        (torch.float32, 64, "bwd_sm90", TypeError),  # bf16 only
        (torch.bfloat16, 8, "bwd_sm90", ValueError),  # no D = 8 build
        (torch.bfloat16, 64, "sm90", ValueError),  # a forward kernel
    ],
)
def test_a_named_backward_kernel_refuses_what_it_does_not_take(dtype, d, kernel, error):
    q, k, v, o, lse, do = _cpu_operands(dtype, d)
    before = dict(tflash.LAUNCHES_BY)
    with pytest.raises(error):
        tflash.launch_backward(q, k, v, o, lse, do, causal=True, kernel=kernel)
    assert tflash.LAUNCHES_BY == before


def test_flash_bwd_still_takes_every_bf16_head_dim_for_a_comparison():
    """``kernel="bwd"`` passes the checks at a bf16 head dim that routes to
    bwd_sm90, and stops only at the device check."""
    with pytest.raises(ValueError, match="cuda"):
        tflash.launch_backward(*_cpu_operands(torch.bfloat16, 64), causal=True, kernel="bwd")


def test_rounding_p_and_ds_leaves_the_encoder_gradient_gap(monkeypatch):
    """The bf16 encoder-gradient leg at its full width, T = 1024, on the CPU
    with both tensor-core kernels emulated (the sm90 forward, then this
    backward or the plain one): rounding P and dS moves the wq/wk gradient
    gap to local_attention by under 0.01, far inside
    ``chip_smoke.ENCODER_GRAD_QK_TOL``; the gap is δ's reading of the bf16
    O, which both backwards share."""
    import chip_smoke
    from test_torch_flash import _tensor_core_emulation

    torch.set_num_threads(2)
    try:
        monkeypatch.setattr(tflash, "flash_attention_reference", _tensor_core_emulation)
        legs = {}
        for name, backward in (
            ("plain", tflash.flash_backward_reference),
            ("bwd_sm90", lambda q, k, v, o, lse, do, causal, block_k: _sm90_bwd_emulation(
                q, k, v, o, lse, do, causal)),
        ):
            monkeypatch.setattr(tflash, "flash_backward_reference", backward)
            legs[name] = chip_smoke.encoder_grad_leg("cpu", seq=1024, dtype=torch.bfloat16)
    finally:
        torch.set_num_threads(1)
    gap, gap_plain = legs["bwd_sm90"]["grad_rel_err_qk"], legs["plain"]["grad_rel_err_qk"]
    assert abs(gap - gap_plain) < 0.01, (gap, gap_plain)
    assert gap < chip_smoke.ENCODER_GRAD_QK_TOL[torch.bfloat16]
    assert legs["bwd_sm90"]["grad_rel_err"] < chip_smoke.ENCODER_GRAD_TOL[torch.bfloat16]
