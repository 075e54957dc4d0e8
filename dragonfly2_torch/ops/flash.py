"""Fused attention: two hand-written CUDA forward kernels (counterparts of
the Pallas kernel ``_flash_forward`` in the reference's ``ops/flash.py``),
one hand-written CUDA backward kernel (counterpart of its VJP
``_blockwise_bwd``), and the plain PyTorch version of each.

``flash_attention`` / ``flash_attention_with_lse`` take [B, T, H, D] q, k, v
and return O [B, T, H, D] in the input dtype (and LSE [B, H, T] float32).
A CPU tensor goes to the plain version; a CUDA tensor launches a kernel or
raises — there is no fallback between them. The kernel is chosen by dtype
and head dim alone (``kernel_for``):

- ``"sm90"`` (``csrc/flash_fwd_sm90.cu``): bfloat16 with D in 16, 32, 64,
  128 — wgmma tensor-core products fed by TMA. It rounds the softmax
  weights P to bfloat16 before P·V, as every tensor-core flash kernel does;
  ``p_rounding_term`` gives the worst case of that rounding.
- ``"tf32x3"`` (``csrc/flash_fwd_tf32x3.cu``): float32 at every D in
  ``HEAD_DIMS`` and bfloat16 at D = 8 — the same tensor-core design with
  every product in 3xTF32: x = hi + lo with both parts TF32
  (``tf32_split``) and a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, which keeps
  the float32 limits. A pre-pass in the same launch writes the hi/lo
  planes of Q, K and Vᵀ to scratch that the wrapper allocates
  (``tf32x3_prepass_reference`` is its plain version); bfloat16 needs no
  lo part, and P is split in registers.

Differentiable: ``flash_attention`` is a ``torch.autograd.Function``
(the reference's ``jax.custom_vjp``) that saves (q, k, v, O, LSE) and whose
backward is ``flash_backward``. That rebuilds P from the saved LSE tile by
tile and never materializes [T, T], so training keeps the O(T·block) memory
of the forward. A CUDA tensor launches ``csrc/flash_bwd.cu`` (counted under
``"bwd"``) or raises; a CPU tensor takes ``flash_backward_reference``.
Gradients come back in the input dtype, computed in float32.
"""

from __future__ import annotations

import ctypes

import torch

from dragonfly2_torch import _build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30  # large-negative sentinel: exp() underflows to exact 0

HEAD_DIMS = (8, 16, 32, 64, 128)
SM90_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535  # both kernels' grid is (query tiles, B·H)
_TMA_ALIGN = 16  # bytes: TMA wants base addresses and strides on this
_TF32_MASK = -0x2000  # int32 view of 0xFFFFE000: sign, exponent, 10 mantissa bits
# Vᵀ position c of each group of 8 keys holds key VT_KEY_ORDER[c]: the
# score accumulator gives a thread keys (2t, 2t+1) of every 8, and the
# tf32 A fragment of P·V reads them as positions (t, t + 4)
VT_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)

# kernel launches since the counters were last reset, in total and by
# kernel; the plain version never touches them
LAUNCHES = 0
LAUNCHES_BY = {"sm90": 0, "tf32x3": 0, "bwd": 0}

_LIBRARY = {"sm90": "flash_fwd_sm90", "tf32x3": "flash_fwd_tf32x3"}
_BWD_LIBRARY = "flash_bwd"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry → its argument types: pointers, then ints, then the 9 strides and the stream
_ARGTYPES = {
    "df_flash_fwd_sm90": [_P] * 5 + [_I] * 5 + [_L] * 9 + [_P],
    "df_flash_fwd_tf32x3": [_P] * 8 + [_I] * 6 + [_L] * 9 + [_P],
    "df_tf32x3_split": [_P] * 6 + [_I] * 5 + [_L] * 9 + [_P],
    "df_flash_bwd": [_P] * 10 + [_I] * 6 + [_L] * 15 + [_P],
}
_fns: dict = {}


def reset_launches() -> None:
    """Set every launch count to 0."""
    global LAUNCHES
    LAUNCHES = 0
    for name in LAUNCHES_BY:
        LAUNCHES_BY[name] = 0


def kernel_for(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches."""
    return "sm90" if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS else "tf32x3"


def _entry(library: str, symbol: str):
    """The C function ``symbol`` of library ``library``, built if needed."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(_build.load(library), symbol)
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one [B, T, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise TypeError(
            f"q, k, v must all be float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def _softmax_parts(q, k, v, causal):
    """float32 (p = exp(s - m) [B, H, T, T], m, l = Σp, v [B, H, T, D]) on
    the whole score matrix, masked with the -1e30 sentinel."""
    t, d = q.shape[1], q.shape[3]
    qf = q.float().permute(0, 2, 1, 3) * (1.0 / d**0.5)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    s = qf @ kf.transpose(-1, -2)  # [B, H, T, T]
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return p, m, p.sum(dim=-1), vf


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Plain PyTorch version of the kernels: the same float32 arithmetic on
    the whole [T, T] score matrix, the same -1e30 masking, ``max(l, 1e-30)``
    and LSE sentinel → (O [B, T, H, D] in q's dtype, LSE [B, H, T] f32)."""
    p, m, l, vf = _softmax_parts(q, k, v, causal)
    denom = l.clamp_min(1e-30)
    o = (p @ vf) / denom[..., None]
    lse = torch.where(l > 0, m + torch.log(denom), torch.full_like(m, NEG_INF))
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


def p_rounding_term(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """(P·|V|)/l [B, T, H, D] float32, from the same float32 P as the plain
    version. Rounding each weight p to bfloat16 moves it by at most 2⁻⁸·p,
    so a kernel that rounds P before P·V moves O by at most 2⁻⁸ times this."""
    p, _, l, vf = _softmax_parts(q, k, v, causal)
    return ((p @ vf.abs()) / l.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (11 significant bits) to nearest, ties away
    from zero, the 13 low bits cleared: ``cvt.rna.tf32.f32`` on its int32
    view (adding half an ulp to the magnitude carries into the exponent
    where it must)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & _TF32_MASK).view(torch.float32)


def tf32_split(x: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor]":
    """float32 x → (hi, lo), both TF32: hi = round(x), lo = round(x − hi).
    x − hi is exact, so hi + lo is x to 2⁻²³·|x|, and exactly x when x has
    at most 22 significant bits."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3_prepass_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Plain version of the tf32x3 kernel's pre-pass → float32 (qs, ks
    [P, B·H, T, D], vt [P, B·H, D, T8]): P = 2 planes (hi, lo) for float32
    and 1 (the exact upcast) for bfloat16; T8 is T rounded up to 8, Vᵀ holds
    the keys of each group of 8 in ``VT_KEY_ORDER`` and zeros past T."""
    b, t, h, d = q.shape
    t8 = -(-t // 8) * 8

    def heads_major(x):
        return x.float().permute(0, 2, 1, 3).reshape(b * h, t, d)

    order = torch.arange(0, t8, 8, device=q.device)[:, None] + torch.tensor(
        VT_KEY_ORDER, device=q.device
    )
    vf = torch.nn.functional.pad(heads_major(v), (0, 0, 0, t8 - t))
    vt = vf[:, order.reshape(-1)].transpose(1, 2)

    def planes(x):
        return torch.stack(tf32_split(x)) if q.dtype == torch.float32 else x[None]

    return planes(heads_major(q)), planes(heads_major(k)), planes(vt)


def _prepass_buffers(q: torch.Tensor):
    """Uninitialised float32 scratch of the tf32x3 pre-pass → (qs, ks, vt)."""
    b, t, h, d = q.shape
    n = 2 if q.dtype == torch.float32 else 1
    t8 = -(-t // 8) * 8
    qk = [torch.empty((n, b * h, t, d), dtype=torch.float32, device=q.device) for _ in range(2)]
    return (*qk, torch.empty((n, b * h, d, t8), dtype=torch.float32, device=q.device))


def tf32x3_prepass(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """The tf32x3 kernel's pre-pass alone on CUDA q, k, v (the forward runs
    it inside its own launch) → (qs, ks, vt) as
    ``tf32x3_prepass_reference`` lays them out. For checking it against
    that plain version; it counts no launch."""
    if q.device.type != "cuda":
        raise ValueError(f"the pre-pass kernel runs on cuda tensors, not {q.device}")
    _check(q, k, v)
    _check_layout(q, k, v)
    b, t, h, d = q.shape
    bufs = _prepass_buffers(q)
    err = _entry("flash_fwd_tf32x3", "df_tf32x3_split")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *(x.data_ptr() for x in bufs),
        b, t, h, d, _DTYPE_CODE[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"df_tf32x3_split launch failed: error {err}")
    return bufs


def _tma_strides(x: torch.Tensor) -> "tuple[int, int, int]":
    """x's (B, T, H) strides for a tensor map; a dimension of size 1 is never
    stepped over, so it gets its contiguous stride instead of whatever the
    view carries."""
    b, t, h, d = x.shape
    return tuple(
        st if n > 1 else dense
        for st, n, dense in ((x.stride(0), b, t * h * d), (x.stride(1), t, h * d), (x.stride(2), h, d))
    )


def _check_layout(q, k, v) -> None:
    """What every kernel's grid and loads need of [B, T, H, D] q, k, v."""
    b, _, h, _ = q.shape
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B·H = {b * h} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous (stride 1)")


def launch_kernel(q, k, v, causal, kernel: "str | None" = None):
    """Launch a kernel on CUDA q, k, v → (O, LSE). ``kernel`` defaults to
    ``kernel_for(dtype, D)``; naming one picks it for a comparison."""
    global LAUNCHES
    b, t, h, d = q.shape
    kernel = kernel or kernel_for(q.dtype, d)
    allowed = {
        ("sm90", torch.bfloat16): SM90_HEAD_DIMS,
        ("tf32x3", torch.float32): HEAD_DIMS,
        ("tf32x3", torch.bfloat16): (8,),
    }.get((kernel, q.dtype))
    if allowed is None:
        raise TypeError(f"the {kernel} kernel does not take {q.dtype}")
    if d not in allowed:
        raise ValueError(
            f"head dim {d} not built; the {kernel} kernel takes {allowed} in {q.dtype}"
        )
    _check_layout(q, k, v)
    strides = [_tma_strides(x) if kernel == "sm90" else x.stride()[:3] for x in (q, k, v)]
    if kernel == "sm90":
        size = q.element_size()
        for name, x, st in zip("qkv", (q, k, v), strides):
            if x.data_ptr() % _TMA_ALIGN or any(s * size % _TMA_ALIGN for s in st):
                raise ValueError(
                    f"{name}: the sm90 kernel's TMA loads need a {_TMA_ALIGN}-byte aligned base"
                    f" address and B/T/H strides, got address {x.data_ptr():#x} and strides"
                    f" {st} of {size}-byte elements"
                )
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b * h == 0:
        return o, lse
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr()]
    if kernel == "tf32x3":
        # the pre-pass's scratch; the caching allocator hands it out again
        # only to work queued behind this launch on the stream
        scratch = _prepass_buffers(q)
        head += [x.data_ptr() for x in scratch] + [b, t, h, d, _DTYPE_CODE[q.dtype]]
    else:
        head += [b, t, h, d]
    err = _entry(_LIBRARY[kernel], f"df_{_LIBRARY[kernel]}")(
        *head,
        int(bool(causal)),
        *strides[0], *strides[1], *strides[2],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{_LIBRARY[kernel]} launch failed: error {err}")
    LAUNCHES += 1
    LAUNCHES_BY[kernel] += 1
    return o, lse


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def flash_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = False,
    block_k: int = DEFAULT_BLOCK_K,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """Plain PyTorch version of the backward kernel, the reference's
    ``_blockwise_bwd`` in torch ops: a loop over key tiles of ``block_k``
    in float32, P rebuilt per tile from the saved LSE and never [T, T]
    → (dQ, dK, dV) [B, T, H, D] in the input dtype.

    With δ = rowsum(dO ⊙ O), per tile j: P = exp(s·scale − LSE) (masked
    pairs take the -1e30 sentinel before the exp, so an empty row's LSE
    sentinel cannot overflow), dV_j = Pᵀ·dO, dP = dO·V_jᵀ,
    dS = P ⊙ (dP − δ), dQ += scale·dS·K_j, dK_j = scale·dSᵀ·Q."""
    b, t, h, d = q.shape
    scale = 1.0 / d**0.5

    def heads_major(x):
        return x.permute(0, 2, 1, 3).float()

    qf, kf, vf, of, dof = map(heads_major, (q, k, v, o, do))
    bk = min(block_k, _ceil_to(t, 8))
    delta = (dof * of).sum(-1)  # [B, H, T]
    q_pos = torch.arange(t, device=q.device)
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for k0 in range(0, t, bk):
        k_j, v_j = kf[:, :, k0 : k0 + bk], vf[:, :, k0 : k0 + bk]
        k_pos = torch.arange(k0, k0 + k_j.shape[2], device=q.device)
        arg = scale * (qf @ k_j.transpose(-1, -2)) - lse[..., None]  # [B, H, T, bk]
        if causal:
            arg = arg.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
        p = torch.exp(arg)
        dv[:, :, k0 : k0 + bk] = p.transpose(-1, -2) @ dof
        dp = dof @ v_j.transpose(-1, -2)
        ds = p * (dp - delta[..., None])
        dq += scale * (ds @ k_j)
        dk[:, :, k0 : k0 + bk] = scale * (ds.transpose(-1, -2) @ qf)

    def back(x, like):
        return x.permute(0, 2, 1, 3).to(like.dtype)

    return back(dq, q), back(dk, k), back(dv, v)


def launch_backward(q, k, v, o, lse, do, causal):
    """Launch the backward kernel on CUDA tensors → (dQ, dK, dV) in q's
    dtype. q, k, v, O and dO are read through their B/T/H strides (the head
    dimension contiguous); LSE is a contiguous [B, H, T] float32 tensor."""
    global LAUNCHES
    b, t, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the backward kernel takes float32 or bfloat16, not {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the backward kernel takes {HEAD_DIMS}")
    _check_layout(q, k, v)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q's shape, dtype and device")
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous (stride 1)")
    if lse.shape != (b, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous [B, H, T] float32 tensor, got {tuple(lse.shape)}")
    if q.device.type != "cuda" or lse.device != q.device:
        raise ValueError(f"the backward kernel runs on cuda tensors, not {q.device}")
    dq, dk, dv = (torch.empty((b, t, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    if t == 0 or b * h == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = _entry(_BWD_LIBRARY, "df_flash_bwd")(
        *(x.data_ptr() for x in (q, k, v, o, do, lse, delta, dq, dk, dv)),
        b, t, h, d, _DTYPE_CODE[q.dtype], int(bool(causal)),
        *(st for x in (q, k, v, o, do) for st in x.stride()[:3]),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{_BWD_LIBRARY} launch failed: error {err}")
    LAUNCHES += 1
    LAUNCHES_BY["bwd"] += 1
    return dq, dk, dv


def flash_backward(q, k, v, o, lse, do, causal=False, block_k=DEFAULT_BLOCK_K):
    """(q, k, v, O, LSE) of a forward and the cotangent dO → (dQ, dK, dV)
    [B, T, H, D] in q's dtype. A CPU tensor goes to the plain version; a
    CUDA tensor launches the kernel or raises. ``block_k`` is the plain
    version's tile; the kernel's tiles are fixed at build time."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, o, lse, do, causal, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    return launch_backward(q, k, v, o, lse, do, causal)


class _Flash(torch.autograd.Function):
    """The forward kernels with ``flash_backward`` as their gradient (the
    reference's ``_flash``/``_flash_fwd``/``_flash_bwd``). LSE is an output
    without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_k):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, causal)
        elif q.device.type == "cuda":
            o, lse = launch_kernel(q, k, v, causal)
        else:
            raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.block_k = causal, block_k
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.causal, ctx.block_k)
        return dq, dk, dv, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """[B, T, H, D] q/k/v → (O [B, T, H, D], LSE [B, H, T] float32);
    differentiable in q, k and v. ``block_q`` is a scheduling hint kept for
    the reference's signature and ``block_k`` the plain backward's key
    tile; the kernels' tiles are fixed at build time."""
    del block_q
    _check(q, k, v)
    return _Flash.apply(q, k, v, causal, block_k)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> torch.Tensor:
    """[B, T, H, D] q/k/v → [B, T, H, D]; same contract as
    ``ops.ring.local_attention``."""
    return flash_attention_with_lse(q, k, v, causal, block_q, block_k)[0]
