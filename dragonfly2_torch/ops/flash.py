"""Fused attention forward: the hand-written CUDA kernel
``csrc/flash_fwd.cu`` (counterpart of the Pallas kernel ``_flash_forward``
in the reference's ``ops/flash.py``) and its plain PyTorch version.

``flash_attention`` / ``flash_attention_with_lse`` take [B, T, H, D] q, k, v
and return O [B, T, H, D] in the input dtype (and LSE [B, H, T] float32).
A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises — there is no fallback between the two. Forward only: the
backward comes with the training slice, so a call that would need a
gradient raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch

from dragonfly2_torch import _build

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30  # large-negative sentinel: exp() underflows to exact 0

HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535  # the kernel's grid is (query tiles, B·H)

# kernel launches since the counter was last reset; the plain version
# never touches it
LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_fwd").df_flash_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 9
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash attention is forward-only in this port; run it under"
            " torch.no_grad() or with inputs that do not require grad"
        )


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Plain PyTorch version of the kernel: the same float32 arithmetic on
    the whole [T, T] score matrix, the same -1e30 masking, ``max(l, 1e-30)``
    and LSE sentinel → (O [B, T, H, D] in q's dtype, LSE [B, H, T] f32)."""
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
    l = p.sum(dim=-1)
    denom = l.clamp_min(1e-30)
    o = (p @ vf) / denom[..., None]
    lse = torch.where(l > 0, m + torch.log(denom), torch.full_like(m, NEG_INF))
    return o.permute(0, 2, 1, 3).to(q.dtype), lse


def _launch(q, k, v, causal):
    global LAUNCHES
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes {HEAD_DIMS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B·H = {b * h} exceeds the kernel's grid limit {_MAX_GRID_Y}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous (stride 1)")
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b * h == 0:
        return o, lse
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, h, d, _DTYPE_CODE[q.dtype], int(bool(causal)),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return o, lse


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """[B, T, H, D] q/k/v → (O [B, T, H, D], LSE [B, H, T] float32).
    ``block_q``/``block_k`` are scheduling hints kept for the reference's
    signature; the kernel's tiles are fixed at build time."""
    del block_q, block_k
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not {q.device}")
    return _launch(q, k, v, causal)


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
