"""Single-device reference attention (counterpart of ``local_attention`` in
the reference's ``ops/ring.py``; the ring collectives come with the
multi-device slice)."""

from __future__ import annotations

import torch


def local_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """[B, Tq, H, D] q and [B, Tk, H, D] k/v → [B, Tq, H, D] in q's dtype.
    Scores and the softmax are float32 (inputs upcast, so a bfloat16
    product is exact and sums are float32); masked scores are -inf."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (d**0.5)
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return o.permute(0, 2, 1, 3).to(q.dtype)
