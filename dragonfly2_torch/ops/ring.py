"""Ring collectives and ring attention over a sequence-parallel process
group (counterpart of the reference's ``ops/ring.py``), and the
single-device reference attention.

The reference rotates shards around an ICI ring with ``lax.ppermute``
inside ``shard_map``; here each rank holds its shard and the rotation is
``RingShift``, a differentiable point-to-point shift over
``torch.distributed`` (send to the next rank, receive from the previous
one; its gradient is the shift the other way, the transpose of a
permutation). The sequence is the concatenation of the ranks' shards in
group-rank order. ``make_*`` return functions of a rank's local shards and
take the place of ``shard_map``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _shift(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """x sent ``offset`` ranks ahead around the group's ring; returns what
    arrived from ``offset`` ranks behind."""
    n, me = _group_size_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, (me + offset) % n), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (me - offset) % n), group),
    ]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _group_size_rank(group) -> "tuple[int, int]":
    return dist.get_world_size(group), dist.get_rank(group)


class RingShift(torch.autograd.Function):
    """``lax.ppermute`` over the ring ``(j, j + 1)``: every rank sends its
    tensor to the next and receives the previous one's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def ring_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather along the ring: per-rank [S, ...] → [n·S, ...], shard j
    at rows [j·S, (j + 1)·S), as n - 1 shifts of one shard each."""
    n, me = _group_size_rank(group)
    parts = [None] * n
    parts[me] = shard = x
    for step in range(1, n):
        shard = RingShift.apply(shard, group)
        parts[(me - step) % n] = shard
    return torch.cat(parts, dim=0)


def ring_gather_rows(table_shard: torch.Tensor, indices: torch.Tensor, group) -> torch.Tensor:
    """Rows of a row-sharded table by global index, over the ring.
    ``table_shard`` [S, F] holds rows [me·S, (me + 1)·S) of a global
    [n·S, F] table; ``indices`` (any int shape) are global row ids. The
    shards rotate, and each rank keeps the rows whose id falls in the
    visiting shard, so no rank holds more than one shard at a time."""
    n, me = _group_size_rank(group)
    s = table_shard.shape[0]
    out = torch.zeros(indices.shape + table_shard.shape[1:], dtype=table_shard.dtype,
                      device=table_shard.device)
    shard = table_shard
    for step in range(n):
        src = (me - step) % n  # owner of the visiting shard
        local = indices - src * s
        hit = (local >= 0) & (local < s)
        rows = shard[local.clamp(0, s - 1)]
        out = torch.where(hit.reshape(hit.shape + (1,) * (rows.dim() - hit.dim())), rows, out)
        if step != n - 1:
            shard = RingShift.apply(shard, group)
    return out


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    causal: bool = False,
    scale: "float | None" = None,
) -> torch.Tensor:
    """Blockwise ring attention over a sequence-sharded group. Per-rank
    shards q [B, Tq, H, D] and k/v [B, Tk, H, D] → [B, Tq, H, D] in q's
    dtype. K/V blocks rotate around the ring while an online softmax
    accumulates in float32, so [T, T] never exists and each rank holds
    O(T/n). Products take the inputs upcast (a bfloat16 product is exact in
    float32). The running max only shifts the exponent, so it carries no
    gradient."""
    n, me = _group_size_rank(group)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if causal and tq != tk:
        # the mask compares me·tq + i with src·tk + j: with unequal shards
        # those are different coordinate systems, so equal shards are the
        # ring's contract
        raise ValueError(
            f"causal ring attention needs equal q/k shard lengths, got {tq} vs {tk}"
        )
    if scale is None:
        scale = 1.0 / d**0.5
    q_pos = me * tq + torch.arange(tq, device=q.device)
    qf = q.float()
    m = torch.full((b, h, tq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, tq), device=q.device)
    o = torch.zeros((b, h, tq, d), device=q.device)
    kb, vb = k, v
    for step in range(n):
        src = (me - step) % n  # ring owner of the visiting block
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        if causal:
            k_pos = src * tk + torch.arange(tk, device=q.device)
            s = s.masked_fill(q_pos[:, None] < k_pos[None, :], float("-inf"))
        m_new = torch.maximum(m, s.detach().amax(dim=-1))
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)  # fully masked rows
        p = torch.where(torch.isfinite(s), torch.exp(s - safe_m[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb.float())
        m = m_new
        if step != n - 1:
            kb = RingShift.apply(kb, group)
            vb = RingShift.apply(vb, group)
    o = o / l.clamp_min(1e-30)[..., None]
    return o.permute(0, 2, 1, 3).to(q.dtype)


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


def make_ring_attention(mesh, axis_name: str, causal: bool = False):
    """Ring attention over ``mesh[axis_name]`` as a function of this rank's
    shards q, k, v [B, T/n, H, D] → [B, T/n, H, D]."""
    group = mesh.get_group(axis_name)

    def ring(q, k, v):
        return ring_attention(q, k, v, group, causal=causal)

    return ring
