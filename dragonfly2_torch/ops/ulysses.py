"""All-to-all (Ulysses) sequence parallelism over a process group
(counterpart of the reference's ``ops/ulysses.py``).

Beside the ring (``ops.ring``): two all-to-alls reshard the activations from
sequence-sharded to head-sharded, every rank runs exact attention over the
whole sequence for its subset of heads, and one all-to-all reshards back.
Heads must divide by the group size. With ``use_kernel`` the per-rank
attention is ``ops.flash.flash_attention``, so on the card the flash
forward and backward kernels are Ulysses' per-device compute; gradients flow
back through the transposed all-to-alls.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dragonfly2_torch.ops.flash import flash_attention
from dragonfly2_torch.ops.ring import local_attention


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of x's leading dimension goes to rank j; chunk j of the
    result came from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class AllToAll(torch.autograd.Function):
    """``_all_to_all`` with its gradient: in this chunk layout the
    all-to-all is its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """[B, T/n, H, D] → [B, T, H/n, D]: head group j goes to rank j, and the
    sequence shards come back in rank order."""
    n = dist.get_world_size(group)
    b, tl, h, d = x.shape
    chunks = x.reshape(b, tl, n, h // n, d).permute(2, 0, 1, 3, 4)  # [n, B, T/n, H/n, D]
    y = AllToAll.apply(chunks, group)
    return y.permute(1, 0, 2, 3, 4).reshape(b, n * tl, h // n, d)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """[B, T, H/n, D] → [B, T/n, H, D], the inverse of ``seq_to_heads``."""
    n = dist.get_world_size(group)
    b, t, hl, d = x.shape
    chunks = x.reshape(b, n, t // n, hl, d).permute(1, 0, 2, 3, 4)  # [n, B, T/n, H/n, D]
    y = AllToAll.apply(chunks, group)
    return y.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * hl, d)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group,
    causal: bool = False,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Per-rank shards [B, T/n, H, D] (the sequence is the shards in rank
    order) → [B, T/n, H, D]. ``use_kernel`` runs the head-sharded exact
    attention through ``ops.flash.flash_attention`` instead of
    ``local_attention``."""
    n = dist.get_world_size(group)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(f"ulysses needs heads % axis_size == 0, got {h} % {n}")
    qh, kh, vh = (seq_to_heads(x, group) for x in (q, k, v))
    attend = flash_attention if use_kernel else local_attention
    return heads_to_seq(attend(qh, kh, vh, causal=causal), group)


def make_ulysses_attention(mesh, axis_name: str, causal: bool = False, use_kernel: bool = False):
    """All-to-all attention over ``mesh[axis_name]`` as a function of this
    rank's shards q, k, v [B, T/n, H, D] → [B, T/n, H, D] (the calling
    convention of ``ops.ring.make_ring_attention``)."""
    group = mesh.get_group(axis_name)

    def ulysses(q, k, v):
        return ulysses_attention(q, k, v, group, causal=causal, use_kernel=use_kernel)

    return ulysses
