"""Sharding over a process mesh (counterpart of the reference's
``parallel/sharding.py``, where ``NamedSharding`` puts data and parameters
on the mesh and XLA inserts the collectives).

One process drives one device, so a sharded array is this rank's shard
and a replicated one is this rank's whole copy; the collectives the
compiler would insert are explicit here, on the axis's process group. A
partition spec is a tuple with one entry per array dimension: an axis name
(that dimension is split over the axis, rank-major) or None (whole).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from dragonfly2_torch.device import matmul_f32acc
from dragonfly2_torch.models.mlp import gelu

# host→device puts made by shard_superbatch in this process: exactly one
# per superbatch per rank (each rank uploads only its row shard)
PUTS = 0


def axis_group(mesh, axis: str):
    """→ (process group, axis size, this rank's coordinate on the axis)."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def batch_sharding(mesh, axis: str = "dp") -> tuple:
    """Leading-dim sharding for data batches, as ``torch.distributed.tensor``
    placements over ``mesh``'s dimensions."""
    # imported here, not with the module: importing the package slows
    # every small torch op in the process, and only this helper needs it
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def _leaves(tree) -> "list[torch.Tensor]":
    if isinstance(tree, torch.nn.Module):
        return [t for t in tree.state_dict().values()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


@torch.no_grad()
def replicate(mesh, tree: Any) -> Any:
    """Make every rank's copy of ``tree`` (a module, a tensor, or nested
    dicts and lists of tensors) rank 0's, in place: a broadcast over each
    axis from its first rank. Returns ``tree``."""
    leaves = _leaves(tree)
    for name in mesh.mesh_dim_names:
        group = mesh.get_group(name)
        if dist.get_world_size(group) == 1:
            continue
        src = dist.get_global_rank(group, 0)
        for leaf in leaves:
            dist.broadcast(leaf, src=src, group=group)
    return tree


def _shard_slice(size: int, n: int, rank: int, what: str) -> slice:
    if size % n:
        raise ValueError(f"{what} of size {size} not divisible by the axis's {n} ranks")
    per = size // n
    return slice(rank * per, (rank + 1) * per)


def shard_batch(mesh, tree: Any, axis: str = "dp") -> Any:
    """This rank's shard of every leaf's leading dim over ``axis`` (numpy
    arrays or tensors, in nested dicts and lists); pads are the caller's
    job (leading dims must divide the axis size)."""
    _, n, rank = axis_group(mesh, axis)

    def one(x):
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        return x[_shard_slice(x.shape[0], n, rank, "leading dim")]

    return one(tree)


def shard_superbatch(mesh, buf: torch.Tensor, axis: str = "dp", batch_dim: int = 0,
                     device=None) -> torch.Tensor:
    """The ingest pipeline's mesh feed (``trainer/ingest.py``): this rank's
    row shard of the host superbatch ``buf`` along ``batch_dim``, put on
    ``device`` with one copy (non-blocking from pinned memory; on the CPU
    the shard is a view of the buffer). Each rank uploads only its row
    shard — one put per superbatch per rank (``PUTS``)."""
    global PUTS
    _, n, rank = axis_group(mesh, axis)
    idx = [slice(None)] * buf.dim()
    idx[batch_dim] = _shard_slice(buf.shape[batch_dim], n, rank, f"superbatch dim {batch_dim}")
    shard = buf[tuple(idx)]
    PUTS += 1
    if device is None or torch.device(device) == shard.device:
        return shard
    return shard.to(device, non_blocking=True)


def tree_sharding(mesh, tree: Any, spec_fn: Callable) -> Any:
    """Every leaf of ``tree`` (nested dicts and lists of tensors or numpy
    arrays) cut to this rank's shard by its spec ``spec_fn(path, leaf)``;
    ``path`` is the tuple of keys and indices down to the leaf."""

    def one(node, path):
        if isinstance(node, dict):
            return {k: one(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(one(v, path + (i,)) for i, v in enumerate(node))
        idx = []
        for d, name in enumerate(spec_fn(path, node)):
            if name is None:
                idx.append(slice(None))
            else:
                _, n, rank = axis_group(mesh, name)
                idx.append(_shard_slice(node.shape[d], n, rank, f"{'/'.join(map(str, path))} dim {d}"))
        return node[tuple(idx)]

    return one(tree, ())


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad ``x`` along ``axis`` to a multiple; returns (padded, real_len)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return np.pad(x, widths), n


def mlp_param_spec(path, leaf) -> tuple:
    """Tensor-parallel spec for ``models.mlp`` params (``layers/<i>/w|b``):
    alternate hidden-dim sharding over ``mp`` (layer 0 output-sharded,
    layer 1 input-sharded, …) so consecutive matmuls chain with one
    all-reduce between them; tiny head dims that cannot split stay
    whole."""
    if "layers" in path:
        layer_idx = next(k for k in path if isinstance(k, int))
        if path[-1] == "w" and leaf.ndim == 2:
            if layer_idx % 2 == 0:
                return (None, "mp") if leaf.shape[1] > 1 else ()
            return ("mp", None) if leaf.shape[0] > 1 else ()
        if path[-1] == "b" and layer_idx % 2 == 0 and leaf.shape[0] > 1:
            return ("mp",)
    return ()


class SumOverAxis(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the partial products of
    an input-sharded matmul summed over the axis; every rank's loss is the
    same replicated value, so the gradient passes through once."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class EnterAxis(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated activation
    entering an output-sharded matmul, whose gradient is partial on each
    rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def apply_mlp_sharded(layers: list, dims: "list[int]", x: torch.Tensor, mesh,
                      compute_dtype: "torch.dtype | None" = None) -> torch.Tensor:
    """``models.mlp.apply_mlp`` over parameters cut by ``mlp_param_spec``:
    ``layers`` is this rank's ``[{"w", "b"}, …]`` shards of an MLP of
    widths ``dims``. An output-sharded layer leaves the hidden dim split
    over ``mp``; the next, input-sharded layer sums its partial products
    over the axis — the collectives XLA inserts for the reference's spec."""
    from dragonfly2_torch.device import compute_dtype as device_compute_dtype

    group, n, _ = axis_group(mesh, "mp")
    if compute_dtype is None:
        compute_dtype = device_compute_dtype(x.device)
    h = x
    last = len(layers) - 1
    for i, layer in enumerate(layers):
        whole = SimpleNamespace(ndim=2, shape=(dims[i], dims[i + 1]))
        spec = mlp_param_spec(("layers", i, "w"), whole) if n > 1 else ()
        if spec == (None, "mp"):
            h = matmul_f32acc(EnterAxis.apply(h, group), layer["w"], compute_dtype)
        elif spec == ("mp", None):
            h = SumOverAxis.apply(matmul_f32acc(h, layer["w"], compute_dtype), group)
        else:
            h = matmul_f32acc(h, layer["w"], compute_dtype)
        h = h + layer["b"].float()
        if i != last:
            h = gelu(h)
    return h


@torch.no_grad()
def mean_grads(params, group, n: int, extra: "torch.Tensor | None" = None) -> "torch.Tensor | None":
    """Data-parallel gradient reduction: every parameter's gradient summed
    over ``group`` in one flat buffer and divided by ``n``, so each rank's
    gradient of its row shard's mean loss becomes the gradient of the
    whole batch's mean loss (the all-reduce XLA inserts for a dp-sharded
    batch). ``extra`` (float32 values such as the loss) rides the same
    all-reduce and comes back summed over the ranks."""
    params = [p for p in params if p.grad is not None]
    parts = [p.grad.reshape(-1).float() for p in params]
    if extra is not None:
        parts.append(extra.reshape(-1).float())
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    at = 0
    for p in params:
        k = p.grad.numel()
        p.grad.copy_((flat[at : at + k] / n).view_as(p.grad))
        at += k
    return flat[at:] if extra is not None else None
