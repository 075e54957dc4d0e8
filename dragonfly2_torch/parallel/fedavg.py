"""Federated multi-cluster aggregation, FedAvg (counterpart of the
reference's ``parallel/fedavg.py``).

Each scheduler cluster trains on its own record shard (its CSV/block
files, keyed by the uploading host as upstream trainer/storage/storage.go
keys them); cluster models are combined by example-weighted parameter
averaging.

- **host-side** (``fedavg_trees``): cluster models arrive as separate
  parameter trees (the cross-datacenter case where clusters are separate
  jobs); the average runs over their tensors, on the device they live on.
- **in-mesh** (``fedavg_psum``): cluster replicas on a ``fed`` axis of a
  process mesh (one process a replica), averaged with all-reduces.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def fedavg_trees(params_list: Sequence[Any], weights: Sequence[float] | None = None) -> Any:
    """Example-weighted average of N parameter trees: state dicts (or
    nested dicts and lists) of tensors with one structure. The leaves are
    summed in list order, ``p₀·w₀ + p₁·w₁ + …`` with ``wᵢ = nᵢ / Σn``, as
    the reference sums them."""
    if not params_list:
        raise ValueError("no models to aggregate")
    n = len(params_list)
    if weights is None:
        w = [1.0 / n] * n
    else:
        total = float(sum(weights))
        if total <= 0:
            raise ValueError("weights must sum to a positive value")
        w = [float(x) / total for x in weights]

    @torch.no_grad()
    def avg(*leaves):
        out = leaves[0] * w[0]
        for leaf, wi in zip(leaves[1:], w[1:]):
            out = out + leaf * wi
        return out

    return _tree_map(avg, *params_list)


def fedavg_psum(params: Any, num_examples, axis_name: str = "fed", mesh=None) -> Any:
    """In-mesh FedAvg over the ``axis_name`` axis of ``mesh`` (the default
    process group when None): ``params`` is this replica's model (a
    module, a state dict or nested dicts and lists of tensors),
    ``num_examples`` its local example count; → the example-weighted
    average, identical on every replica, as a new tree of tensors. The
    reference's two ``psum``s as all-reduces: first of n, then of
    ``p · n / total``."""
    group = mesh.get_group(axis_name) if mesh is not None else None
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    device = next(_flat(params)).device
    n = torch.as_tensor(num_examples, dtype=torch.float32, device=device).reshape(())
    total = n.clone()
    dist.all_reduce(total, group=group)
    scale = n / torch.clamp(total, min=1.0)

    @torch.no_grad()
    def weigh(p):
        out = p * scale.to(p.dtype)
        dist.all_reduce(out, group=group)
        return out

    return _tree_map(weigh, params)


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _flat(v)
    else:
        yield tree
