"""Named process meshes (counterpart of the reference's
``parallel/mesh.py``): a ``torch.distributed.device_mesh.DeviceMesh`` over
the ranks of the default process group, with the reference's axis rules."""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def axis_sizes(n: int, **axes: int) -> "dict[str, int]":
    """The reference's rules over ``n`` ranks → {axis: size}: no axes means
    ``dp`` over all of them; one axis may be -1 and takes what the others
    leave; the mesh may use fewer ranks than there are, never more."""
    if not axes:
        axes = {"dp": n}
    names, sizes = list(axes), list(axes.values())
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    if len(unknown) > 1:
        raise ValueError("at most one axis may be -1")
    if unknown:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[unknown[0]] = n // known
    total = math.prod(sizes)
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} devices, have {n}")
    return dict(zip(names, sizes))


def make_mesh(**axes: int) -> DeviceMesh:
    """A mesh named by ``axes`` (e.g. ``make_mesh(dp=2, sp=-1)``) over the
    first ranks of the initialized default process group, rank-major in
    axis order, on ``cuda`` under NCCL and on the CPU under gloo. Every
    rank calls it (the per-axis groups are created collectively); a rank
    outside a smaller mesh has no coordinate in it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (ensure_initialized)")
    sizes = axis_sizes(dist.get_world_size(), **axes)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(math.prod(sizes.values())).reshape(tuple(sizes.values()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(sizes))


def mesh_shape(mesh: DeviceMesh) -> "dict[str, int]":
    """{axis: size} of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def auto_dp_mesh() -> "DeviceMesh | None":
    """A pure ``dp`` mesh over every rank when there is more than one,
    ``None`` in a single process (as the reference on one device)."""
    if not dist.is_initialized() or dist.get_world_size() < 2:
        return None
    return make_mesh(dp=dist.get_world_size())
