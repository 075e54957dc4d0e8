"""Multi-process bring-up (counterpart of the reference's
``parallel/distributed.py``, where ``jax.distributed`` spans hosts): one
process per device joins a ``torch.distributed`` process group, and the
meshes of ``parallel.mesh`` are built over its ranks.

Configuration comes from the launcher's environment, as torchrun sets it:
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (or explicit
arguments). Nothing is started when none is set (single-process runs and
tests). The device picks the backend: NCCL for ``cuda``, gloo only when the
caller asks for ``cpu``; neither falls back to the other.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from dragonfly2_torch.device import resolve_device
from dragonfly2_torch.parallel.mesh import make_mesh
from dragonfly2_torch.utils import dflog

logger = dflog.get("parallel.distributed")

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def backend_for(device: "str | torch.device") -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def ensure_initialized(
    init_method: "str | None" = None,
    world_size: "int | None" = None,
    rank: "int | None" = None,
    device: "str | torch.device" = "cuda",
) -> bool:
    """Join the process group once per process → True when it is up, False
    when running as one process (no address given and none of ``_ENV`` set).
    ``init_method`` defaults to ``env://``, whose rendezvous reads
    ``MASTER_ADDR``/``MASTER_PORT``; ``world_size`` and ``rank`` default to
    ``WORLD_SIZE`` and ``RANK``. On ``cuda`` the process takes the card of
    its ``LOCAL_RANK`` (torchrun's; else rank modulo the host's cards)."""
    if dist.is_initialized():
        return True
    if init_method is None and not any(os.environ.get(k) for k in _ENV):
        return False
    world_size = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", "0"))
    rank = rank if rank is not None else int(os.environ.get("RANK", "-1"))
    if world_size <= 0 or rank < 0 or rank >= world_size:
        raise ValueError(
            f"multi-process init needs WORLD_SIZE and RANK (got {world_size}, {rank})"
        )
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(dev.index if dev.index is not None else local)
    dist.init_process_group(
        backend_for(dev), init_method=init_method or "env://", world_size=world_size, rank=rank
    )
    logger.info("torch.distributed up: rank %d/%d (%s)", rank, world_size, dist.get_backend())
    return True


def global_mesh(**axes: int):
    """A mesh over every rank of the job, with ``parallel.mesh.make_mesh``'s
    axis rules (one axis may be -1)."""
    return make_mesh(**axes)
