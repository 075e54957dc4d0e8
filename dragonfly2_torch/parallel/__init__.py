"""Process meshes over ``torch.distributed`` (counterpart of the reference's
``parallel/`` package): named axes over the ranks of the process group, the
groups the sequence-parallel ops (``ops.ring``, ``ops.ulysses``) talk over,
and the launcher's environment.

Axes, as in the reference: ``dp`` data parallel, ``mp`` model parallel,
``sp`` sequence parallel, ``fed`` federated. One process drives one device,
so a rank stands where the reference has a device."""

from dragonfly2_torch.parallel.distributed import ensure_initialized, global_mesh
from dragonfly2_torch.parallel.mesh import auto_dp_mesh, make_mesh, mesh_shape

__all__ = ["auto_dp_mesh", "ensure_initialized", "global_mesh", "make_mesh", "mesh_shape"]
