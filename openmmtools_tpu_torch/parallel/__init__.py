"""Distribution layer: replica meshes and atom sharding (counterpart of
``openmmtools_tpu.parallel``).

The reference distributes replicas over MPI ranks (mpiplus); the JAX package
shards a replica axis over a device mesh. Here a mesh is a list of
``torch.device``: replicas are placed on its devices in contiguous blocks,
and each block advances as one batch on its device
(:func:`~openmmtools_tpu_torch.parallel.mesh.distribute`).
:mod:`~openmmtools_tpu_torch.parallel.atom_shard` splits one system's force
evaluation over a mesh's devices by blocks of atoms.
"""

from openmmtools_tpu_torch.parallel.mesh import (
    ReplicaMesh,
    distribute,
    on_single_device,
    replica_mesh,
    replica_sharding,
    replicated_sharding,
)

__all__ = ["ReplicaMesh", "replica_mesh", "replica_sharding",
           "replicated_sharding", "distribute", "on_single_device"]
