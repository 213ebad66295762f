"""Replica meshes and the mpiplus-primitive analogs (counterpart of
``openmmtools_tpu/parallel/mesh.py``).

The reference's distribution primitives map as:

* ``mpiplus.distribute(task, jobs, send_results_to=0)`` -> :func:`distribute`:
  the leading (replica) axis is split into contiguous blocks, one a mesh
  device; ``task`` runs on each block on that block's device and the
  results meet on the first device (the "gather to rank 0").
* ``@mpiplus.on_single_node(0, broadcast_result=True)`` ->
  :func:`on_single_device`: a host-side function runs once on host copies
  of its tensor arguments.
* ``mpiplus.delayed_termination`` -> nothing: there are no processes to
  protect.

Divergences from the JAX package: a mesh is a :class:`ReplicaMesh`, a list
of ``torch.device`` (not a ``jax.sharding.Mesh``), and the placement
descriptors say which device holds which replicas; ``distribute``'s task
takes a whole block (a batch), where the JAX package vmaps a task of one
item, because the port's kernels are opaque to ``torch.func.vmap``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

__all__ = ["ReplicaMesh", "replica_mesh", "replica_sharding",
           "replicated_sharding", "distribute", "on_single_device",
           "canonical_device", "on_device"]


@dataclasses.dataclass(frozen=True)
class ReplicaMesh:
    """A 1-D mesh: its devices and the name of its axis."""

    devices: Tuple[torch.device, ...]
    axis_name: str = "replica"

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self):
        return {self.axis_name: self.size}


@dataclasses.dataclass(frozen=True)
class ReplicaSharding:
    """Placement of a batched axis on a mesh: split into contiguous blocks,
    one a device (``axis_name`` set), or whole on every device (None)."""

    mesh: ReplicaMesh
    axis_name: Optional[str] = None

    def blocks(self, n: int) -> List[Tuple[torch.device, range]]:
        """(device, items) of ``n`` items: contiguous blocks, the first
        ``n % size`` devices taking one item more and a device without
        items left out; or every item on every device."""
        if self.axis_name is None:
            return [(device, range(n)) for device in self.mesh.devices]
        size = self.mesh.size
        base, extra = divmod(n, size)
        out, start = [], 0
        for i, device in enumerate(self.mesh.devices):
            count = base + (1 if i < extra else 0)
            if count:
                out.append((device, range(start, start + count)))
            start += count
        return out


def replica_mesh(n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 axis_name: str = "replica") -> ReplicaMesh:
    """A 1-D mesh over ``devices`` (default: every CUDA device, the first
    ``n_devices`` of them where given). Without a card and without
    ``devices`` it raises: the port's entry points run on the card unless
    asked for the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "replica_mesh: no CUDA device; pass devices= (for example "
                "[torch.device('cpu')] * 8) to build a mesh without a card")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = tuple(canonical_device(d) for d in devices)
    if not devices:
        raise ValueError("replica_mesh: no devices")
    return ReplicaMesh(devices=devices, axis_name=axis_name)


def canonical_device(device) -> torch.device:
    """``device`` as a tensor on it reports it: a CUDA device with its
    index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def on_device(device):
    """A context in which ``device`` is the current CUDA device (nothing
    for the CPU): the kernels' C entry points launch on the current
    device, whichever device their tensors live on."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replica_sharding(mesh: ReplicaMesh,
                     axis_name: str = "replica") -> ReplicaSharding:
    """Split the leading (replica) axis over the mesh."""
    return ReplicaSharding(mesh=mesh, axis_name=axis_name)


def replicated_sharding(mesh: ReplicaMesh) -> ReplicaSharding:
    """A whole copy on every device of the mesh."""
    return ReplicaSharding(mesh=mesh, axis_name=None)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return []


def _concat(parts):
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(first.device) for p in parts])
    if isinstance(first, (list, tuple)):
        return type(first)(_concat([p[i] for p in parts])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    raise TypeError(f"distribute: cannot concatenate {type(first)!r}")


def distribute(task: Callable, batched_args,
               mesh: Optional[ReplicaMesh] = None):
    """Apply ``task`` to the batch ``batched_args`` (a tensor, or a tuple,
    list or dict of them, all with the same leading axis): without a mesh
    ``task(batched_args)``; with one, ``task`` of each contiguous block of
    the leading axis, moved to that block's device, and the blocks'
    results (tensors with a leading axis, or a tuple, list or dict of them)
    concatenated on the mesh's first device. ``task`` takes a whole block:
    a batch, not one item."""
    if mesh is None:
        return task(batched_args)
    leaves = _leaves(batched_args)
    if not leaves:
        raise ValueError("distribute: no tensor in batched_args")
    n = leaves[0].shape[0]
    parts = []
    for device, idx in replica_sharding(mesh, mesh.axis_name).blocks(n):
        block = _tree_map(lambda t: t[idx.start:idx.stop].to(device),
                          batched_args)
        with on_device(device):
            parts.append(task(block))
    out = _concat(parts)
    return _tree_map(lambda t: t.to(mesh.devices[0]), out)


def on_single_device(fn: Callable):
    """Decorator: give ``fn`` its tensor arguments as numpy arrays on the
    host (the ``on_single_node(0, broadcast_result=True)`` analog for
    host-side analysis code) and return its result as it is."""

    def to_host(value):
        if isinstance(value, torch.Tensor):
            return value.detach().cpu().numpy()
        if isinstance(value, (list, tuple)):
            return type(value)(to_host(v) for v in value)
        if isinstance(value, dict):
            return {k: to_host(v) for k, v in value.items()}
        return value

    def wrapper(*args, **kwargs):
        return fn(*to_host(args), **to_host(kwargs))

    return wrapper
