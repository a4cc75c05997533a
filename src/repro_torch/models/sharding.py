"""Batch-axis sharding policy of the port (``repro.models.sharding``'s
``batch_axes`` and ``batch_spec``).

A spec is a plain tuple with one entry per dimension: a tuple of mesh axis
names the dimension is split over, or ``None`` where it is replicated (the
reference's ``PartitionSpec``). The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions. The
parameter and cache specs of the LM's mesh are ROADMAP queue 1 item 14.7.
"""
from __future__ import annotations


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along the mesh dimension named ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in (mesh.mesh_dim_names or ()))


def batch_spec(mesh, batch: int) -> tuple:
    """Shard batch over (pod, data) when divisible; else replicate."""
    axes = batch_axes(mesh)
    ways = 1
    for a in axes:
        ways *= axis_size(mesh, a)
    if batch % max(ways, 1) == 0 and batch >= ways:
        return (axes,)
    return (None,)
