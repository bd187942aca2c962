"""Device mesh: the port's counterpart of ``mxnet_tpu/parallel/mesh.py``
(``make_mesh``, ``replica_devices``, ``data_parallel_sharding``,
``replicated_sharding``, ``write_and_fence``).

The JAX package builds a ``jax.sharding.Mesh`` and lets XLA insert the
collectives. The port runs on one card for now: a mesh is a small record of
its devices, its axis sizes and its axis names, a sharding is a record of
where a tensor goes, and a mesh of more than one device raises until
distribution is ported (ROADMAP Queue A10).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, as_device, default_device

__all__ = ["Mesh", "make_mesh", "replica_devices", "Sharding",
           "data_parallel_sharding", "replicated_sharding",
           "write_and_fence"]


class Mesh:
    """``devices`` (a list of ``torch.device``), ``shape`` (axis name ->
    size) and ``axis_names``, as ``jax.sharding.Mesh`` spells them."""

    def __init__(self, devices, axes):
        self.devices = list(devices)
        self.shape = dict(axes)
        self.axis_names = tuple(axes)

    def __repr__(self):
        return "Mesh(%s, devices=%s)" % (self.shape, self.devices)


def make_mesh(axes=None, devices=None):
    """A mesh over ``devices`` (default: the card). ``axes`` maps axis name
    to size, e.g. ``{"dp": 1}``; -1 for one axis means "all remaining
    devices". More than one device raises: distribution is not ported."""
    if devices is None:
        devices = [default_device()]
    elif isinstance(devices, (Context, torch.device, str)):
        devices = [devices]
    devices = [as_device(d) for d in devices]
    if axes is None:
        axes = {"dp": len(devices)}
    sizes = dict(axes)
    if -1 in sizes.values():
        known = 1
        for s in sizes.values():
            known *= s if s != -1 else 1
        sizes = {n: (len(devices) // known if s == -1 else s)
                 for n, s in sizes.items()}
    total = 1
    for s in sizes.values():
        total *= int(s)
    if total > len(devices):
        raise ValueError("mesh needs %d devices, only %d available"
                         % (total, len(devices)))
    if total > 1:
        raise MXNetError("a mesh of %d devices needs distribution, which is "
                         "not ported yet (ROADMAP Queue A10); use one "
                         "device" % total)
    return Mesh(devices[:total], sizes)


def replica_devices(mesh=None, axis=None):
    """Flat device list for replica round-robin dispatch (the serving
    engine's layout). With ``axis`` the list is the devices along that
    mesh axis (one serving replica per data-parallel slot); without it,
    every device of the mesh, or with no mesh every visible card."""
    if mesh is None:
        if axis is not None:
            raise ValueError(
                "axis=%r needs a mesh to select from; pass mesh= or drop "
                "axis" % (axis,))
        if not torch.cuda.is_available():
            return [default_device()]   # raises: no silent CPU fallback
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if axis is None:
        return list(mesh.devices)
    if axis not in mesh.axis_names:
        raise ValueError("axis %r not in mesh axes %s"
                         % (axis, list(mesh.axis_names)))
    grid = np.arange(len(mesh.devices)).reshape(
        [mesh.shape[n] for n in mesh.axis_names])
    sel = [0] * grid.ndim
    sel[list(mesh.axis_names).index(axis)] = slice(None)
    return [mesh.devices[i] for i in grid[tuple(sel)].flat]


def _one_device(mesh):
    if len(mesh.devices) != 1:
        raise MXNetError("a mesh of %d devices needs distribution, which is "
                         "not ported yet (ROADMAP Queue A10)"
                         % len(mesh.devices))
    return mesh.devices[0]


class Sharding:
    """Where a tensor lives on a mesh: ``device`` and ``spec``, the axis
    name that splits dim 0 (``None`` for replicated), as
    ``jax.sharding.NamedSharding`` with a ``PartitionSpec`` says it. On one
    device both kinds place the whole tensor there."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec
        self.device = _one_device(mesh)

    def __repr__(self):
        return "Sharding(%s, spec=%r)" % (self.device, self.spec)


def data_parallel_sharding(mesh, axis="dp"):
    """The sharding that splits dim 0 over the data-parallel axis."""
    if axis not in mesh.axis_names:
        raise ValueError("axis %r not in mesh axes %s"
                         % (axis, list(mesh.axis_names)))
    return Sharding(mesh, axis)


def replicated_sharding(mesh):
    """The fully replicated sharding (the parameters' layout for pure
    data parallelism)."""
    return Sharding(mesh, None)


def write_and_fence(write_fn, fence_key):
    """Checkpoint discipline: process 0 writes, then every process fences
    so no reader sees half a checkpoint. The port runs one process, so
    this is the write; a process group of more raises (ROADMAP Queue
    A10). ``fence_key`` names the fence, as in the JAX package."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise MXNetError("a checkpoint fence across %d processes (%r) needs "
                         "distribution, which is not ported yet (ROADMAP "
                         "Queue A10)" % (dist.get_world_size(), fence_key))
    write_fn()
