"""Device mesh: the port's counterpart of ``mxnet_tpu/parallel/mesh.py``
``make_mesh``.

The JAX package builds a ``jax.sharding.Mesh`` and lets XLA insert the
collectives. The port runs on one card for now: a mesh is a small record of
its devices, its axis sizes and its axis names, and a mesh of more than one
device raises until distribution is ported (ROADMAP Queue A10).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..context import Context, as_device, default_device

__all__ = ["Mesh", "make_mesh"]


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
