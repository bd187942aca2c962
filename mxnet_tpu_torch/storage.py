"""Storage facade — device memory visibility and raw buffers (reference:
src/storage/ StorageImpl + include/mxnet/storage.h:36-129).

Counterpart of ``mxnet_tpu/storage.py``. The reference owns allocation:
per-device managers (naive malloc, pooled cudaMalloc free-lists, pinned).
Here the allocator is PyTorch's CUDA caching allocator (the pooled
manager's role), so what is left is (a) observability — its statistics
under the JAX package's key names — and (b) explicit raw buffers.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .context import Context, as_device

__all__ = ["Storage", "memory_info"]

# torch.cuda.memory_stats key -> the JAX package's name for it
_STAT_KEYS = {"allocated_bytes.all.current": "bytes_in_use",
              "allocated_bytes.all.peak": "peak_bytes_in_use",
              "reserved_bytes.all.current": "bytes_reserved",
              "allocation.all.allocated": "num_allocs"}


def memory_info(ctx=None):
    """Allocator statistics for a device (reference: the pooled manager's
    used/free accounting, src/storage/pooled_storage_manager.h:48).

    On a card: ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``
    and ``num_allocs`` from the caching allocator and ``bytes_limit``, the
    card's memory. The CPU reports {} (host malloc is unmanaged, like the
    reference's naive CPU manager). ``ctx=None`` is the innermost ``with``
    scope, else the card.
    """
    if ctx is not None and not isinstance(ctx, Context):
        raise MXNetError("memory_info expects a Context")
    dev = as_device(ctx)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    out = {name: int(stats.get(key, 0)) for key, name in _STAT_KEYS.items()}
    out["bytes_limit"] = int(torch.cuda.get_device_properties(dev)
                             .total_memory)
    return out


class Storage:
    """Process-wide storage manager facade (reference:
    Storage::Get(), storage.cc:39 — singleton over per-device managers)."""

    _instance = None

    @staticmethod
    def get():
        if Storage._instance is None:
            Storage._instance = Storage()
        return Storage._instance

    def alloc(self, size, ctx=None):
        """Allocate a raw buffer of ``size`` bytes on ``ctx`` (the
        innermost scope, else the card); returns a handle with
        ``.size``/``.ctx``/``.array`` (a uint8 tensor)."""
        dev = as_device(ctx)
        arr = torch.zeros((int(size),), dtype=torch.uint8, device=dev)
        return _Handle(arr, int(size), ctx)

    def free(self, handle):
        """Release a handle (the caching allocator takes the block back
        on the last reference)."""
        handle.array = None

    def memory_info(self, ctx=None):
        return memory_info(ctx)


class _Handle:
    __slots__ = ("array", "size", "ctx")

    def __init__(self, array, size, ctx):
        self.array = array
        self.size = size
        self.ctx = ctx
