"""Shared device-staging machinery: host-to-device transfers and the
bounded in-flight window behind a double-buffered dispatch path.

Counterpart of ``mxnet_tpu/runtime/staging.py``. The serving dispatcher
keeps batch N+1 staged and dispatched while batch N executes, and fetches
to the host at the window boundary (:class:`PipelineWindow`); the
streaming input pipeline (``runtime/pipeline.py``) uses the same pair.

On the card a transfer is asynchronous: :func:`stage_pytree` copies the
host arrays into pinned buffers and enqueues the copies onto the device
with ``non_blocking=True`` on the caller's current stream, then returns.
Each pinned buffer comes from torch's caching host allocator, which
records an event on that stream at the copy and does not hand the buffer
out again before the event completes: a later stage never overwrites a
buffer whose copy is still pending.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

__all__ = ["stage_pytree", "PipelineWindow"]


def _stage_leaf(x, device):
    if isinstance(x, torch.Tensor):
        host = x.detach()
    else:
        host = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cpu":
        return host.clone()
    if host.device.type == "cpu":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def stage_pytree(tree, device=None):
    """Transfer a pytree (lists, tuples and dicts) of host arrays to
    ``device``: on a card through pinned buffers, asynchronously on the
    caller's current stream; on the CPU a plain copy. ``device`` None is
    the current card."""
    from ..context import as_device

    device = as_device(device)
    if isinstance(tree, dict):
        return {k: stage_pytree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(stage_pytree(v, device) for v in tree)
    return _stage_leaf(tree, device)


class PipelineWindow:
    """A bounded window of in-flight entries (FIFO).

    The caller pushes staged/dispatched work and pops the oldest entry
    when the window is full (or when there is nothing better to do) —
    batch N's results are fetched while batch N+1 executes. The window
    itself is policy-free: what an "entry" is and what popping means
    (host fetch, consumption) belong to the caller.

    Single-owner by design — the serving dispatcher thread — so no
    lock; ``snapshot()`` is the one concurrent reader (crash-dump
    providers) and tolerates a racing mutation.
    """

    __slots__ = ("depth", "_entries", "_pushed", "_wait_s")

    def __init__(self, depth):
        if depth < 1:
            raise ValueError("window depth must be >= 1, got %r" % (depth,))
        self.depth = int(depth)
        self._entries = collections.deque()
        self._pushed = 0
        self._wait_s = 0.0

    def __len__(self):
        return len(self._entries)

    def __bool__(self):
        return bool(self._entries)

    @property
    def full(self):
        return len(self._entries) >= self.depth

    @property
    def pushed(self):
        """Total entries ever pushed (occupancy accounting)."""
        return self._pushed

    @property
    def wait_s(self):
        """Cumulative seconds spent inside timed ``pop`` finalizers —
        the window's measured drain cost (input- vs compute-bound
        attribution)."""
        return self._wait_s

    def push(self, entry):
        self._entries.append(entry)
        self._pushed += 1
        return entry

    def pop(self):
        """Oldest in-flight entry (the caller fetches/consumes it);
        raises IndexError when empty — callers gate on ``bool(self)``."""
        return self._entries.popleft()

    def pop_timed(self, finalize):
        """Pop the oldest entry and run ``finalize(entry)`` on it,
        accounting the wall time into :attr:`wait_s`. Returns
        ``finalize``'s result."""
        entry = self._entries.popleft()
        t0 = time.perf_counter()
        try:
            return finalize(entry)
        finally:
            self._wait_s += time.perf_counter() - t0

    def snapshot(self):
        """Best-effort copy for crash-dump providers: the owning thread
        may mutate concurrently; a torn read degrades to []."""
        try:
            return list(self._entries)
        except RuntimeError:  # deque mutated mid-iteration
            return []

    def clear(self):
        self._entries.clear()
