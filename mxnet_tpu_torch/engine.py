"""Engine control facade (reference: python/mxnet/engine.py over
MXEngineSetBulkSize — bundling many small ops into one engine push,
src/engine/threaded_engine.h BulkStatus).

Counterpart of ``mxnet_tpu/engine.py``. PyTorch has no dependency engine
to bundle for: ops queue on the card's stream as they are called, and the
bound graphs that want fewer launches are captured as CUDA graphs. The
API is kept so reference code runs; the size is recorded and visible but
does not change execution."""
from __future__ import annotations

import contextlib

__all__ = ["set_bulk_size", "bulk"]

_bulk_size = 15  # the reference's MXNET_ENGINE_BULK_SIZE default


def set_bulk_size(size):
    """Set the advisory bulk size, returning the previous value."""
    global _bulk_size
    previous = _bulk_size
    _bulk_size = int(size)
    return previous


@contextlib.contextmanager
def bulk(size):
    """``with engine.bulk(n):`` scope form of :func:`set_bulk_size`."""
    outer = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(outer)
