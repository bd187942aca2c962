"""Span tracing: nested chrome://tracing events over the profiler buffer.

Counterpart of ``mxnet_tpu/observability/tracing.py``.
``trace_span(name, cat)`` wraps any host-side phase (a fit step, the
update, a trainer step, a backward) in a complete-event span. Spans land
in the same event ring as the profiler's program events (profiler.py), so
one ``dump_profile()`` shows framework phases, the programs they contain
and the card's kernels on one timeline.

Spans are recorded whenever the profiler session is running (any mode).
Independent of the profiler, when telemetry is enabled each span also
feeds a per-name duration histogram (``span.<name>.ms``).

Host spans time the host: the card runs behind it. To label the kernels
themselves use :func:`device_scope`, a ``torch.profiler.record_function``
(the label the profiler's device records are linked to) plus an NVTX
range on a card.
"""
from __future__ import annotations

import contextlib

from . import metrics

__all__ = ["trace_span", "device_scope"]


class _Span:
    """Reusable context manager for one span instance."""

    __slots__ = ("name", "cat", "_t0", "_prof_on", "_telem_on")

    def __init__(self, name, cat):
        self.name = name
        self.cat = cat
        self._t0 = 0.0
        self._prof_on = False
        self._telem_on = False

    def __enter__(self):
        from .. import profiler

        self._prof_on = profiler.spans_active()
        self._telem_on = metrics.enabled()
        if self._prof_on or self._telem_on:
            self._t0 = profiler._now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        if not (self._prof_on or self._telem_on):
            return False
        from .. import profiler

        dur = profiler._now_us() - self._t0
        if self._prof_on:
            profiler.record(self.name, self.cat, self._t0, dur)
        if self._telem_on:
            metrics.histogram("span.%s.ms" % self.name).observe(dur / 1e3)
        return False


def trace_span(name, cat="phase"):
    """Context manager: record ``name`` as a chrome trace span of
    category ``cat`` covering the with-block (no-op unless the profiler
    is running or telemetry is enabled)."""
    return _Span(name, cat)


@contextlib.contextmanager
def device_scope(name):
    """Label the kernels launched inside the with-block: a
    ``torch.profiler.record_function`` range and, on a card, an NVTX
    range of the same name."""
    import torch

    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
