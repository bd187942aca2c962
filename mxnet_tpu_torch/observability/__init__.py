"""Serving telemetry: the counterpart of ``mxnet_tpu/observability/``, as
far as the serving engine needs it.

* :mod:`.metrics` — process-wide counters/gauges/histograms with a
  Prometheus text exposition (:func:`dump_metrics`) and a zero-overhead
  no-op mode (MXNET_TELEMETRY flag).
* :mod:`.request_trace` — one :class:`~.request_trace.RequestTrace` per
  served request, submit to completion, with exact
  queue/batch/compute/fetch latency attribution and a bounded
  tail-exemplar reservoir.
* :mod:`.flight_recorder` — a ring of records and named provider
  sections, dumped as one atomic triage file on demand or on anomaly.
* :mod:`.stats_schema` — the ONE stats vocabulary of the engines'
  ``get_stats()`` snapshots.
* :mod:`.perf` — the ``perf`` section of those snapshots
  (``summary_brief`` only).

The JAX package's other modules here (``instruments``, ``tracing``,
``health``, ``exposition``, ``promparse``, ``timeseries``, ``fleet``,
``slo_monitor``, ``dist_trace`` and the rest of ``perf``) are not ported
yet (ROADMAP A9, A10, A13).
"""
from . import metrics
from . import request_trace
from . import flight_recorder
from . import stats_schema
from . import perf
from .metrics import (counter, gauge, histogram, dump_metrics,
                      reset_metrics, set_enabled, enabled)
from .request_trace import RequestTrace

__all__ = ["metrics", "request_trace", "flight_recorder", "stats_schema",
           "perf", "counter", "gauge", "histogram", "dump_metrics",
           "reset_metrics", "set_enabled", "enabled", "RequestTrace"]
