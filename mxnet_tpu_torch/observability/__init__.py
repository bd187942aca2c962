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
* :mod:`.promparse` — the Prometheus text-format parser, the inverse of
  :func:`dump_metrics`.
* :mod:`.timeseries` — the time-series plane: a background sampler
  snapshots the registry into bounded rings (``MXNET_OBS_TS_*``) with
  windowed queries (counter rates, gauge windows, bucket-delta
  quantiles) behind :func:`~.timeseries.varz` and the ``timeseries``
  flight-recorder provider.
* :mod:`.slo_monitor` — latency and availability objectives evaluated as
  multi-window burn rates with hysteresis, the alerts the autoscaler
  (serving/control/autoscale.py) acts on.

The JAX package's other modules here (``instruments``, ``tracing``,
``health``, ``exposition``, ``fleet``, ``dist_trace`` and the rest of
``perf``) are not ported yet (ROADMAP A10, A13).
"""
from . import metrics
from . import request_trace
from . import flight_recorder
from . import stats_schema
from . import perf
from . import promparse
from . import timeseries
from . import slo_monitor
from .metrics import (counter, gauge, histogram, dump_metrics,
                      reset_metrics, set_enabled, enabled)
from .request_trace import RequestTrace

__all__ = ["metrics", "request_trace", "flight_recorder", "stats_schema",
           "perf", "promparse", "timeseries", "slo_monitor", "counter",
           "gauge", "histogram", "dump_metrics", "reset_metrics",
           "set_enabled", "enabled", "RequestTrace"]
