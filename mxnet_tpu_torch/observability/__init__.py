"""Training and serving telemetry: the counterpart of
``mxnet_tpu/observability/``.

* :mod:`.metrics` — process-wide counters/gauges/histograms with a
  Prometheus text exposition (:func:`dump_metrics`) and a zero-overhead
  no-op mode (MXNET_TELEMETRY flag).
* :mod:`.tracing` — :func:`trace_span` nested chrome://tracing spans
  into the profiler buffer; :func:`device_scope` labels kernels in the
  ``torch.profiler`` trace and as NVTX ranges.
* :mod:`.instruments` — CUDA-graph captures and kernel builds (the
  port's compiles), device memory watermarks, per-step accounting.
* :mod:`.health` — active training-health layer: one segmented
  non-finite reduction per step over loss/grads/params plus grad-norm
  and update-ratio gauges, with an MXNET_HEALTH policy
  (off|warn|raise|skip_step).
* :mod:`.flight_recorder` — a ring of records and named provider
  sections, dumped as one atomic triage file on demand or on anomaly.
* :mod:`.request_trace` — one :class:`~.request_trace.RequestTrace` per
  served request, submit to completion, with exact
  queue/batch/compute/fetch latency attribution, a bounded
  tail-exemplar reservoir and chrome-trace export into the profiler.
* :mod:`.perf` — roofline attribution: analytic FLOPs/HBM bytes per
  program on the card's calibration table, MFU / HBM utilization from
  CUDA-event device spans per compute dtype, the fit-loop step-time
  waterfall, and the perf-ledger helpers.
* :mod:`.stats_schema` — the ONE stats vocabulary of the engines'
  ``get_stats()`` snapshots.
* :mod:`.exposition` — opt-in stdlib HTTP plane
  (``MXNET_OBS_HTTP_PORT``): ``/metrics``, ``/statusz``, ``/healthz``,
  ``/tracez``, ``/varz?window=``.
* :mod:`.promparse` — the Prometheus text-format parser, the inverse of
  :func:`dump_metrics`.
* :mod:`.timeseries` — the time-series plane: a background sampler
  snapshots the registry into bounded rings (``MXNET_OBS_TS_*``) with
  windowed queries behind :func:`~.timeseries.varz`.
* :mod:`.fleet` — :class:`~.fleet.FleetAggregator`: scrape N workers'
  ``/metrics`` and merge them into fleet-level series.
* :mod:`.slo_monitor` — latency and availability objectives evaluated as
  multi-window burn rates with hysteresis, the alerts the autoscaler
  (serving/control/autoscale.py) acts on.

The JAX package's ``dist_trace`` (cross-rank waterfalls and divergence
sentinels) waits for the port's multi-card slice (ROADMAP A10).
"""
from . import metrics
from . import instruments
from . import tracing
from . import health
from . import flight_recorder
from . import request_trace
from . import stats_schema
from . import exposition
from . import perf
from . import promparse
from . import timeseries
from . import fleet
from . import slo_monitor
from .metrics import (counter, gauge, histogram, dump_metrics,
                      reset_metrics, set_enabled, enabled)
from .tracing import trace_span, device_scope
from .instruments import sample_memory, record_step, retrace_causes
from .health import TrainingHealthError
from .request_trace import RequestTrace

__all__ = ["metrics", "instruments", "tracing", "health", "flight_recorder",
           "request_trace", "stats_schema", "exposition", "perf",
           "promparse", "timeseries", "fleet", "slo_monitor",
           "counter", "gauge", "histogram", "dump_metrics", "reset_metrics",
           "set_enabled", "enabled", "trace_span", "device_scope",
           "sample_memory", "record_step", "retrace_causes",
           "TrainingHealthError", "RequestTrace"]

# honor an env-set MXNET_OBS_HTTP_PORT at import: the exposition plane
# comes up with the process, no code change in the serving script
exposition.maybe_start_from_env()
