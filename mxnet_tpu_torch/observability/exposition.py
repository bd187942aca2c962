"""Live exposition plane: scrape a running process over HTTP.

Counterpart of ``mxnet_tpu/observability/exposition.py``, stdlib only.

Until now every observability surface was *post-mortem* (flight-recorder
dumps, profiler files) or *in-process* (``get_stats()``, the metrics
registry). A serving fleet needs the pull side: Prometheus scraping
``/metrics``, a load balancer probing ``/healthz``, an operator curling
``/statusz`` at 3am. This module is that plane — stdlib-only
(``http.server``), opt-in, and read-only:

* ``GET /metrics`` — the metrics registry's Prometheus text exposition
  (metrics.dump_metrics) under the spec content type.
* ``GET /statusz`` — live JSON: one schema row per serving engine
  (queue depth, occupancy, KV pages/bytes, circuit-breaker state —
  stats_schema.summarize), plus every flight-recorder provider section
  (graph-pass and quantize provenance, kvstore staleness, io pipeline)
  and process vitals.
* ``GET /healthz`` — liveness: 200 + uptime (the process answering IS
  the signal; readiness belongs to the engines' own admission control).
* ``GET /tracez`` — recent + slowest request-trace exemplars
  (request_trace.tracez): full per-phase span timelines for the tail.
* ``GET /varz?window=60`` — trailing-window JSON from the time-series
  sampler (timeseries.varz): counter rates, gauge avg/min/max, and
  bucket-delta histogram quantiles over the requested window seconds —
  the "last minute", where /metrics is "since boot".

Enable it by environment — ``MXNET_OBS_HTTP_PORT=9100`` (0 picks an
ephemeral port) before importing mxnet_tpu_torch — or programmatically with
:func:`start_http`. The server is a daemon thread; every handler is
read-only and exception-isolated (a scrape can never take serving
down). Binds 127.0.0.1 by default (``MXNET_OBS_HTTP_HOST`` widens it):
an observability port is an information surface, not something to open
to the world silently.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time

from . import metrics, request_trace, stats_schema

__all__ = ["start_http", "stop_http", "http_port", "statusz", "healthz"]

_log = logging.getLogger("mxnet_tpu_torch.observability")

_lock = threading.Lock()
_server = None          # ThreadingHTTPServer  # guarded-by: _lock
_thread = None          # guarded-by: _lock
_started_at = time.time()


def _engine_rows():
    """One schema summary row per live serving engine, pulled from the
    flight-recorder provider registry (the engines register there at
    construction — no serving import from observability, no second
    registry to drift)."""
    from . import flight_recorder

    sections = flight_recorder.provider_sections()
    rows = []
    for name, plural in (("serving", "servers"),
                         ("generation", "generators")):
        view = sections.get(name)
        if view is None:
            continue
        views = view[plural] if isinstance(view, dict) and plural in view \
            else [view]
        for v in views:
            try:
                rows.append(stats_schema.summarize(v))
            except Exception as err:
                rows.append({"engine": name, "error": repr(err)})
    return rows, sections


def statusz():
    """The /statusz payload (also importable for tests/tools)."""
    from .. import profiler
    from . import perf

    rows, sections = _engine_rows()
    return {
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "pid": os.getpid(),
        "uptime_s": round(time.time() - _started_at, 1),
        "telemetry_enabled": metrics.enabled(),
        "trace_sample_every": request_trace.sample_every(),
        "profiler_dropped_events": profiler.dropped_events(),
        "perf": perf.summary_brief(),
        "engines": rows,
        "providers": sections,
        "training": _training_section(),
    }


def _training_section():
    """A fit in progress (or recently finished) is scrapeable like a
    serving worker: its step-waterfall ring tail and health summary ride
    /statusz.  None when this process never ran a perf-scoped step —
    serving-only workers stay clean."""
    from . import flight_recorder, health, perf

    falls = perf.waterfalls(16)
    if not falls:
        return None
    section = {
        "rank": falls[-1].get("rank"),
        "steps_recorded": len(falls),
        "last_step": falls[-1].get("step"),
        "waterfall": perf._waterfall_brief(falls[-1]),
        "health_policy": health.policy(),
    }
    # the newest per-step health record (grad norms etc.) when the
    # health plane is recording them
    for rec in reversed(flight_recorder.snapshot()):
        if isinstance(rec, dict) and "grad_norm" in rec:
            section["health"] = rec
            break
    return section


def healthz():
    """The /healthz payload: liveness + vitals."""
    return {
        "status": "ok",
        "pid": os.getpid(),
        "uptime_s": round(time.time() - _started_at, 1),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def _json_bytes(payload):
    # default=repr: one exotic value (numpy scalar in a provider
    # section) must degrade to its repr, never 500 the scrape
    return (json.dumps(payload, indent=1, default=repr) + "\n").encode()


def _make_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        server_version = "mxnet-tpu-torch-obs/1"

        def do_GET(self):  # noqa: N802 - http.server API
            path, _, query = self.path.partition("?")
            path = path.rstrip("/") or "/"
            try:
                if path == "/metrics":
                    # refresh derived gauges (heartbeat ages etc.) at
                    # scrape time — they grow while their writers stay
                    # silent, so write-time values would freeze
                    from . import timeseries
                    timeseries._run_pre_sample_hooks()
                    body = metrics.dump_metrics().encode()
                    ctype = metrics.PROM_CONTENT_TYPE
                elif path in ("/", "/statusz"):
                    body, ctype = (_json_bytes(statusz()),
                                   "application/json; charset=utf-8")
                elif path == "/healthz":
                    body, ctype = (_json_bytes(healthz()),
                                   "application/json; charset=utf-8")
                elif path == "/tracez":
                    body, ctype = (_json_bytes(request_trace.tracez()),
                                   "application/json; charset=utf-8")
                elif path == "/varz":
                    from . import timeseries
                    window = 60.0
                    for part in query.split("&"):
                        k, _, v = part.partition("=")
                        if k == "window" and v:
                            window = max(0.001, float(v))
                    body, ctype = (_json_bytes(timeseries.varz(window)),
                                   "application/json; charset=utf-8")
                else:
                    body = _json_bytes(
                        {"error": "unknown path %r" % path,
                         "paths": ["/metrics", "/statusz", "/healthz",
                                   "/tracez", "/varz"]})
                    self._reply(404, body, "application/json; charset=utf-8")
                    return
            except Exception as err:  # read-only plane: report, never die
                body = _json_bytes({"error": repr(err)})
                self._reply(500, body, "application/json; charset=utf-8")
                return
            self._reply(200, body, ctype)

        def _reply(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                pass  # scraper went away mid-reply

        def log_message(self, fmt, *args):  # stdout is the app's, not ours
            _log.debug("obs-http %s - %s", self.address_string(),
                       fmt % args)

    return Handler


def start_http(port=None, host=None):
    """Start the exposition server (idempotent; returns the bound port).

    ``port=None`` reads ``MXNET_OBS_HTTP_PORT`` (absent/empty = error —
    callers wanting env-gated startup should check first); ``port=0``
    binds an ephemeral port (tests). ``host`` defaults to
    ``MXNET_OBS_HTTP_HOST`` or 127.0.0.1."""
    global _server, _thread
    from http.server import ThreadingHTTPServer

    with _lock:
        if _server is not None:
            return _server.server_address[1]
        if port is None:
            spec = os.environ.get("MXNET_OBS_HTTP_PORT", "").strip()
            if not spec:
                raise ValueError(
                    "start_http(): no port given and MXNET_OBS_HTTP_PORT "
                    "is unset")
            port = int(spec)
        if host is None:
            host = os.environ.get("MXNET_OBS_HTTP_HOST",
                                  "127.0.0.1").strip() or "127.0.0.1"
        server = ThreadingHTTPServer((host, int(port)), _make_handler())
        server.daemon_threads = True
        thread = threading.Thread(target=server.serve_forever,
                                  name="mxnet-obs-http", daemon=True)
        thread.start()
        _server, _thread = server, thread
        bound = server.server_address[1]
    # /varz needs a running sampler; MXNET_OBS_TS_INTERVAL_MS=0 opts out
    from . import timeseries

    timeseries.start_sampler()
    _log.info("observability HTTP plane on http://%s:%d "
              "(/metrics /statusz /healthz /tracez /varz)", host, bound)
    return bound


def stop_http():
    """Stop the exposition server (idempotent)."""
    global _server, _thread
    with _lock:
        server, _server = _server, None
        thread, _thread = _thread, None
    if server is not None:
        server.shutdown()
        server.server_close()
    if thread is not None:
        thread.join(timeout=5)
    if server is not None:
        from . import timeseries

        timeseries.stop_sampler()


def http_port():
    """The bound port, or None while the plane is down."""
    with _lock:
        return _server.server_address[1] if _server is not None else None


def maybe_start_from_env():
    """Import-time hook (observability/__init__): start the plane iff
    MXNET_OBS_HTTP_PORT is set. Failures log and never break import —
    observability must not take the workload down."""
    spec = os.environ.get("MXNET_OBS_HTTP_PORT", "").strip()
    if not spec:
        return None
    try:
        return start_http(int(spec))
    except Exception as err:
        _log.warning("MXNET_OBS_HTTP_PORT=%r: exposition plane failed to "
                     "start: %r", spec, err)
        return None
