"""Request-scoped tracing: follow ONE request from submit to completion.

Counterpart of ``mxnet_tpu/observability/request_trace.py``. The metrics
registry answers "how is the server doing" in aggregate; this module
answers where THIS request's latency went — queue wait vs batch formation
vs device compute vs host fetch:

* :class:`RequestTrace` — one trace per request (``trace_id`` + a list
  of phase-timestamped lifecycle events). The serving engine threads it
  through submit → admission → bucketing → dispatch → replay → fetch →
  completion. ``event(phase)`` marks the END of ``phase`` at the current
  instant, so consecutive events partition the request's lifetime —
  per-phase durations sum to end-to-end latency exactly.
* **Sampling** — ``begin(kind)`` honors ``MXNET_OBS_TRACE_SAMPLE``
  (0 = off, 1 = every request, N = 1-in-N) and returns a shared no-op
  trace when this request is not sampled.
* :class:`TraceReservoir` — a bounded keep of full span timelines for
  the tail: the slowest-K requests ever seen plus the most-recent-K
  (``MXNET_OBS_RESERVOIR``), read by :func:`tracez`.
* :func:`current` / :func:`activate` keep an ambient trace per
  thread/context.

The JAX package also exports a finished trace into its profiler's
chrome-trace buffer (its ``_get_profiler`` hook). The port has no
``profiler.py`` yet (ROADMAP A13), so that export is left out; timestamps
are reported relative to this module's import instead of the profiler's
start.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time

from . import metrics

__all__ = ["RequestTrace", "TraceReservoir", "begin", "sample_every",
           "reservoir", "tracez", "reset", "current", "activate",
           "NOOP_TRACE"]

_id_counter = itertools.count(1)
_sample_counters = {}  # kind -> itertools.count (atomic appends via GIL)

_pid = None
_T0 = time.perf_counter()


def _to_us(t_s):
    """Raw perf_counter seconds -> microseconds since this module's import.

    Events store raw ``time.perf_counter()`` values: the conversion runs
    at READ time (``tracez``, ``to_dict``), never on the per-event hot
    path."""
    return (t_s - _T0) * 1e6


def _getpid():
    global _pid
    if _pid is None:
        _pid = os.getpid()
    return _pid


_sample_cached = None


def sample_every():
    """The MXNET_OBS_TRACE_SAMPLE flag: 0 = tracing off, 1 = every
    request traced (default — a trace is ~a dozen tuple appends), N =
    1-in-N. Cached after first read — config.set_flag keeps the cache
    coherent via its applier hook, the MXNET_TELEMETRY discipline."""
    global _sample_cached
    if _sample_cached is None:
        from ..config import get_flag

        _sample_cached = int(get_flag("MXNET_OBS_TRACE_SAMPLE"))
    return _sample_cached


def _apply_sample_flag(value):
    """config.set_flag('MXNET_OBS_TRACE_SAMPLE', ...) applier."""
    global _sample_cached
    _sample_cached = None if value is None else int(value)


class _NoopTrace:
    """Shared do-nothing trace returned while this request is not
    sampled — call sites stay unconditional (``trace.event(...)``)."""

    __slots__ = ()
    trace_id = None
    kind = "noop"
    sampled = False
    status = None
    total_us = 0.0

    def event(self, phase):
        pass

    def annotate(self, **kw):
        pass

    def finish(self, status="ok"):
        pass

    def spans(self):
        return []

    def phase_totals(self):
        return {}


NOOP_TRACE = _NoopTrace()


class RequestTrace:
    """One request's lifecycle: ``trace_id`` plus phase-timestamped
    events. Created by ``begin(kind)`` at submit; the engines call
    ``event(phase)`` as the request crosses each boundary and
    ``finish(status)`` at delivery."""

    __slots__ = ("_trace_id", "kind", "events", "meta", "status",
                 "finished", "_finish_once")
    sampled = True

    def __init__(self, kind, trace_id=None,
                 _pc=time.perf_counter, _get_ident=threading.get_ident):
        self.kind = kind
        # id formatting deferred to first access: creation is on the
        # submit hot path, readers (finish/tracez) are not
        self._trace_id = str(trace_id) if trace_id is not None else None
        # (phase, t_seconds, tid): raw perf_counter timestamps (see
        # _to_us); the first entry is the submit instant; every later
        # entry marks the END of `phase` (and the start of the next) —
        # the partition that makes attribution exact
        self.events = [("submit", _pc(), _get_ident())]
        self.meta = {}
        self.status = None
        self.finished = False
        # atomic once-guard (C-level next()): finish can race between
        # the dispatcher delivering a batch and an abandon-drain
        # failing it from the stopping thread — a plain check-then-set
        # would let both export the trace
        self._finish_once = itertools.count()

    @property
    def trace_id(self):
        if self._trace_id is None:
            self._trace_id = "%s-%d-%d" % (self.kind, _getpid(),
                                           next(_id_counter))
        return self._trace_id

    def event(self, phase, _pc=time.perf_counter,
              _get_ident=threading.get_ident):
        """Mark the END of ``phase`` (and the start of whatever comes
        next) at the current instant, on the current thread. No-op once
        the trace finished: a finished trace is already exported
        (histograms, reservoir) — e.g. a chunked request whose first
        part expired must not keep growing the exemplar its surviving
        parts ride on, or the two surfaces disagree."""
        if self.finished:
            return
        # hot path (several calls per served request): callers pass
        # string literals (no str() coercion), timestamps stay raw
        # perf_counter seconds (converted at read time, _to_us), thread
        # ids stay raw get_ident values (masked at read time), and name
        # binding via default args skips the global lookups
        self.events.append((phase, _pc(), _get_ident()))

    def annotate(self, **kw):
        """Attach metadata (bucket, replica, rows, ...) carried into
        :func:`tracez` exemplars."""
        self.meta.update(kw)

    # ------------------------------------------------------------- views
    def spans(self):
        """[{phase, ts_us, dur_us, tid}] — one span per consecutive
        event pair; durations partition [submit, last event] exactly."""
        out = []
        ev = self.events
        for (_, t0, _t), (phase, t1, tid) in zip(ev, ev[1:]):
            out.append({"phase": phase, "ts_us": _to_us(t0),
                        "dur_us": (t1 - t0) * 1e6,
                        "tid": tid % (1 << 20)})
        return out

    def phase_totals(self):
        """{phase: total_us} merged across repeated phases (e.g. one
        ``decode`` total over every decode step), insertion-ordered."""
        totals = {}
        ev = self.events
        for i in range(1, len(ev)):
            phase = ev[i][0]
            dur = (ev[i][1] - ev[i - 1][1]) * 1e6
            totals[phase] = totals.get(phase, 0.0) + dur
        return totals

    @property
    def total_us(self):
        return (self.events[-1][1] - self.events[0][1]) * 1e6

    def to_dict(self):
        """JSON-safe exemplar (:func:`tracez`, tests)."""
        t0_us = _to_us(self.events[0][1])
        return {
            "trace_id": self.trace_id,
            "kind": self.kind,
            "status": self.status,
            "start_ts_us": round(t0_us, 1),
            "total_ms": round(self.total_us / 1e3, 4),
            "phases_ms": {p: round(us / 1e3, 4)
                          for p, us in self.phase_totals().items()},
            "spans": [{"phase": s["phase"],
                       "offset_ms": round((s["ts_us"] - t0_us) / 1e3, 4),
                       "dur_ms": round(s["dur_us"] / 1e3, 4),
                       "tid": s["tid"]} for s in self.spans()],
            "meta": dict(self.meta),
        }

    # ------------------------------------------------------------ finish
    def finish(self, status="ok"):
        """Terminal: record per-phase/total latency histograms (labeled
        by engine) and offer the timeline to the tail reservoir
        (idempotent, atomically — exactly one caller exports, concurrent
        finishes are no-ops)."""
        if next(self._finish_once):
            return
        self.finished = True
        self.status = str(status)
        # materialize the id now, BEFORE the reservoir publishes this
        # trace to reader threads: a lazy first read racing between two
        # readers could mint two different ids for one request
        _ = self.trace_id
        if metrics.enabled():
            labels = {"engine": self.kind}
            if self.status == "ok":
                # COMPLETED requests only: folding rejected/expired
                # traces in would collapse the latency percentiles
                # toward zero exactly when the server sheds load —
                # request.failed carries the non-ok rate instead
                metrics.histogram(
                    "request.total_ms", labels=labels,
                    help="end-to-end latency of completed requests by "
                         "engine").observe(self.total_us / 1e3)
                for phase, us in self.phase_totals().items():
                    metrics.histogram(
                        "request.%s_ms" % phase, labels=labels).observe(
                            us / 1e3)
            else:
                metrics.counter("request.failed", labels=labels).inc()
        reservoir().offer(self)


def begin(kind, sample=None):
    """A new :class:`RequestTrace` for one request, or the shared no-op
    trace when sampling (``MXNET_OBS_TRACE_SAMPLE``, overridable via
    ``sample=``) turns this request off."""
    n = sample_every() if sample is None else int(sample)
    if n <= 0:
        return NOOP_TRACE
    if n > 1:
        # per-KIND counters: one global cursor phase-locks against
        # correlated submission patterns (serving+generation submitted
        # alternately at 1-in-2 would starve one kind forever)
        cursor = _sample_counters.get(kind)
        if cursor is None:
            cursor = _sample_counters.setdefault(kind, itertools.count())
        if next(cursor) % n:
            return NOOP_TRACE
    return RequestTrace(kind)


# ------------------------------------------------------------- reservoir
class TraceReservoir:
    """Bounded keep of finished trace timelines: the slowest-K ever
    offered (tail exemplars) plus the most-recent-K, each capped at
    ``capacity`` (MXNET_OBS_RESERVOIR). Offering is O(capacity) worst
    case and only runs for sampled requests."""

    def __init__(self, capacity=None):
        self._lock = threading.Lock()
        self._capacity = capacity      # None = resolve lazily from flag
        self._recent = None            # deque  # guarded-by: self._lock
        self._slow = []                # unordered tail keep  # guarded-by: self._lock
        self._slow_totals = []         # parallel total_us list  # guarded-by: self._lock
        self._slow_min = 0.0           # min total_us in _slow  # guarded-by: self._lock
        self._offered = 0              # guarded-by: self._lock

    def _ensure_locked(self):
        # caller holds self._lock — the _locked suffix contract
        if self._recent is None:
            if self._capacity is None:
                from ..config import get_flag

                self._capacity = max(1, get_flag("MXNET_OBS_RESERVOIR"))
            self._recent = collections.deque(maxlen=self._capacity)

    @property
    def capacity(self):
        with self._lock:
            self._ensure_locked()
            return self._capacity

    @property
    def offered(self):
        return self._offered

    def offer(self, trace):
        total = trace.total_us
        with self._lock:
            self._ensure_locked()
            self._offered += 1
            self._recent.append(trace)
            slow, totals = self._slow, self._slow_totals
            if len(slow) < self._capacity:
                slow.append(trace)
                totals.append(total)
                self._slow_min = min(totals)
            elif total > self._slow_min:
                # replace the current minimum (a C-speed scan of a
                # float list); steady-state non-tail offers are O(1)
                i = totals.index(self._slow_min)
                slow[i] = trace
                totals[i] = total
                self._slow_min = min(totals)

    def recent(self, n=None):
        with self._lock:
            out = list(self._recent or ())
        out = out if n is None else out[-int(n):]
        return list(reversed(out))

    def slowest(self, n=None):
        with self._lock:
            pairs = list(zip(self._slow_totals, self._slow))
        pairs.sort(key=lambda p: -p[0])
        out = [t for _, t in pairs]
        return out if n is None else out[:int(n)]

    def reset(self):
        with self._lock:
            self._recent = None
            self._slow = []
            self._slow_totals = []
            self._slow_min = 0.0
            self._offered = 0
            self._capacity = None


_reservoir = TraceReservoir()


def reservoir():
    """The process-wide tail reservoir (:func:`tracez`'s source)."""
    return _reservoir


def tracez(n=None):
    """JSON-safe payload: recent + slowest exemplars (the JAX package's
    ``/tracez`` endpoint body)."""
    res = reservoir()
    return {
        "sample_every": sample_every(),
        "capacity": res.capacity,
        "offered": res.offered,
        "recent": [t.to_dict() for t in res.recent(n)],
        "slowest": [t.to_dict() for t in res.slowest(n)],
    }


def reset():
    """Drop reservoir contents (tests, bench isolation)."""
    _reservoir.reset()


# ---------------------------------------------------------- ambient trace
_current = contextvars.ContextVar("mxnet_request_trace")


def current():
    """The ambient trace of this thread/context (None outside an
    ``activate`` block)."""
    return _current.get(None)


@contextlib.contextmanager
def activate(trace):
    """Make ``trace`` the ambient trace for the with-block."""
    token = _current.set(trace)
    try:
        yield trace
    finally:
        _current.reset(token)
