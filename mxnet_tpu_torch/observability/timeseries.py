"""Time-series layer over the metrics registry: what has this process
been doing for the last N seconds?

Counterpart of ``mxnet_tpu/observability/timeseries.py``, plain Python.
A p99 read from the registry's histograms is a p99 since boot; this
module adds the trailing-window view the SLO monitor and the autoscaler
(serving/control/autoscale.py) are pure functions of.

* :class:`SeriesStore`: per-instrument bounded rings of timestamped
  snapshots with windowed queries: ``rate()`` / ``increase()`` for
  counters (reset-aware: a restarted counter's drop reads as its new
  value, never negative), ``gauge_window`` (avg / min / max / last) for
  gauges, and bucket-delta quantiles for histograms (two cumulative
  snapshots differenced, then the shared
  :func:`~.metrics.bucket_quantile` estimator).
* :class:`TimeSeriesSampler`: a daemon thread snapshotting the registry
  (``metrics.snapshot_values()``, one locked walk) into a store every
  ``MXNET_OBS_TS_INTERVAL_MS``; rings hold ``MXNET_OBS_TS_RETAIN``
  samples. The clock is injectable, so windowed queries are tested
  against hand-computed values with a fake clock.
* pre-sample hooks: ``register_pre_sample(name, fn)`` refreshes derived
  gauges just before each snapshot.
* :func:`varz`: one JSON row per series with the windowed stats for its
  kind, and the ``timeseries`` flight-recorder provider.

Window semantics (shared by every query): the *baseline* is the newest
sample at or before ``now - window``, the *points* are the samples inside
``(now - window, now]``. Counters and histograms difference against the
baseline (zero when the ring does not reach back that far); gauges
aggregate the points only, so a series no longer sampled goes STALE
(``n == 0``) instead of reporting its last value forever.
"""
from __future__ import annotations

import collections
import threading
import time

from . import metrics as _metrics

__all__ = ["SeriesStore", "TimeSeriesSampler", "start_sampler",
           "stop_sampler", "get_sampler", "varz", "register_pre_sample",
           "unregister_pre_sample"]


def _canon(labels):
    if labels is None:
        return None
    if isinstance(labels, dict):
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))
    return tuple(labels)


class SeriesStore:
    """Bounded per-instrument rings of timestamped snapshots + the
    windowed query algebra. Thread-safe: one internal lock guards the
    rings (appenders race queriers)."""

    def __init__(self, retain):
        self.retain = max(2, int(retain))
        self._lock = threading.Lock()
        self._rings = {}   # (name, labels) -> deque[(t, payload)]  # guarded-by: self._lock
        self._meta = {}    # (name, labels) -> (kind, buckets)  # guarded-by: self._lock

    # ------------------------------------------------------------ append
    def append(self, name, labels, kind, buckets, payload, t):
        key = (name, _canon(labels) or ())
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = collections.deque(
                    maxlen=self.retain)
                self._meta[key] = (kind, buckets)
            ring.append((float(t), payload))

    def append_rows(self, rows, t):
        """Bulk append of ``metrics.snapshot_values()``-shaped rows
        (``(name, labels, kind, buckets, payload)``) at one timestamp."""
        for name, labels, kind, buckets, payload in rows:
            self.append(name, labels, kind, buckets, payload, t)

    # ----------------------------------------------------------- lookup
    def keys(self):
        with self._lock:
            return sorted(self._rings)

    def _children(self, name, labels):
        """Matching (key, kind, buckets, samples-copy) rows: exact child
        for a given label set, every child of the family for
        ``labels=None`` (the fleet-merge case — per-worker children of
        one instrument aggregate into the fleet series)."""
        want = _canon(labels)
        out = []
        with self._lock:
            for key, ring in self._rings.items():
                if key[0] != name:
                    continue
                if want is not None and key[1] != want:
                    continue
                kind, buckets = self._meta[key]
                out.append((key, kind, buckets, list(ring)))
        return out

    @staticmethod
    def _split(samples, window_s, now):
        """(baseline, points) per the module window semantics."""
        lo = now - float(window_s)
        baseline = None
        points = []
        for t, payload in samples:
            if t <= lo:
                baseline = (t, payload)
            elif t <= now:
                points.append((t, payload))
        return baseline, points

    # ---------------------------------------------------------- queries
    def rate(self, name, window_s, labels=None, now=None):
        """Per-second increase of a counter family over the trailing
        window, reset-aware, summed across matching children (so a
        fleet-merged rate is the sum of per-worker rates and can never
        go negative through one worker's restart). 0.0 when the window
        holds fewer than two usable samples."""
        total = 0.0
        for _key, _kind, _buckets, samples in self._children(name, labels):
            baseline, points = self._split(samples, window_s, now)
            seq = ([baseline] if baseline is not None else []) + points
            if len(seq) < 2:
                continue
            increase = 0.0
            for (_, prev), (_, cur) in zip(seq, seq[1:]):
                delta = cur - prev
                # counter reset (worker restart): the counter restarted
                # from 0, so the post-reset value IS the increase since
                increase += cur if delta < 0 else delta
            elapsed = seq[-1][0] - seq[0][0]
            if elapsed > 0:
                total += increase / elapsed
        return total

    def increase(self, name, window_s, labels=None, now=None):
        """Absolute reset-aware increase over the window (rate without
        the time division) — what availability burn rates want."""
        total = 0.0
        for _key, _kind, _buckets, samples in self._children(name, labels):
            baseline, points = self._split(samples, window_s, now)
            seq = ([baseline] if baseline is not None else []) + points
            for (_, prev), (_, cur) in zip(seq, seq[1:]):
                delta = cur - prev
                total += cur if delta < 0 else delta
        return total

    def gauge_window(self, name, window_s, labels=None, now=None):
        """``{"avg", "min", "max", "last", "n"}`` over the window's
        points, pooled across matching children. ``n == 0`` (avg/min/
        max/last None) means the series went STALE — no samples inside
        the window, e.g. a dead worker or a collected owner — which is
        deliberately distinct from "gauge is 0"."""
        vals = []
        last_t = None
        last = None
        for _key, _kind, _buckets, samples in self._children(name, labels):
            _, points = self._split(samples, window_s, now)
            for t, v in points:
                vals.append(v)
                if last_t is None or t >= last_t:
                    last_t, last = t, v
        if not vals:
            return {"avg": None, "min": None, "max": None, "last": None,
                    "n": 0}
        return {"avg": sum(vals) / len(vals), "min": min(vals),
                "max": max(vals), "last": last, "n": len(vals)}

    def hist_window(self, name, window_s, labels=None, now=None):
        """Window delta of a histogram family: per-bucket delta counts
        (non-cumulative, +Inf last), delta sum/count, and the bucket
        ladder — summed across matching children (fleet merge). Resets
        (restarted worker) fall back to the post-reset snapshot, same
        rule as :meth:`rate`."""
        uppers = None
        agg = None
        d_sum = 0.0
        d_count = 0
        for _key, _kind, buckets, samples in self._children(name, labels):
            if buckets is None:
                continue
            baseline, points = self._split(samples, window_s, now)
            if not points:
                continue
            cum_end, sum_end, count_end = points[-1][1]
            if baseline is not None:
                cum_b, sum_b, count_b = baseline[1]
            else:
                cum_b, sum_b, count_b = (0,) * len(cum_end), 0.0, 0
            if count_end < count_b:  # reset: delta from zero
                cum_b, sum_b, count_b = (0,) * len(cum_end), 0.0, 0
            deltas = [e - b for e, b in zip(cum_end, cum_b)]
            # cumulative -> per-bucket
            per = [deltas[0]] + [deltas[i] - deltas[i - 1]
                                 for i in range(1, len(deltas))]
            if uppers is None:
                uppers = buckets
                agg = per
            elif buckets == uppers:
                agg = [a + p for a, p in zip(agg, per)]
            else:
                raise ValueError(
                    "hist_window(%r): children disagree on bucket "
                    "ladders — cannot merge %r vs %r"
                    % (name, buckets, uppers))
            d_sum += sum_end - sum_b
            d_count += count_end - count_b
        if uppers is None:
            return None
        return {"buckets": uppers, "counts": agg, "sum": d_sum,
                "count": d_count}

    def quantile(self, name, q, window_s, labels=None, now=None):
        """Bucket-delta ``q``-quantile (q in [0, 1]) over the trailing
        window — "p99 TTFT over the last minute", not since boot.
        None when the family has no samples in the window."""
        win = self.hist_window(name, window_s, labels=labels, now=now)
        if win is None or win["count"] <= 0:
            return None
        return _metrics.bucket_quantile(win["buckets"], win["counts"], q)

    # ------------------------------------------------------------- varz
    def varz(self, window_s, now):
        """One JSON-safe row per series with the windowed stats for its
        kind (the /varz payload body)."""
        from .promparse import labels_to_str

        series = {}
        with self._lock:
            keys = [(key, self._meta[key]) for key in sorted(self._rings)]
        for (name, labels), (kind, _buckets) in keys:
            disp = name + ("{%s}" % labels_to_str(labels) if labels else "")
            if kind == "counter":
                series[disp] = {
                    "kind": kind,
                    "rate_per_s": round(
                        self.rate(name, window_s, labels, now), 6),
                    "increase": round(
                        self.increase(name, window_s, labels, now), 6),
                }
            elif kind == "gauge":
                g = self.gauge_window(name, window_s, labels, now)
                series[disp] = {"kind": kind, **g}
            elif kind == "histogram":
                win = self.hist_window(name, window_s, labels, now)
                if win is None or win["count"] <= 0:
                    series[disp] = {"kind": kind, "count": 0}
                    continue
                series[disp] = {
                    "kind": kind,
                    "count": win["count"],
                    "rate_per_s": round(
                        win["count"] / float(window_s), 6),
                    "mean": round(win["sum"] / win["count"], 6),
                    "p50": self.quantile(name, 0.50, window_s, labels, now),
                    "p90": self.quantile(name, 0.90, window_s, labels, now),
                    "p99": self.quantile(name, 0.99, window_s, labels, now),
                }
        return series


# ------------------------------------------------------- pre-sample hooks
_hook_lock = threading.Lock()
_pre_sample = {}   # name -> zero-arg callable  # guarded-by: _hook_lock


def register_pre_sample(name, fn):
    """Run ``fn()`` just before every sampler snapshot — for owners of
    derived gauges (heartbeat AGES, queue occupancy computed from
    state) that must be refreshed at read time, not write time.
    Best-effort: a raising hook is dropped from that snapshot, never
    from the sampler."""
    with _hook_lock:
        _pre_sample[name] = fn


def unregister_pre_sample(name):
    with _hook_lock:
        _pre_sample.pop(name, None)


def _run_pre_sample_hooks():
    with _hook_lock:
        hooks = list(_pre_sample.values())
    for fn in hooks:
        try:
            fn()
        except Exception:
            pass


class TimeSeriesSampler:
    """Background sampler: registry -> :class:`SeriesStore` every
    ``interval_ms``. The clock is injectable (fake-clock tests drive
    :meth:`sample_once` by hand and never start the thread)."""

    def __init__(self, interval_ms=None, retain=None, clock=None):
        from ..config import get_flag

        self.interval_s = (get_flag("MXNET_OBS_TS_INTERVAL_MS")
                           if interval_ms is None
                           else float(interval_ms)) / 1e3
        retain = (get_flag("MXNET_OBS_TS_RETAIN") if retain is None
                  else retain)
        self._clock = clock if clock is not None else time.monotonic
        self.store = SeriesStore(retain)
        self._stop_ev = threading.Event()
        self._thread = None
        self._life = threading.Lock()   # serializes start()/stop()
        self.samples = 0                # snapshots taken (informational)
        self.last_cost_s = 0.0          # wall cost of the last snapshot

    def now(self):
        return self._clock()

    def sample_once(self, now=None):
        """One snapshot pass: pre-sample hooks, then the locked registry
        walk, appended at ``now``. Returns the row count."""
        if now is None:
            now = self._clock()
        t0 = time.perf_counter()
        _run_pre_sample_hooks()
        rows = _metrics.snapshot_values()
        self.store.append_rows(rows, now)
        self.samples += 1
        self.last_cost_s = time.perf_counter() - t0
        return len(rows)

    def _loop(self):
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:
                # the sampler is an observer: it must never take the
                # workload down, and one bad pass must not end the series
                pass

    def start(self):
        with self._life:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_ev.clear()
            self._thread = threading.Thread(
                target=self._loop, name="mxnet-obs-timeseries", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout=5):
        with self._life:
            thread, self._thread = self._thread, None
        self._stop_ev.set()
        if thread is not None:
            thread.join(timeout)

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    # windowed queries delegate to the store with this sampler's clock
    def rate(self, name, window_s, labels=None, now=None):
        return self.store.rate(name, window_s, labels,
                               self._clock() if now is None else now)

    def gauge_window(self, name, window_s, labels=None, now=None):
        return self.store.gauge_window(
            name, window_s, labels, self._clock() if now is None else now)

    def hist_window(self, name, window_s, labels=None, now=None):
        return self.store.hist_window(
            name, window_s, labels, self._clock() if now is None else now)

    def quantile(self, name, q, window_s, labels=None, now=None):
        return self.store.quantile(
            name, q, window_s, labels, self._clock() if now is None else now)

    def varz(self, window_s=60.0, now=None):
        now = self._clock() if now is None else now
        return {
            "window_s": float(window_s),
            "interval_ms": round(self.interval_s * 1e3, 3),
            "retain": self.store.retain,
            "samples": self.samples,
            "last_sample_cost_us": round(self.last_cost_s * 1e6, 1),
            "series": self.store.varz(window_s, now),
        }


# ------------------------------------------------------ module singleton
_lock = threading.Lock()
_sampler = None   # guarded-by: _lock


def start_sampler(interval_ms=None, retain=None, clock=None):
    """Start (or return) the process-wide sampler; idempotent. Registers
    the ``timeseries`` flight-recorder provider so crash dumps carry the
    recent windows. ``MXNET_OBS_TS_INTERVAL_MS=0`` disables startup
    entirely (returns None)."""
    global _sampler
    from ..config import get_flag

    with _lock:
        if _sampler is not None:
            return _sampler
        if interval_ms is None and get_flag("MXNET_OBS_TS_INTERVAL_MS") <= 0:
            return None
        sampler = TimeSeriesSampler(interval_ms=interval_ms, retain=retain,
                                    clock=clock)
        sampler.start()
        _sampler = sampler
    from . import flight_recorder

    flight_recorder.register_provider("timeseries", _provider)
    return _sampler


def stop_sampler():
    """Stop and discard the process-wide sampler (idempotent)."""
    global _sampler
    with _lock:
        sampler, _sampler = _sampler, None
    if sampler is not None:
        sampler.stop()


def get_sampler():
    with _lock:
        return _sampler


def _provider():
    sampler = get_sampler()
    if sampler is None:
        return None
    return sampler.varz(60.0)


def varz(window_s=60.0, now=None):
    """The ``/varz`` payload. A missing sampler is an explanation, not an
    error: the caller gets an answer either way."""
    sampler = get_sampler()
    if sampler is None:
        return {"error": "time-series sampler not running (call "
                         "timeseries.start_sampler() with "
                         "MXNET_OBS_TS_INTERVAL_MS > 0)"}
    return sampler.varz(window_s=window_s, now=now)
