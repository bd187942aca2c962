"""Fleet aggregation: N workers' ``/metrics`` endpoints merged into one
queryable time-series view.

Counterpart of ``mxnet_tpu/observability/fleet.py``, stdlib only. Its
training-step views over the workers' ``/statusz`` (``fleet_steps`` /
``fleet_timeline``) need the cross-rank merge of ``dist_trace``, which
waits for the port's multi-card slice.

A serving fleet is not a process: "what is the p99 TTFT" is a question
about the *merged* latency distribution, "is rank 3 behind" is a
question about one worker's series relative to the others, and "how
many workers are alive" is a question no single worker can answer. The
:class:`FleetAggregator` closes that gap with the same two pieces the
local plane uses — the exposition contract and the window algebra:

* each scrape interval it fetches every worker's ``/metrics``, parses
  the text exposition with :mod:`.promparse` (the same parser the
  round-trip tests run against the renderer), reassembles histogram
  families from their ``_bucket``/``_sum``/``_count`` sample lines, and
  appends everything into a :class:`~.timeseries.SeriesStore` with a
  ``worker`` label added to each child;
* fleet-level queries fall out of the store's label-aggregation rules:
  ``quantile(name, q, window)`` with no label filter sums the
  per-worker bucket deltas elementwise — bit-exact, no resampling —
  and ``rate()`` sums per-worker reset-safe rates, so one worker's
  restart can never drive a fleet rate negative;
* a worker that stops answering is counted in consecutive failures:
  ``MXNET_OBS_FLEET_STALE_SCRAPES`` misses flag it ``stale``,
  ``MXNET_OBS_FLEET_DEAD_SCRAPES`` flag it ``dead``. Either way nothing
  more is appended, so its series go STALE in windowed queries (gauge
  windows report ``n=0``) instead of flat-lining at the last value —
  and the per-worker ``fleet.worker_up`` series (1/0 per scrape) makes
  availability itself a windowed rate.

Everything is injectable for tests: the fetch function (no sockets
needed), the clock (fake-clock staleness), the thresholds.
"""
from __future__ import annotations

import threading
import time

from . import promparse
from .timeseries import SeriesStore

__all__ = ["FleetAggregator", "WorkerState"]


def _http_fetch(url, timeout=5.0):
    from urllib.request import urlopen

    with urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace")


class WorkerState:
    """Scrape bookkeeping for one worker (guarded by the aggregator's
    lock)."""

    __slots__ = ("name", "url", "consecutive_failures", "scrapes",
                 "failures", "last_success_t", "last_error")

    def __init__(self, name, url):
        self.name = name
        self.url = url
        self.consecutive_failures = 0
        self.scrapes = 0
        self.failures = 0
        self.last_success_t = None
        self.last_error = None

    def status(self, stale_after, dead_after):
        if self.consecutive_failures >= dead_after:
            return "dead"
        if self.consecutive_failures >= stale_after:
            return "stale"
        return "ok"


def _families(parsed):
    """Regroup one parsed scrape into ``snapshot_values()``-shaped rows:
    ``(family, labels, kind, buckets, payload)`` with histogram children
    reassembled from their ``_bucket``/``_sum``/``_count`` lines."""
    rows = []
    hist_families = {name for name, kind in parsed.types.items()
                     if kind == "histogram"}
    # scalar families (counters/gauges) are keyed by their own name
    for name, children in parsed.samples.items():
        kind = parsed.types.get(name)
        if kind in ("counter", "gauge"):
            for labels, value in children.items():
                rows.append((name, labels, kind, None, value))
    # histogram families span three sample names
    for fam in hist_families:
        buckets_by_child = {}   # child labels (sans le) -> {le: count}
        for labels, value in parsed.samples.get(fam + "_bucket",
                                                {}).items():
            le = dict(labels)["le"]
            child = tuple(kv for kv in labels if kv[0] != "le")
            buckets_by_child.setdefault(child, {})[le] = value
        sums = parsed.samples.get(fam + "_sum", {})
        counts = parsed.samples.get(fam + "_count", {})
        for child, by_le in buckets_by_child.items():
            # sort by the parsed bound, not the string — the renderer's
            # float formatting must not be round-tripped by eye
            entries = sorted((float(le), int(cnt))
                             for le, cnt in by_le.items())
            finite = tuple(b for b, _ in entries if b != float("inf"))
            cum = tuple(cnt for _, cnt in entries)
            rows.append((fam, child, "histogram", finite,
                         (cum, float(sums.get(child, 0.0)),
                          int(counts.get(child, 0)))))
    return rows


class FleetAggregator:
    """Scrape-and-merge controller over N worker exposition endpoints.

    ``workers``: ``{name: url}`` (or an iterable of urls, named by
    index). ``fetch(url) -> text`` and ``clock`` are injectable; the
    defaults are urllib + ``time.monotonic``. Windowed fleet queries
    (``rate``/``gauge_window``/``quantile``/``hist_window``) delegate to
    the shared :class:`SeriesStore` — pass ``labels`` to pin one worker,
    omit it to merge the fleet.
    """

    def __init__(self, workers, interval_ms=None, stale_after=None,
                 dead_after=None, clock=None, fetch=None, retain=None):
        from ..config import get_flag

        if isinstance(workers, dict):
            items = list(workers.items())
        else:
            items = [("worker%d" % i, url)
                     for i, url in enumerate(workers)]
        self.interval_s = (get_flag("MXNET_OBS_FLEET_INTERVAL_MS")
                           if interval_ms is None
                           else float(interval_ms)) / 1e3
        self.stale_after = int(
            get_flag("MXNET_OBS_FLEET_STALE_SCRAPES")
            if stale_after is None else stale_after)
        self.dead_after = int(
            get_flag("MXNET_OBS_FLEET_DEAD_SCRAPES")
            if dead_after is None else dead_after)
        self._clock = clock if clock is not None else time.monotonic
        self._fetch = fetch if fetch is not None else _http_fetch
        self.store = SeriesStore(
            get_flag("MXNET_OBS_TS_RETAIN") if retain is None else retain)
        self._lock = threading.Lock()
        self._workers = {n: WorkerState(n, u)
                         for n, u in items}  # guarded-by: self._lock
        self.scrapes = 0
        self._stop_ev = threading.Event()
        self._thread = None
        self._life = threading.Lock()

    def now(self):
        return self._clock()

    # ---------------------------------------------------------- scraping
    def scrape_once(self, now=None):
        """One pass over every worker; returns ``{name: status}``.

        A failed fetch/parse appends NOTHING for that worker (its series
        age out of windows naturally) and bumps its failure streak; a
        success resets the streak and appends every family with the
        ``worker`` label stitched in, plus the ``fleet.worker_up``
        sample (1 ok / 0 down) that availability windows read.
        """
        if now is None:
            now = self._clock()
        with self._lock:
            workers = list(self._workers.values())
        out = {}
        for w in workers:
            try:
                rows = _families(promparse.parse_text(self._fetch(w.url)))
            except Exception as err:
                with self._lock:
                    w.scrapes += 1
                    w.failures += 1
                    w.consecutive_failures += 1
                    w.last_error = repr(err)
                up = 0.0
            else:
                with self._lock:
                    w.scrapes += 1
                    w.consecutive_failures = 0
                    w.last_success_t = now
                    w.last_error = None
                for fam, labels, kind, buckets, payload in rows:
                    merged = tuple(sorted(
                        dict(labels, worker=w.name).items()))
                    self.store.append(fam, merged, kind, buckets,
                                      payload, now)
                up = 1.0
            self.store.append("fleet.worker_up",
                              (("worker", w.name),), "gauge", None, up,
                              now)
            out[w.name] = w.status(self.stale_after, self.dead_after)
        with self._lock:
            self.scrapes += 1
        return out

    # ------------------------------------------------------------ status
    def worker_status(self, now=None):
        """Per-worker scrape health: status (ok/stale/dead), failure
        streak, seconds since last good scrape."""
        if now is None:
            now = self._clock()
        with self._lock:
            return {
                w.name: {
                    "url": w.url,
                    "status": w.status(self.stale_after, self.dead_after),
                    "consecutive_failures": w.consecutive_failures,
                    "scrapes": w.scrapes,
                    "failures": w.failures,
                    "last_success_age_s":
                        None if w.last_success_t is None
                        else round(now - w.last_success_t, 3),
                    "last_error": w.last_error,
                }
                for w in self._workers.values()
            }

    def alive_workers(self):
        """Names of workers not currently dead."""
        with self._lock:
            return [w.name for w in self._workers.values()
                    if w.status(self.stale_after, self.dead_after)
                    != "dead"]

    def fleet_status(self, window_s=60.0, now=None):
        """The fleet brief: worker table + merged varz over the window
        (flight-recorder / tooling payload)."""
        if now is None:
            now = self._clock()
        return {
            "interval_ms": round(self.interval_s * 1e3, 3),
            "scrapes": self.scrapes,
            "stale_after": self.stale_after,
            "dead_after": self.dead_after,
            "workers": self.worker_status(now),
            "series": self.store.varz(window_s, now),
        }

    # --------------------------------------------- windowed fleet queries
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

    # --------------------------------------------------------- lifecycle
    def _loop(self):
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:
                pass  # an observer never takes anything down

    def start(self):
        with self._life:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_ev.clear()
            self._thread = threading.Thread(
                target=self._loop, name="mxnet-obs-fleet", daemon=True)
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
