"""SLO objectives as multi-window burn rates over the time-series plane.

Counterpart of ``mxnet_tpu/observability/slo_monitor.py``, plain Python.
An SLO ("p99 TTFT <= 250 ms", "availability >= 99.9%") is checkable only
against trailing windows; the multi-window burn rate fires when both a
SHORT (responsive) and a LONG (confirming) window burn the error budget
faster than the on-threshold, and clears only when the short window drops
below the off-threshold (hysteresis: a burn wobbling across one line
cannot flap the alert). Burn rate 1.0 spends the budget exactly as fast as
the SLO allows.

* :class:`LatencyObjective`: fraction ``q`` of requests within
  ``threshold``, from windowed bucket deltas
  (:meth:`~.timeseries.SeriesStore.hist_window`), linearly interpolated
  inside the bucket the threshold lands in.
* :class:`AvailabilityObjective`: fraction ``target`` of requests
  succeed, from reset-safe counter increases.

Evaluation is a pure function of the store, ``now`` and the alert's own
latch, so fake-clock tests drive the whole lifecycle. No traffic burns no
budget: every burn is 0.0 over an empty window. :class:`SLOMonitor`
bundles alerts for the autoscaler (serving/control/autoscale.py).
"""
from __future__ import annotations

__all__ = ["LatencyObjective", "AvailabilityObjective", "BurnRateAlert",
           "SLOMonitor", "DEFAULT_SHORT_S", "DEFAULT_LONG_S"]

# SRE-workbook-flavored defaults, scaled to serving-loop reality (an
# autoscaler reacting in hours is not reacting): 1-minute responsive
# window confirmed by a 10-minute window.
DEFAULT_SHORT_S = 60.0
DEFAULT_LONG_S = 600.0


def _fraction_within(win, threshold):
    """Fraction of a window's observations ≤ ``threshold``, linearly
    interpolated inside the bucket the threshold lands in (+Inf bucket
    observations count as over-threshold). ``win`` is a
    ``hist_window()`` result."""
    total = win["count"]
    if total <= 0:
        return 1.0
    uppers, counts = win["buckets"], win["counts"]
    cum = 0.0
    lo = min(0.0, uppers[0])
    for upper, cnt in zip(uppers, counts):
        if threshold < upper:
            frac = (threshold - lo) / (upper - lo) if upper > lo else 1.0
            return (cum + cnt * max(0.0, frac)) / total
        cum += cnt
        lo = upper
    return cum / total   # everything finite is within; +Inf bucket is not


class LatencyObjective:
    """``q`` of requests complete within ``threshold`` (histogram
    units): burn = (observed slow fraction) / (allowed slow fraction).
    """

    kind = "latency"

    def __init__(self, name, metric, threshold, q=0.99, labels=None):
        if not 0.0 < q < 1.0:
            raise ValueError("q must be in (0, 1), got %r" % (q,))
        self.name = name
        self.metric = metric
        self.threshold = float(threshold)
        self.q = float(q)
        self.labels = labels

    def burn(self, store, window_s, now):
        win = store.hist_window(self.metric, window_s, labels=self.labels,
                                now=now)
        if win is None or win["count"] <= 0:
            return 0.0
        bad = 1.0 - _fraction_within(win, self.threshold)
        return bad / (1.0 - self.q)

    def describe(self):
        return {"kind": self.kind, "metric": self.metric,
                "threshold": self.threshold, "q": self.q}


class AvailabilityObjective:
    """``target`` of requests succeed: burn = (error fraction) /
    (allowed error fraction), from reset-safe counter increases."""

    kind = "availability"

    def __init__(self, name, error_metric, total_metric, target=0.999,
                 labels=None):
        if not 0.0 < target < 1.0:
            raise ValueError("target must be in (0, 1), got %r"
                             % (target,))
        self.name = name
        self.error_metric = error_metric
        self.total_metric = total_metric
        self.target = float(target)
        self.labels = labels

    def burn(self, store, window_s, now):
        total = store.increase(self.total_metric, window_s,
                               labels=self.labels, now=now)
        if total <= 0:
            return 0.0
        errors = store.increase(self.error_metric, window_s,
                                labels=self.labels, now=now)
        return (errors / total) / (1.0 - self.target)

    def describe(self):
        return {"kind": self.kind, "error_metric": self.error_metric,
                "total_metric": self.total_metric, "target": self.target}


class BurnRateAlert:
    """One objective evaluated over short+long windows with a firing
    latch.

    Fires when BOTH windows burn above ``on_threshold`` (short = is it
    happening now, long = has it been happening long enough to matter);
    clears when the SHORT window drops below ``off_threshold``. The gap
    between on and off is the hysteresis band — a burn rate wobbling
    across one line cannot flap the alert, which in turn is what keeps
    the autoscaler from oscillating.
    """

    def __init__(self, objective, short_s=DEFAULT_SHORT_S,
                 long_s=DEFAULT_LONG_S, on_threshold=2.0,
                 off_threshold=1.0):
        if off_threshold > on_threshold:
            raise ValueError(
                "off_threshold %g > on_threshold %g inverts the "
                "hysteresis band" % (off_threshold, on_threshold))
        self.objective = objective
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.on_threshold = float(on_threshold)
        self.off_threshold = float(off_threshold)
        self.firing = False
        self.fired_at = None
        self.transitions = 0

    def evaluate(self, store, now):
        """Advance the latch against the store at ``now``; returns the
        full evaluation row (burns, thresholds, firing)."""
        short = self.objective.burn(store, self.short_s, now)
        long_ = self.objective.burn(store, self.long_s, now)
        if not self.firing:
            if short > self.on_threshold and long_ > self.on_threshold:
                self.firing = True
                self.fired_at = now
                self.transitions += 1
        else:
            if short < self.off_threshold:
                self.firing = False
                self.fired_at = None
                self.transitions += 1
        return {
            "name": self.objective.name,
            "objective": self.objective.describe(),
            "burn_short": round(short, 4),
            "burn_long": round(long_, 4),
            "short_s": self.short_s,
            "long_s": self.long_s,
            "on_threshold": self.on_threshold,
            "off_threshold": self.off_threshold,
            "firing": self.firing,
            "firing_for_s": None if self.fired_at is None
            else round(now - self.fired_at, 3),
        }


class SLOMonitor:
    """A bundle of burn-rate alerts over one series store — the view the
    autoscaler consumes."""

    def __init__(self, store, alerts=()):
        self.store = store
        self.alerts = list(alerts)

    def add(self, alert):
        self.alerts.append(alert)
        return alert

    def evaluate(self, now):
        return [a.evaluate(self.store, now) for a in self.alerts]

    def any_firing(self):
        return any(a.firing for a in self.alerts)

    def firing_names(self):
        return [a.objective.name for a in self.alerts if a.firing]
