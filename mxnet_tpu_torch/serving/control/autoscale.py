"""Metrics-driven replica autoscaling: the consumer that acts on the
time-series plane.

Counterpart of ``mxnet_tpu/serving/control/autoscale.py``, plain Python.
Policy is split from actuation so the hard part is a pure function:

* :class:`AutoscalePolicy.decide(series, now) <AutoscalePolicy>` reads
  only the time-series view (queue-depth window averages, the
  ``serving.replicas_configured`` / ``serving.replicas_available`` gauges
  the serving engine exports, and optionally an
  :class:`~...observability.slo_monitor.SLOMonitor`'s burn-rate alerts)
  and returns a :class:`ScaleDecision`. A fake-clock test hand-feeds a
  :class:`~...observability.timeseries.SeriesStore` and asserts the exact
  decision sequence, also under fault injection (a killed replica opens
  the breaker, ``replicas_available`` drops below
  ``replicas_configured``, and the decision flips to scale-up).
* :class:`Autoscaler` binds a policy to its actuator,
  ``InferenceServer.resize_replicas(n)``, and applies decisions on a
  cadence (or on demand via :meth:`Autoscaler.step`).

Anti-flap discipline: **hysteresis** (scale-up triggers are instantaneous
reads of a bad state, scale-down needs the queue under ``queue_low`` for
the whole window with no alert firing), **cooldown**
(``MXNET_AUTOSCALE_COOLDOWN_MS`` between actions; decisions are still
computed and reported) and **clamping** to [``MXNET_AUTOSCALE_MIN``,
``MXNET_AUTOSCALE_MAX``].
"""
from __future__ import annotations

import collections
import threading
import time

__all__ = ["ScaleDecision", "AutoscalePolicy", "Autoscaler"]

# replicas: the proposed count; action: "up" | "down" | "hold";
# applied: set by Autoscaler.step (False on hold/cooldown); reason:
# human-readable trigger trail for /statusz and the smoke's assertions
ScaleDecision = collections.namedtuple(
    "ScaleDecision", ["replicas", "action", "reason", "applied"])


class AutoscalePolicy:
    """Pure scaling policy over a windowed series view.

    ``series`` in :meth:`decide` is anything with the
    :class:`SeriesStore` query surface (``gauge_window``; the store
    itself or a :class:`TimeSeriesSampler`). Thresholds are in queue ROWS (the
    ``serving.queue_depth`` gauge's unit).

    The decision table, first match wins:

    1. fewer replicas available than configured (breaker open on some)
       AND an SLO alert firing → ``up`` (replace lost capacity);
    2. SLO burn alert firing → ``up``;
    3. queue window-average above ``queue_high`` → ``up``;
    4. queue under ``queue_low`` for the whole window, no alert firing,
       and at least one window elapsed since the last action → ``down``;
    5. otherwise → ``hold``.

    Scale-up steps by ``step`` (default 1) from the CONFIGURED count;
    scale-down by 1 — capacity comes fast, leaves slowly.
    """

    def __init__(self, queue_high=64.0, queue_low=4.0, window_s=30.0,
                 min_replicas=None, max_replicas=None, step=1,
                 slo_monitor=None, queue_metric="serving.queue_depth",
                 configured_metric="serving.replicas_configured",
                 available_metric="serving.replicas_available"):
        from ...config import get_flag

        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        if self.queue_low > self.queue_high:
            raise ValueError("queue_low %g > queue_high %g inverts the "
                             "hysteresis band"
                             % (self.queue_low, self.queue_high))
        self.window_s = float(window_s)
        self.min_replicas = int(get_flag("MXNET_AUTOSCALE_MIN")
                                if min_replicas is None else min_replicas)
        self.max_replicas = int(get_flag("MXNET_AUTOSCALE_MAX")
                                if max_replicas is None else max_replicas)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                "need 1 <= min_replicas (%d) <= max_replicas (%d)"
                % (self.min_replicas, self.max_replicas))
        self.step = int(step)
        self.slo_monitor = slo_monitor
        self.queue_metric = queue_metric
        self.configured_metric = configured_metric
        self.available_metric = available_metric

    def _clamp(self, n):
        return max(self.min_replicas, min(self.max_replicas, int(n)))

    def decide(self, series, now, last_action_t=None):
        """One decision against ``series`` at ``now`` (``applied`` is
        always False here — the :class:`Autoscaler` sets it when it
        acts). ``last_action_t`` gates rule 4's settling requirement."""
        win = self.window_s
        queue = series.gauge_window(self.queue_metric, win, now=now)
        conf = series.gauge_window(self.configured_metric, win, now=now)
        avail = series.gauge_window(self.available_metric, win, now=now)
        configured = conf["last"] if conf["n"] else None
        available = avail["last"] if avail["n"] else None
        if self.slo_monitor is not None:
            self.slo_monitor.evaluate(now)
            firing = self.slo_monitor.firing_names()
        else:
            firing = []

        if configured is None:
            # no engine telemetry in the window: refuse to guess
            return ScaleDecision(self.min_replicas, "hold",
                                 "no replica telemetry in window", False)
        configured = int(configured)

        if available is not None and available < configured and firing:
            return ScaleDecision(
                self._clamp(configured + self.step), "up",
                "replicas lost (%d/%d available) with SLO firing: %s"
                % (int(available), configured, ",".join(firing)), False)
        if firing:
            return ScaleDecision(
                self._clamp(configured + self.step), "up",
                "SLO burn firing: %s" % ",".join(firing), False)
        if queue["n"] and queue["avg"] > self.queue_high:
            return ScaleDecision(
                self._clamp(configured + self.step), "up",
                "queue avg %.1f > high-water %.1f over %gs"
                % (queue["avg"], self.queue_high, win), False)
        settled = (last_action_t is None
                   or now - last_action_t >= win)
        if (settled and queue["n"]
                and queue["max"] < self.queue_low
                and configured > self.min_replicas):
            return ScaleDecision(
                self._clamp(configured - 1), "down",
                "queue max %.1f < low-water %.1f over the whole %gs "
                "window" % (queue["max"], self.queue_low, win), False)
        return ScaleDecision(configured, "hold", "within band", False)


class Autoscaler:
    """Policy + actuator + cadence: closes the loop onto
    ``server.resize_replicas``.

    ``clock`` is injectable; :meth:`step` is the whole control loop for
    one tick (evaluate → cooldown gate → act), so tests drive it with a
    fake clock and the optional background thread is nothing but
    ``step()`` on an interval.
    """

    def __init__(self, policy, series, resize, cooldown_ms=None,
                 interval_s=None, clock=None):
        from ...config import get_flag

        self.policy = policy
        self.series = series
        self._resize = resize          # callable: n -> None
        self.cooldown_s = (get_flag("MXNET_AUTOSCALE_COOLDOWN_MS")
                           if cooldown_ms is None
                           else float(cooldown_ms)) / 1e3
        self.interval_s = (float(interval_s) if interval_s is not None
                           else max(1.0, policy.window_s / 4))
        self._clock = clock if clock is not None else time.monotonic
        self.last_action_t = None
        self.last_decision = None
        self.history = collections.deque(maxlen=64)
        self._stop_ev = threading.Event()
        self._thread = None  # guarded-by: self._life
        self._life = threading.Lock()

    @classmethod
    def for_server(cls, policy, series, server, **kwargs):
        """Bind to an :class:`InferenceServer`'s ``resize_replicas``."""
        return cls(policy, series, server.resize_replicas, **kwargs)

    def step(self, now=None):
        """One control tick; returns the :class:`ScaleDecision` (with
        ``applied`` reflecting whether ``resize`` ran)."""
        from ...observability import metrics

        if now is None:
            now = self._clock()
        decision = self.policy.decide(self.series, now,
                                      last_action_t=self.last_action_t)
        applied = False
        if decision.action != "hold":
            cooling = (self.last_action_t is not None
                       and now - self.last_action_t < self.cooldown_s)
            if cooling:
                decision = decision._replace(
                    reason=decision.reason + " [cooldown: %.1fs left]"
                    % (self.cooldown_s - (now - self.last_action_t)))
            else:
                self._resize(decision.replicas)
                self.last_action_t = now
                applied = True
                metrics.counter("autoscale.actions").inc()
                metrics.counter("autoscale.%s" % decision.action).inc()
        decision = decision._replace(applied=applied)
        self.last_decision = decision
        self.history.append((now, decision))
        return decision

    def state(self):
        """Flight-recorder/status view of the control loop."""
        d = self.last_decision
        return {
            "cooldown_s": self.cooldown_s,
            "interval_s": self.interval_s,
            "last_action_age_s":
                None if self.last_action_t is None
                else round(self._clock() - self.last_action_t, 3),
            "last_decision": None if d is None else d._asdict(),
            "decisions": len(self.history),
        }

    # --------------------------------------------------------- lifecycle
    def _loop(self):
        while not self._stop_ev.wait(self.interval_s):
            try:
                self.step()
            except Exception:
                pass  # the controller must outlive a bad tick

    def start(self):
        with self._life:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop_ev.clear()
            self._thread = threading.Thread(
                target=self._loop, name="mxnet-autoscale", daemon=True)
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
