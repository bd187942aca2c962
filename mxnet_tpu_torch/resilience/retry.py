"""One retry primitive for every transient-failure path.

Counterpart of ``mxnet_tpu/resilience/retry.py``: exponential backoff with
jitter, capped by both an attempt budget and a wall-clock deadline, with
per-policy telemetry counters (``retry.<name>.retries`` /
``retry.<name>.exhausted``) so a run's retry pressure shows in
``dump_metrics()`` and flight-recorder dumps. The defaults are the same
``MXNET_RETRY_*`` flags.

The deadline bounds *scheduling* (no new attempt starts past it); it
never interrupts an attempt already in flight — a blocked recv is the
transport layer's timeout to enforce.
"""
from __future__ import annotations

import random as _pyrandom
import time

from ..base import MXNetError

__all__ = ["RetryPolicy", "RetryExhaustedError", "call"]


class RetryExhaustedError(MXNetError):
    """All retry attempts failed (or the deadline passed). Carries the
    attempt count, elapsed wall time, and the last underlying error."""

    def __init__(self, name, attempts, elapsed_s, last_error):
        self.name = name
        self.attempts = attempts
        self.elapsed_s = elapsed_s
        self.last_error = last_error
        super().__init__(
            "%s failed after %d attempt(s) over %.2fs: %s: %s"
            % (name, attempts, elapsed_s,
               type(last_error).__name__, last_error))


class RetryPolicy:
    """Backoff/budget knobs, defaulting from the ``MXNET_RETRY_*`` flags:

    * ``max_attempts`` — total tries including the first
      (``MXNET_RETRY_MAX``, default 3);
    * ``base_delay_ms`` — first backoff (``MXNET_RETRY_BASE_MS``, 10),
      doubling per retry up to ``max_delay_ms``
      (``MXNET_RETRY_MAX_MS``, 2000);
    * ``deadline_ms`` — wall-clock cap across all attempts
      (``MXNET_RETRY_DEADLINE_MS``, 30000; 0 = unbounded);
    * ``jitter`` — each delay is scaled by a uniform factor in
      ``[1-jitter, 1]`` so synchronized clients desynchronize.
    """

    __slots__ = ("max_attempts", "base_delay_s", "max_delay_s",
                 "deadline_s", "jitter")

    def __init__(self, max_attempts=None, base_delay_ms=None,
                 max_delay_ms=None, deadline_ms=None, jitter=0.25):
        from ..config import get_flag

        self.max_attempts = max(1, int(
            get_flag("MXNET_RETRY_MAX") if max_attempts is None
            else max_attempts))
        self.base_delay_s = (get_flag("MXNET_RETRY_BASE_MS")
                             if base_delay_ms is None
                             else float(base_delay_ms)) / 1e3
        self.max_delay_s = (get_flag("MXNET_RETRY_MAX_MS")
                            if max_delay_ms is None
                            else float(max_delay_ms)) / 1e3
        self.deadline_s = (get_flag("MXNET_RETRY_DEADLINE_MS")
                           if deadline_ms is None
                           else float(deadline_ms)) / 1e3
        self.jitter = float(jitter)

    def delay_s(self, retry_index):
        """Backoff before retry #retry_index (1-based)."""
        d = min(self.max_delay_s,
                self.base_delay_s * (2 ** (retry_index - 1)))
        if self.jitter > 0:
            d *= 1.0 - self.jitter * _pyrandom.random()
        return max(0.0, d)


def call(fn, policy=None, name="op", retry_on=(ConnectionError, OSError),
         on_retry=None):
    """Run ``fn()`` under ``policy``, retrying on ``retry_on`` errors.

    ``on_retry(err, attempt)`` runs between attempts (e.g. a reconnect);
    its own exceptions are swallowed — the next attempt failing fast is
    the loud path. Exhaustion raises :class:`RetryExhaustedError` chained
    to the last underlying error.
    """
    from ..observability import metrics

    if policy is None:
        policy = RetryPolicy()
    start = time.monotonic()
    attempt = 1
    while True:
        try:
            return fn()
        except retry_on as err:
            elapsed = time.monotonic() - start
            out_of_budget = (attempt >= policy.max_attempts
                             or (policy.deadline_s > 0
                                 and elapsed >= policy.deadline_s))
            if out_of_budget:
                metrics.counter("retry.%s.exhausted" % name).inc()
                raise RetryExhaustedError(name, attempt, elapsed, err) \
                    from err
            metrics.counter("retry.%s.retries" % name).inc()
            if on_retry is not None:
                try:
                    on_retry(err, attempt)
                except Exception:
                    pass  # reconnect failed: next attempt fails loudly
            time.sleep(policy.delay_s(attempt))
            attempt += 1
