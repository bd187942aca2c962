"""Process-wide metrics registry: counters, gauges, histograms.

Counterpart of ``mxnet_tpu/observability/metrics.py``, whole: the same
instruments, registry, label rules and Prometheus text, so the same series
render to the same ``dump_metrics()`` text in both packages. The JAX
package's retrace-cause tail (its compile hooks) has no counterpart: the
port traces no programs, so ``dump_metrics`` appends no comments.

Design rules:

* **Zero-overhead when off.** The master switch is the
  ``MXNET_TELEMETRY`` flag (config.py). While disabled, the accessor
  functions return one shared no-op instrument whose recording methods
  are empty — a disabled ``counter("x").inc()`` costs one dict lookup
  and one no-op call.
* **Instruments are process-wide and named.** ``counter("serving.requests")``
  returns the same object from anywhere; names are dotted lowercase.
* **Exposition is Prometheus text format.** :func:`dump_metrics` renders
  every instrument in the standard ``# HELP`` / ``# TYPE`` / sample-line
  format (dots become underscores), with label values escaped per the
  exposition spec, served under :data:`PROM_CONTENT_TYPE`.
* **Labels are constant per instrument.** ``counter(name,
  labels={"engine": "serving"})`` registers one child per label set,
  rendered as ``name{engine="serving"}``. Dynamic (per-observation)
  labels are deliberately unsupported: a label per request would make
  cardinality a function of traffic.
"""
from __future__ import annotations

import math
import threading

__all__ = ["counter", "gauge", "histogram", "dump_metrics", "reset_metrics",
           "enabled", "set_enabled", "get_value", "all_instruments",
           "snapshot_values", "unregister", "unregister_on_collect",
           "percentile", "bucket_quantile", "PROM_CONTENT_TYPE"]

# the content type a compliant scrape endpoint must declare for this
# text format
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_lock = threading.Lock()
_registry = {}  # name -> instrument  # guarded-by: _lock


def _read_flag():
    from ..config import get_flag

    return bool(get_flag("MXNET_TELEMETRY"))


_enabled = None  # resolved lazily so config/env ordering doesn't matter


def enabled():
    """Is telemetry recording on? (MXNET_TELEMETRY flag, overridable at
    runtime with :func:`set_enabled`.)"""
    global _enabled
    if _enabled is None:
        _enabled = _read_flag()
    return _enabled


def set_enabled(on):
    """Programmatic master switch (also flips the config flag so the two
    stay consistent)."""
    global _enabled
    _enabled = bool(on)
    from ..config import set_flag

    set_flag("MXNET_TELEMETRY", 1 if on else 0)


class Counter:
    """Monotonically increasing count (requests, batches, captures)."""

    kind = "counter"
    __slots__ = ("name", "labels", "help", "_value")

    def __init__(self, name, labels=(), help=None):
        self.name = name
        self.labels = labels
        self.help = help
        self._value = 0

    def inc(self, n=1):
        # mutators take the module lock: recording threads (dispatchers,
        # submitters) race each other and dump_metrics;
        # += alone loses increments at bytecode preemption points
        with _lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _reset(self):
        self._value = 0

    def _render(self, out, pname, lbl):
        out.append("%s%s %s" % (pname, _label_block(lbl),
                                _fmt(self._value)))


class Gauge:
    """Point-in-time value (queue depth, live replicas); ``set_max`` keeps
    a high-watermark."""

    kind = "gauge"
    __slots__ = ("name", "labels", "help", "_value")

    def __init__(self, name, labels=(), help=None):
        self.name = name
        self.labels = labels
        self.help = help
        self._value = 0

    def set(self, v):
        with _lock:
            self._value = v

    def set_max(self, v):
        with _lock:
            if v > self._value:
                self._value = v

    @property
    def value(self):
        return self._value

    def _reset(self):
        self._value = 0

    def _render(self, out, pname, lbl):
        out.append("%s%s %s" % (pname, _label_block(lbl),
                                _fmt(self._value)))


# 1-2-5 decade ladder: wide enough for µs dispatch latencies and
# multi-second compile times in the same instrument family
_DEFAULT_BUCKETS = tuple(
    m * (10.0 ** e) for e in range(-2, 7) for m in (1, 2, 5))


class Histogram:
    """Distribution with Prometheus cumulative buckets + sum/count/min/max."""

    kind = "histogram"
    __slots__ = ("name", "labels", "help", "buckets", "_counts", "_sum",
                 "_count", "_min", "_max", "_nonfinite")

    def __init__(self, name, buckets=_DEFAULT_BUCKETS, labels=(),
                 help=None):
        self.name = name
        self.labels = labels
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._nonfinite = 0

    def observe(self, v):
        v = float(v)
        if not math.isfinite(v):
            # a single NaN observation would poison _sum (and every
            # later rendered _sum line) forever; Inf would do the same
            # to _sum/_max — clamp non-finite observations into the
            # +Inf bucket plus a dedicated dropped count instead
            with _lock:
                self._counts[-1] += 1
                self._count += 1
                self._nonfinite += 1
            return
        # linear scan is fine: observe() sits behind enabled() guards and
        # the ladder is ~27 entries; bisect would win nothing measurable
        i = 0
        for i, b in enumerate(self.buckets):
            if v <= b:
                break
        else:
            i = len(self.buckets)
        with _lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    @property
    def mean(self):
        # over the FINITE observations: _sum excludes the clamped
        # NaN/Inf ones, so the denominator must too
        n = self._count - self._nonfinite
        return self._sum / n if n else 0.0

    @property
    def min(self):
        # finite observations only: _min/_max never see the clamped
        # NaN/Inf ones, so the guard must not count them either
        return self._min if self._count - self._nonfinite else 0.0

    @property
    def max(self):
        return self._max if self._count - self._nonfinite else 0.0

    @property
    def nonfinite(self):
        """Observations dropped into the +Inf bucket for being NaN/Inf."""
        return self._nonfinite

    def quantile(self, q):
        """Estimated ``q``-quantile (q in [0, 1]) of everything observed
        since boot, from the bucket counts (see :func:`bucket_quantile`
        for the interpolation rule)."""
        with _lock:
            counts = list(self._counts)
        return bucket_quantile(self.buckets, counts, q)

    def _reset(self):
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._nonfinite = 0

    def _render(self, out, pname, lbl):
        pre = lbl + "," if lbl else ""
        cum = 0
        for b, c in zip(self.buckets, self._counts):
            cum += c
            out.append('%s_bucket{%sle="%s"} %d' % (pname, pre, _fmt(b),
                                                    cum))
        cum += self._counts[-1]
        out.append('%s_bucket{%sle="+Inf"} %d' % (pname, pre, cum))
        out.append("%s_sum%s %s" % (pname, _label_block(lbl),
                                    _fmt(self._sum)))
        out.append("%s_count%s %d" % (pname, _label_block(lbl),
                                      self._count))
        if self._nonfinite:
            out.append("%s_nonfinite%s %d" % (pname, _label_block(lbl),
                                              self._nonfinite))


class _Noop:
    """Shared do-nothing instrument returned while telemetry is off."""

    kind = "noop"
    name = "noop"
    value = 0
    count = 0
    sum = 0.0
    mean = 0.0
    min = 0.0
    max = 0.0
    __slots__ = ()

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def set_max(self, v):
        pass

    def observe(self, v):
        pass


NOOP = _Noop()


def _canon_labels(labels):
    """Canonical constant-label tuple: sorted ((key, str(value)), ...)."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _key(name, labels):
    """Registry key: one instrument per (name, label set). Built from
    the repr of the canonical tuple, NOT a joined string — a joined
    'k=v,k2=v2' would let crafted values collide distinct label sets
    onto one instrument (x='1,y=2' vs {x: '1', y: '2'})."""
    canon = _canon_labels(labels)
    if not canon:
        return name
    return "%s|%r" % (name, canon)


def _valid_label_name(k):
    # Prometheus label-name charset [a-zA-Z_][a-zA-Z0-9_]*: one illegal
    # key (a dotted 'kv.dtype', a non-ASCII letter — str.isalpha alone
    # would accept those) aborts the ENTIRE scrape at parse time
    return bool(k) and k.isascii() and (k[0].isalpha() or k[0] == "_") \
        and all(c.isalnum() or c == "_" for c in k)


def _get(name, cls, labels=None, help=None, **kwargs):
    key = _key(name, labels)
    inst = _registry.get(key)
    if inst is None:
        with _lock:
            inst = _registry.get(key)
            if inst is None:
                canon = _canon_labels(labels)
                # creation-time validation (never on the hot accessor
                # path): label names must be legal...
                for k, _v in canon:
                    if not _valid_label_name(k):
                        raise ValueError(
                            "metric %r: illegal label name %r (must "
                            "match [a-zA-Z_][a-zA-Z0-9_]*)" % (name, k))
                inst = cls(name, labels=canon, help=help, **kwargs)
                # ...one kind per metric FAMILY (mixed kinds would emit
                # contradictory # TYPE lines), and histogram children
                # of one family must share a bucket ladder (mismatched
                # le sets silently break sum-by-le aggregation)
                for other in _registry.values():
                    if other.name != name:
                        continue
                    if other.kind != cls.kind:
                        raise TypeError(
                            "metric %r is a %s, not a %s"
                            % (name, other.kind, cls.kind))
                    if (isinstance(other, Histogram)
                            and other.buckets != inst.buckets):
                        raise ValueError(
                            "histogram %r already exists with different "
                            "buckets (label children of one family must "
                            "share a ladder)" % (name,))
                _registry[key] = inst
    elif not isinstance(inst, cls):
        raise TypeError("metric %r is a %s, not a %s"
                        % (name, inst.kind, cls.kind))
    if help and not inst.help:
        inst.help = help
    return inst


def counter(name, labels=None, help=None):
    """Fetch-or-create the named counter (NOOP while telemetry is off).
    ``labels``: constant labels identifying this child (one instrument
    per label set); ``help``: one-line # HELP text for the family."""
    if not enabled():
        return NOOP
    return _get(name, Counter, labels=labels, help=help)


def gauge(name, labels=None, help=None):
    """Fetch-or-create the named gauge (NOOP while telemetry is off)."""
    if not enabled():
        return NOOP
    return _get(name, Gauge, labels=labels, help=help)


def histogram(name, buckets=None, labels=None, help=None):
    """Fetch-or-create the named histogram (NOOP while telemetry is off).

    Explicitly requested buckets must match an existing instrument's —
    silently discarding them would leave the caller believing their
    ladder is in effect."""
    if not enabled():
        return NOOP
    if buckets is None:
        return _get(name, Histogram, labels=labels, help=help)
    inst = _get(name, Histogram, buckets=buckets, labels=labels, help=help)
    if inst.buckets != tuple(sorted(buckets)):
        raise ValueError(
            "histogram %r already exists with different buckets" % (name,))
    return inst


def get_value(name, default=None, labels=None):
    """Read a metric's scalar (counter/gauge value, histogram count)
    without creating it."""
    inst = _registry.get(_key(name, labels))
    if inst is None:
        return default
    return inst.count if isinstance(inst, Histogram) else inst.value


def all_instruments():
    """Snapshot of the registry ({name: instrument}).

    Copied under the registry lock: an unlocked ``dict(_registry)`` can
    raise "dictionary changed size during iteration" when a recording
    thread registers a new instrument mid-copy."""
    with _lock:
        return dict(_registry)


def snapshot_values():
    """Locked point-in-time snapshot for the time-series sampler
    (:mod:`.timeseries`): a list of ``(name, labels, kind, buckets,
    payload)`` rows, one per registered instrument. ``payload`` is the
    scalar value for counters/gauges and ``(cumulative bucket counts
    including +Inf, sum, count)`` for histograms; ``buckets`` is the
    finite upper-bound ladder (None for scalars).

    Taken under the SAME lock as the mutators, exactly like
    :func:`dump_metrics`: a histogram snapshot must never pair a sum
    with a count that misses its observation — windowed quantiles are
    bucket DELTAS between two of these snapshots, so a torn snapshot
    would poison two windows, not one."""
    out = []
    with _lock:
        for inst in _registry.values():
            if isinstance(inst, Histogram):
                cum, running = [], 0
                for c in inst._counts:
                    running += c
                    cum.append(running)
                out.append((inst.name, inst.labels, inst.kind,
                            inst.buckets, (tuple(cum), inst._sum,
                                           inst._count)))
            else:
                out.append((inst.name, inst.labels, inst.kind, None,
                            inst._value))
    return out


def unregister(name, labels=None):
    """Remove one child (``labels`` given) or a whole metric family
    (``labels=None``) from the registry; returns how many instruments
    were removed.

    This exists for OWNED gauges: a gauge written by an engine object
    freezes at its last value when the object stops — ``/metrics``
    then reports a queue depth for a server that no longer exists.
    Engines call this from their stop path (and via
    :func:`unregister_on_collect` as a GC safety net) so a dead
    owner's gauges disappear from the scrape instead of lying. A later
    write simply re-creates the instrument."""
    with _lock:
        if labels is None:
            doomed = [k for k, inst in _registry.items()
                      if inst.name == name]
        else:
            key = _key(name, labels)
            doomed = [key] if key in _registry else []
        for k in doomed:
            del _registry[k]
    return len(doomed)


def unregister_on_collect(owner, names):
    """Arm a ``weakref.finalize`` that unregisters every family in
    ``names`` when ``owner`` is garbage-collected — the WeakSet-provider
    discipline: an engine that is dropped without a clean ``stop()``
    must not leave frozen gauges behind. Idempotent with the explicit
    stop-path :func:`unregister` (removing a missing family is a
    no-op). Returns the finalizer (tests call it directly)."""
    import weakref

    names = tuple(names)
    return weakref.finalize(
        owner, lambda: [unregister(n) for n in names])


def percentile(sorted_vals, q):
    """Nearest-rank percentile of an ASCENDING-sorted sequence of raw
    values (``q`` in 0-100) — the shared estimator for exact-sample
    paths; bucketed data goes through
    :func:`bucket_quantile` instead."""
    if not sorted_vals:
        return 0.0
    if q <= 0:
        return sorted_vals[0]
    rank = max(1, math.ceil(q / 100.0 * len(sorted_vals)))
    return sorted_vals[min(rank, len(sorted_vals)) - 1]


def bucket_quantile(uppers, counts, q):
    """Estimated ``q``-quantile (q in [0, 1]) from histogram buckets.

    ``uppers``: ascending finite bucket upper bounds; ``counts``:
    per-bucket (NON-cumulative) counts with ``len(uppers) + 1`` entries,
    the last being the +Inf overflow bucket. Callers holding cumulative
    snapshots (``snapshot_values`` payloads, scraped ``_bucket`` lines)
    difference them first — which is also how windowed quantiles fall
    out: the delta of two cumulative snapshots IS the window's counts.

    The Prometheus ``histogram_quantile`` rule: find the bucket the
    rank lands in, interpolate linearly inside it (lower bound 0 for
    the first bucket); a rank in the +Inf bucket returns the highest
    finite bound — the estimator never invents a value beyond the
    ladder. Returns 0.0 for an empty histogram."""
    if len(counts) != len(uppers) + 1:
        raise ValueError(
            "bucket_quantile: %d counts for %d finite buckets (want "
            "len(uppers) + 1, last = +Inf overflow)"
            % (len(counts), len(uppers)))
    total = sum(counts)
    if total <= 0:
        return 0.0
    q = min(max(float(q), 0.0), 1.0)
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts[:-1]):
        cum += c
        if rank <= cum and c > 0:
            lo = uppers[i - 1] if i > 0 else min(0.0, uppers[0])
            frac = (rank - (cum - c)) / c
            return lo + (uppers[i] - lo) * frac
    return float(uppers[-1]) if uppers else 0.0


def reset_metrics():
    """Zero every instrument (tests; bench isolation). Registration and
    the enabled switch are untouched."""
    with _lock:
        for inst in _registry.values():
            inst._reset()


def _fmt(v):
    if isinstance(v, float):
        if v != v:  # NaN
            return "NaN"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _prom_name(name):
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return "mxnet_" + safe


def _escape_label_value(v):
    """Label-value escaping per the text exposition format: backslash,
    double quote, and newline must be escaped inside the quotes."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v):
    """# HELP text escaping: backslash and newline (quotes are legal)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _label_body(labels):
    """Rendered (escaped) label pairs without braces: 'k="v",k2="v2"'."""
    return ",".join('%s="%s"' % (k, _escape_label_value(v))
                    for k, v in labels)


def _label_block(lbl):
    """A pre-rendered label body wrapped in braces ('' when empty)."""
    return "{%s}" % lbl if lbl else ""


def dump_metrics():
    """Prometheus text exposition of every registered instrument:
    ``# HELP`` (when provided) and ``# TYPE`` once per metric family,
    then one sample line per child, label values escaped. Serve it with
    content type :data:`PROM_CONTENT_TYPE`."""
    out = []
    with _lock:
        # under the same lock as the mutators so a histogram never
        # renders a sum that includes an observation its count misses;
        # sorted by (family, labels) so every family's children are
        # contiguous under ONE # HELP/# TYPE header
        insts = sorted(_registry.values(),
                       key=lambda i: (i.name, i.labels))
        prev_family = None
        for inst in insts:
            pname = _prom_name(inst.name)
            if inst.name != prev_family:
                prev_family = inst.name
                help_text = next((i.help for i in insts
                                  if i.name == inst.name and i.help), None)
                if help_text:
                    out.append("# HELP %s %s" % (pname,
                                                 _escape_help(help_text)))
                out.append("# TYPE %s %s" % (pname, inst.kind))
            inst._render(out, pname, _label_body(inst.labels))
    return "\n".join(out) + ("\n" if out else "")
