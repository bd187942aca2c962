"""Deterministic fault injection: the substrate every recovery path is
tested on.

Counterpart of ``mxnet_tpu/resilience/faults.py``, whole: the same spec
grammar, triggers and seeding (``zlib.crc32`` of the point and rule index
mixed into ``MXNET_FAULTS_SEED``, then numpy's ``RandomState``), so one
spec and seed fire the same sequence in both packages.

Call sites *declare* named injection points at import and drop one
``faults.inject("point")`` call at the top of the guarded operation. With
no spec configured that call is a global read.

Under a spec — the ``MXNET_FAULTS`` environment variable or
:func:`configure` — matching calls deterministically misbehave::

    MXNET_FAULTS="serving.replica_execute[1]:raise@calls=1-2"

Grammar::

    spec    := entry (';' entry)*
    entry   := point ('[' tag ']')? ':' action ('=' param)? ('@' trig (',' trig)*)?
    action  := 'drop' | 'raise' | 'delay'            # delay=MS
    trig    := 'p=' FLOAT | 'call=' N | 'calls=' N '-' M | 'every=' K

* ``drop`` raises :class:`InjectedDrop` (a ``ConnectionError`` — the
  shape of a lost socket/RPC, which retry layers are expected to heal).
* ``raise`` raises :class:`InjectedFault` (a hard fault — the shape of
  a device error, which failover layers are expected to contain).
* ``delay=MS`` sleeps — the shape of a straggler.
* Triggers AND together; no trigger means *every* matching call. Each
  rule keeps its own matched-call counter and, for ``p=``, its own
  ``RandomState`` seeded from ``(MXNET_FAULTS_SEED, point, rule index)``
  — so a rule's firing schedule is a pure function of the spec, the
  seed, and that point's call sequence, independent of every other
  point.

A point may carry a ``tag`` per call (``inject("serving.replica_execute",
tag=replica_idx)``): a ``point[tag]`` rule matches only that tag, a bare
``point`` rule matches every call — how a spec faults exactly one
serving replica.
"""
from __future__ import annotations

import os
import threading
import time
import zlib

__all__ = ["InjectedFault", "InjectedDrop", "declare", "points", "inject",
           "configure", "reset", "enabled", "fired"]


class InjectedFault(RuntimeError):
    """A hard injected fault (action ``raise``) — stands in for a device
    or handler error; failover layers contain it, nothing retries it."""


class InjectedDrop(InjectedFault, ConnectionError):
    """An injected transport drop (action ``drop``) — a ConnectionError,
    so the same retry paths that heal real socket losses heal it."""


_lock = threading.Lock()
_declared = {}     # point -> doc  # guarded-by: _lock
_rules = None      # list[_Rule] | None (None = injection disabled)  # guarded-by: _lock
_env_loaded = False  # MXNET_FAULTS consulted already  # guarded-by: _lock


class _Rule:
    __slots__ = ("point", "tag", "action", "param", "p", "call", "call_hi",
                 "every", "calls", "fired", "_rng")

    def __init__(self, point, tag, action, param, p, call, call_hi, every,
                 seed, idx):
        self.point = point
        self.tag = tag
        self.action = action
        self.param = param
        self.p = p
        self.call = call
        self.call_hi = call_hi
        self.every = every
        self.calls = 0   # matched calls seen  # guarded-by: _lock
        self.fired = 0   # faults delivered  # guarded-by: _lock
        if p is not None:
            import numpy as np

            self._rng = np.random.RandomState(
                (int(seed) ^ zlib.crc32(("%s#%d" % (point, idx)).encode()))
                & 0x7FFFFFFF)
        else:
            self._rng = None

    def should_fire(self):
        """Caller holds _lock; ``self.calls`` already counts this call."""
        n = self.calls
        if self.call is not None:
            hi = self.call_hi if self.call_hi is not None else self.call
            if not (self.call <= n <= hi):
                return False
        if self.every is not None and n % self.every != 0:
            return False
        if self._rng is not None and self._rng.random_sample() >= self.p:
            return False
        return True

    def describe(self):
        pt = self.point if self.tag is None else "%s[%s]" % (self.point,
                                                             self.tag)
        act = self.action if self.param is None else "%s=%g" % (self.action,
                                                                self.param)
        return "%s:%s" % (pt, act)


def declare(point, doc=""):
    """Register a named injection point (call at import of the guarded
    module, next to the code that calls :func:`inject`)."""
    with _lock:
        _declared[point] = doc
    return point


def points():
    """Sorted declared injection points."""
    with _lock:
        return sorted(_declared)


def _parse_trigger(rule_kw, tok):
    key, _, val = tok.partition("=")
    if key == "p":
        rule_kw["p"] = float(val)
        if not 0.0 <= rule_kw["p"] <= 1.0:
            raise ValueError("p must be in [0, 1], got %s" % val)
    elif key == "call":
        rule_kw["call"] = int(val)
    elif key == "calls":
        lo, _, hi = val.partition("-")
        rule_kw["call"], rule_kw["call_hi"] = int(lo), int(hi)
    elif key == "every":
        rule_kw["every"] = int(val)
        if rule_kw["every"] < 1:
            raise ValueError("every must be >= 1")
    else:
        raise ValueError("unknown trigger %r (p=/call=/calls=/every=)"
                         % (tok,))


def _parse_spec(spec, seed, strict):
    rules = []
    for idx, entry in enumerate(e.strip() for e in spec.split(";")):
        if not entry:
            continue
        head, sep, rest = entry.partition(":")
        if not sep:
            raise ValueError("fault entry %r has no action "
                             "(point:action@trigger)" % entry)
        point, tag = head.strip(), None
        if point.endswith("]") and "[" in point:
            point, _, tag = point[:-1].partition("[")
        if strict:
            with _lock:
                known = sorted(_declared)
                undeclared = point not in _declared
            if undeclared:
                raise KeyError("no injection point %r declared (known: %s)"
                               % (point, known))
        action_tok, _, trig_str = rest.partition("@")
        action, _, param = action_tok.strip().partition("=")
        if action not in ("drop", "raise", "delay"):
            raise ValueError("unknown fault action %r (drop/raise/delay)"
                             % (action,))
        kw = dict(p=None, call=None, call_hi=None, every=None)
        for tok in (t.strip() for t in trig_str.split(",") if t.strip()):
            _parse_trigger(kw, tok)
        rules.append(_Rule(point, tag, action,
                           float(param) if param else None,
                           seed=seed, idx=idx, **kw))
    return rules


def configure(spec=None, seed=None, strict=True):
    """Install a fault spec programmatically (tests / chaos drivers).
    ``spec=None`` disables injection. ``strict`` validates every point
    against the declared registry (the env path is lenient: a spec may
    name a point whose module is not imported yet)."""
    global _rules, _env_loaded
    if seed is None:
        seed = int(os.environ.get("MXNET_FAULTS_SEED", "0"))
    rules = _parse_spec(spec, seed, strict) if spec else None
    with _lock:
        _rules = rules or None
        _env_loaded = True   # explicit configure overrides the env


def reset():
    """Disable injection and forget the env consult, so the next
    :func:`inject` re-reads ``MXNET_FAULTS`` (test isolation)."""
    global _rules, _env_loaded
    with _lock:
        _rules = None
        _env_loaded = False


def enabled():
    return _rules is not None


def fired():
    """{rule description: fired count} for every installed rule — the
    chaos-test assertion surface (and the flight-recorder section)."""
    with _lock:
        rules = list(_rules) if _rules else []
        return {r.describe(): {"calls": r.calls, "fired": r.fired}
                for r in rules}


def _load_env():
    global _rules, _env_loaded
    spec = os.environ.get("MXNET_FAULTS", "").strip()
    seed = int(os.environ.get("MXNET_FAULTS_SEED", "0"))
    rules = _parse_spec(spec, seed, strict=False) if spec else None
    with _lock:
        if not _env_loaded:
            _env_loaded = True
            if _rules is None:
                _rules = rules


def inject(point, tag=None):
    """The per-call-site hook: no-op unless a configured rule matches
    this (point, tag) and its triggers fire — then drop/raise/delay.

    The disabled path is two module-global reads; keep this call OUTSIDE
    a CUDA graph capture (it is host control flow: a captured body would
    never run it again)."""
    if _rules is None:
        if _env_loaded:
            return
        _load_env()
        if _rules is None:
            return
    _fire(point, tag)


def _fire(point, tag):
    tag = None if tag is None else str(tag)
    delay = None
    err = None
    desc = None
    with _lock:
        rules = _rules or ()
        for rule in rules:
            if rule.point != point:
                continue
            if rule.tag is not None and rule.tag != tag:
                continue
            rule.calls += 1
            if not rule.should_fire():
                continue
            rule.fired += 1
            desc = rule.describe()
            if rule.action == "delay":
                delay = (rule.param or 0.0) / 1e3
            elif rule.action == "drop":
                err = InjectedDrop("injected drop at %s (call %d)"
                                   % (desc, rule.calls))
            else:
                err = InjectedFault("injected fault at %s (call %d)"
                                    % (desc, rule.calls))
            break  # first matching firing rule wins for this call
    if desc is not None:
        from ..observability import metrics

        metrics.counter("faults.injected").inc()
    if delay is not None:
        time.sleep(delay)
    if err is not None:
        raise err


def _recorder_section():
    """Flight-recorder provider: what was injected when a run died."""
    if _rules is None:
        return None
    return {"spec_active": True, "rules": fired()}
