"""Tunable-parameter registry: call sites declare their knob and its
search space.

Counterpart of ``mxnet_tpu/autotune/registry.py``, whole. A
:class:`Tunable` names one knob family (``serving.buckets``), its
candidate space, the hand-picked default (so a cache miss costs nothing),
and an optional analytic cost function a search driver ranks candidates
with (autotune/cost_model.py). Declarations live at the call site —
``serving/buckets.py`` registers its knob at import — so the tuner's
view of the space and the consumer's view of the knob cannot drift
apart. The search itself waits for ROADMAP A13.
"""
from __future__ import annotations

import itertools
import threading

__all__ = ["Tunable", "declare", "get", "names"]

_reg_lock = threading.Lock()
_registry = {}  # name -> Tunable  # guarded-by: _reg_lock


class Tunable:
    """One declared knob family.

    ``space``: dict ``param -> sequence of candidate values``, or a
    callable ``ctx -> such a dict`` when the space depends on the shape
    being tuned (e.g. a ladder is topped by the largest request).
    ``default``: callable ``ctx -> value dict`` returning the hand-picked
    fallback (usually read from config.py flags).
    ``cost``: callable ``(candidate, ctx) -> estimated seconds`` (lower
    is better; ``inf`` marks an infeasible candidate).
    """

    __slots__ = ("name", "space", "default", "cost", "doc")

    def __init__(self, name, space, default=None, cost=None, doc=""):
        self.name = name
        self.space = space
        self.default = default
        self.cost = cost
        self.doc = doc

    def resolve_space(self, ctx=None):
        space = self.space(ctx or {}) if callable(self.space) else self.space
        return {k: tuple(v) for k, v in space.items()}

    def candidates(self, ctx=None):
        """All candidate dicts, in a stable enumeration order."""
        space = self.resolve_space(ctx)
        params = sorted(space)
        out = []
        for combo in itertools.product(*(space[p] for p in params)):
            out.append(dict(zip(params, combo)))
        return out

    def default_value(self, ctx=None):
        return self.default(ctx or {}) if self.default is not None else None

    def __repr__(self):
        return "Tunable(%r)" % (self.name,)


def declare(name, space, default=None, cost=None, doc=""):
    """Register (or re-declare — last wins, import order is stable) a
    tunable. Returns it."""
    t = Tunable(name, space, default=default, cost=cost, doc=doc)
    with _reg_lock:
        _registry[name] = t
    return t


def get(name):
    """Registered Tunable or KeyError with the known names."""
    with _reg_lock:
        t = _registry.get(name)
        known = sorted(_registry)
    if t is None:
        raise KeyError("no tunable %r declared (known: %s)" % (name, known))
    return t


def names():
    with _reg_lock:
        return sorted(_registry)
