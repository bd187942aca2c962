"""Measured search loop: analytic pruning, learned ranking, then real
timings decide (the TVM schedule-search shape: cost model prunes,
measurement picks, cache remembers, and the measurements train the next
ranking).

Counterpart of ``mxnet_tpu/autotune/search.py``: the same two waves, the
same candidate order and the same hill climb, so a deterministic measurer
sees the same candidates in the same order in both packages.

The search is a grid/refinement hybrid over a :class:`~.registry.Tunable`'s
candidate space:

1. the tunable's analytic cost function scores every candidate and drops
   infeasible ones (``inf`` — e.g. a tile the kernel does not compile,
   or one whose shared memory exceeds a block's); the survivors are
   ranked by the LEARNED cost model when its held-out accuracy gate
   passed (autotune/learned.py — otherwise the analytic order stands,
   never anything worse), and the cheapest candidates fill the
   measurement budget (``MXNET_TUNE_TRIALS``),
2. each surviving candidate is timed by the caller-supplied ``measure``
   callable (median of k runs, warmup discarded — :func:`median_time`,
   which waits for the card after each run),
3. the remaining budget hill-climbs: one-notch neighbors of the current
   best are measured until the budget runs out or no unmeasured neighbor
   improves. A neighbor the cost function marks infeasible (``inf``) is
   never measured: the card's kernels raise on a tile they do not
   compile, where a Pallas kernel compiles any block (the one departure
   from the JAX package's trajectory, and only where a cost is ``inf``).

The hand-picked default is ALWAYS measured first (budget permitting), so
a tuned value can only beat or match it — the tuner never regresses a
config below the incumbent except for measurement noise.

Every measured candidate increments the cache's ``measurements`` counter
AND (under ``MXNET_COST_MODEL=1``) lands in the sample dataset beside
the tuning cache — every ``MXNET_TUNE=1`` run is free training data for
the learned model; a warm cache hit never reaches this module at all
(the zero-measurement bar).
"""
from __future__ import annotations

import time

from . import cache

__all__ = ["SearchConfig", "SearchResult", "median_time", "search",
           "tune_and_record"]


class SearchConfig:
    """Measurement budget/protocol. ``trials`` = total measured
    candidates (default ``MXNET_TUNE_TRIALS``); ``repeats``/``warmup``
    feed :func:`median_time` when the measurer uses it."""

    def __init__(self, trials=None, repeats=3, warmup=1):
        if trials is None:
            from ..config import get_flag

            trials = get_flag("MXNET_TUNE_TRIALS")
        self.trials = max(1, int(trials))
        self.repeats = max(1, int(repeats))
        self.warmup = max(0, int(warmup))


class SearchResult:
    __slots__ = ("best", "best_s", "measured", "pruned", "log", "ranker")

    def __init__(self, best, best_s, measured, pruned, log,
                 ranker="analytic"):
        self.best = best          # winning candidate dict
        self.best_s = best_s      # its measured seconds
        self.measured = measured  # number of candidates actually timed
        self.pruned = pruned      # dropped by the cost model
        self.log = log            # [(candidate, seconds)] in measure order
        self.ranker = ranker      # "learned" | "analytic" pre-measure order

    def as_dict(self):
        return {"best": self.best, "best_ms": round(self.best_s * 1e3, 4),
                "measured": self.measured, "pruned": self.pruned,
                "ranker": self.ranker}


def _sync():
    """Wait for the card's queued work, where this process uses a card:
    each timed run ends with ``torch.cuda.synchronize()``, so a run's time
    is the card's, not only its enqueue."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def median_time(fn, repeats=3, warmup=1):
    """Median wall seconds of ``fn()`` over ``repeats`` runs after
    ``warmup`` discarded runs (the first pays kernel builds and
    allocations), each run ending in ``torch.cuda.synchronize()`` on the
    card."""
    for _ in range(warmup):
        fn()
    _sync()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _frozen(candidate):
    def h(v):
        return tuple(v) if isinstance(v, (list, tuple)) else v

    return tuple(sorted((k, h(v)) for k, v in candidate.items()))


def _neighbors(candidate, space):
    """One-notch mutations of each param along its candidate axis."""
    out = []
    for param, values in space.items():
        values = list(values)
        try:
            i = values.index(candidate[param])
        except (KeyError, ValueError):
            continue
        for j in (i - 1, i + 1):
            if 0 <= j < len(values):
                mut = dict(candidate)
                mut[param] = values[j]
                out.append(mut)
    return out


def search(tunable, measure, ctx=None, cfg=None):
    """Run the pruned, measured search. ``measure(candidate) -> seconds``
    (the measurer owns its warmup/median protocol; :func:`median_time`
    is the standard helper). Returns a :class:`SearchResult`."""
    ctx = ctx or {}
    cfg = cfg or SearchConfig()
    cache.note_search()
    space = tunable.resolve_space(ctx)
    candidates = tunable.candidates(ctx)

    pruned = 0
    if tunable.cost is not None:
        scored = []
        for c in candidates:
            s = tunable.cost(c, ctx)
            if s == float("inf"):
                pruned += 1
            else:
                scored.append((s, c))
        scored.sort(key=lambda sc: sc[0])
        candidates = [c for _s, c in scored]
    if not candidates:
        raise ValueError("tunable %r: every candidate pruned (space %r)"
                         % (tunable.name, space))
    # learned re-ranking of the analytic survivors: consults
    # the persisted model only when its holdout gate passed; any other
    # state — cold, thin, gate-failed, load error — keeps the analytic
    # order, so the ranking can never fall below the roofline's
    ranker = "analytic"
    try:
        from . import learned

        reranked = learned.rank_candidates(tunable.name, candidates, ctx,
                                           cost_fn=tunable.cost)
        if reranked is not None:
            candidates = reranked
            ranker = "learned"
    except Exception:
        pass

    # incumbent first: the tuned value may only beat or match it
    ordered = []
    default = tunable.default_value(ctx)
    if default is not None:
        ordered.append(dict(default))
    ordered.extend(candidates)

    seen, log = set(), []

    def _measure(c):
        key = _frozen(c)
        if key in seen:
            return None
        seen.add(key)
        s = float(measure(c))
        cache.note_measurements(1)
        log.append((dict(c), s))
        return s

    budget = cfg.trials
    # wave 1: incumbent + cost-ranked grid (leave ~1/3 for refinement)
    wave = max(1, (2 * budget) // 3) if len(ordered) > budget else budget
    for c in ordered:
        if len(log) >= wave:
            break
        _measure(c)

    def _best():
        return min(log, key=lambda cs: cs[1])

    def _feasible(c):
        return tunable.cost is None or \
            tunable.cost(c, ctx) != float("inf")

    # wave 2: hill-climb one-notch neighbors of the running best
    while len(log) < budget:
        best_c, best_s = _best()
        nxt = [n for n in _neighbors(best_c, space)
               if _frozen(n) not in seen and _feasible(n)]
        if not nxt:
            # best's neighborhood exhausted: spend remaining budget on
            # the next cost-ranked unmeasured candidates
            nxt = [c for c in ordered if _frozen(c) not in seen][:1]
            if not nxt:
                break
        for n in nxt:
            if len(log) >= budget:
                break
            _measure(n)

    best_c, best_s = _best()
    # every measured candidate is free training data for the learned
    # model; recording and auto-retraining are never allowed to fail a
    # search
    try:
        from . import learned

        learned.note_samples(tunable.name, ctx, log, cost_fn=tunable.cost)
        learned.maybe_train()
    except Exception:
        pass
    return SearchResult(best_c, best_s, len(log), pruned, log,
                        ranker=ranker)


def tune_and_record(op, key, measure, ctx=None, dtype=None, cfg=None):
    """search() + cache.record(): the one-call tuning entry point used by
    the concrete tuners. Returns the winning value dict."""
    from . import registry

    tunable = registry.get(op)
    result = search(tunable, measure, ctx=ctx, cfg=cfg)
    cache.record(op, key, result.best, dtype=dtype,
                 ms=result.best_s * 1e3, trials=result.measured)
    return result
