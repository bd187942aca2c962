"""ONE stats schema for the serving engines' operational snapshots.

Counterpart of ``mxnet_tpu/observability/stats_schema.py``, whole:
:func:`engine_stats` builds the snapshot ``InferenceServer.get_stats()``
returns, guaranteeing one shared core vocabulary (:data:`CORE_KEYS`, the
same keys, types and :data:`SCHEMA_VERSION` as the JAX package's) on top
of which each engine layers its engine-specific and legacy keys:

* ``engine`` — ``"serving"`` | ``"generation"``; ``schema`` — version.
* ``queue_depth`` — admitted-but-undispatched work (rows / requests).
* ``requests`` / ``completed`` / ``rejected`` — request accounting.
* ``capacity`` — occupancy dict (buckets/replicas/inflight for serving).
* ``config`` — the knobs this engine resolved (deadlines, buckets) so a
  scraped snapshot is self-describing.
* ``resilience`` — breaker/fault state (quarantined replicas with probe
  countdowns, retries, drain timeouts).
* ``perf`` — roofline attribution (:func:`.perf.summary_brief`), injected
  by :func:`engine_stats` so every engine carries it schema-validated.
* ``running`` / ``stopped`` — lifecycle.

:func:`validate` asserts the contract; :func:`summarize` compacts one
snapshot into a status row.
"""
from __future__ import annotations

SCHEMA_VERSION = 1

# every engine snapshot must carry these, with these types
CORE_KEYS = {
    "engine": str,
    "schema": int,
    "queue_depth": int,
    "requests": int,
    "completed": int,
    "rejected": int,
    "capacity": dict,
    "config": dict,
    "resilience": dict,
    "perf": dict,
    "running": bool,
    "stopped": bool,
}


def engine_stats(engine, counters, *, queue_depth, completed, running,
                 stopped, capacity, config, resilience, control=None,
                 provenance=None, extra=None):
    """Assemble one schema-conforming snapshot.

    ``counters`` (the engine's raw counter dict) and ``extra`` (legacy
    flat keys) merge in first, so the shared vocabulary always wins a
    key collision — the drift this helper exists to prevent.

    ``control`` (optional) is the serving control plane's section:
    prefix-cache hit accounting, per-SLO-class queue depths, COW/sharing
    page counts.
    """
    from . import perf as _perf

    stats = dict(counters)
    if extra:
        stats.update(extra)
    stats.update(
        perf=_perf.summary_brief(),
        engine=str(engine),
        schema=SCHEMA_VERSION,
        queue_depth=int(queue_depth),
        requests=int(counters.get("requests", 0)),
        completed=int(completed),
        rejected=int(counters.get("rejected", 0)),
        capacity=dict(capacity),
        config=dict(config),
        resilience=dict(resilience),
        running=bool(running),
        stopped=bool(stopped))
    if control is not None:
        stats["control"] = dict(control)
    if provenance is not None:
        stats["graph_pass"] = provenance
    return stats


def validate(stats):
    """Assert ``stats`` honors the shared schema; returns it."""
    if not isinstance(stats, dict):
        raise TypeError("engine stats must be a dict, got %r"
                        % type(stats).__name__)
    for key, typ in CORE_KEYS.items():
        if key not in stats:
            raise ValueError("engine stats missing core key %r (have %s)"
                             % (key, sorted(stats)))
        if not isinstance(stats[key], typ):
            raise TypeError("engine stats key %r must be %s, got %r"
                            % (key, typ.__name__, type(stats[key]).__name__))
    if stats["schema"] != SCHEMA_VERSION:
        raise ValueError("engine stats schema %r != %d"
                         % (stats["schema"], SCHEMA_VERSION))
    return stats


def _latency_brief(engine):
    """p50/p99/mean of the engine's completed-request latency from the
    live ``request.total_ms{engine=...}`` histogram, via the registry's
    shared bucket estimator (``Histogram.quantile``). None when telemetry
    is off or no request completed yet."""
    from . import metrics

    for inst in metrics.all_instruments().values():
        # instrument labels are the canonical ((key, value), ...) tuple
        if (inst.name == "request.total_ms"
                and isinstance(inst, metrics.Histogram)
                and dict(inst.labels or ()).get("engine") == engine
                and inst.count > 0):
            return {"count": inst.count,
                    "mean_ms": round(inst.mean, 3),
                    "p50_ms": round(inst.quantile(0.50), 3),
                    "p99_ms": round(inst.quantile(0.99), 3)}
    return None


def summarize(stats):
    """The compact status row of one engine: shared core + the capacity and
    resilience dicts (already small), a since-boot latency brief from
    the registry's shared quantile estimator, plus the control-plane
    section when the engine carries one — none of the legacy flat
    keys."""
    validate(stats)
    out = {k: stats[k] for k in ("engine", "queue_depth", "requests",
                                 "completed", "rejected", "running",
                                 "stopped", "capacity", "resilience")}
    latency = _latency_brief(stats["engine"])
    if latency is not None:
        out["latency"] = latency
    if "control" in stats:
        out["control"] = stats["control"]
    return out
