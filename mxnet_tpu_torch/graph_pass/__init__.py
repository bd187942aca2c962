"""Graph-level optimization passes, run once at bind time.

Counterpart of ``mxnet_tpu/graph_pass/``: ``prune`` (inference loss-head
simplification and dead-node elimination), ``bn_fold`` (inference
BatchNorm folded into the preceding conv/FC), ``layout`` (forced layout
rewrite), ``amp`` (bfloat16 mixed precision with fp32 islands, opt-in),
``quantize`` (post-training int8 with exact int32 islands, opt-in, over
a :class:`CalibrationTable` recorded by :func:`calibrate`), ``fuse``
(fusion regions) and ``fold`` (frozen-parameter subgraphs evaluated once
at bind). Pipeline selection is ``MXNET_GRAPH_PASSES`` (or
:func:`set_passes`). The per-program summaries of the rewrites (and what
:func:`note_program` records, as the generation engine's amp and KV
policies) ride the ``graph_pass`` flight-recorder provider; :func:`stats`
counts pipeline runs, cache hits, folds and quantized ops whether or not
telemetry is on.
"""
from __future__ import annotations

import collections
import hashlib
import threading
import time

from ..symbol.symbol import Symbol
from . import core, fuse, passes, quantize
from .core import (DEFAULT_PASSES, INFERENCE_ONLY, PIPELINE_ORDER,
                   PassConfig, PassContext, clone_entries, topo_from)
from .passes import eval_fold_exprs
from .quantize import (CalibrationTable, calibrate, set_calibration_table,
                       set_quantize_skip)

__all__ = ["PassConfig", "OptimizedGraph", "optimize", "optimize_for_bind",
           "graph_fingerprint", "set_passes", "stats", "reset_stats",
           "recent_reports", "note_program", "PIPELINE_ORDER",
           "DEFAULT_PASSES", "CalibrationTable", "calibrate",
           "set_calibration_table", "set_quantize_skip"]

_PASS_FNS = {
    "prune": passes.run_prune,
    "bn_fold": passes.run_bn_fold,
    "quantize": quantize.run_quantize,
    "layout": passes.run_layout,
    "amp": passes.run_amp,
    "fuse": fuse.run_fuse,
    "fold": passes.run_fold,
}

_lock = threading.Lock()
_stats = collections.Counter()          # guarded-by: _lock
_recent = collections.deque(maxlen=16)  # per-program summaries  # guarded-by: _lock
_provider_armed = False                 # guarded-by: _lock
# bind-level structure cache: a re-bind of the same symbol under the same
# pass config never re-runs the pipeline (strong symbol ref, so id() can
# never alias a dead object)
_cache = collections.OrderedDict()   # guarded-by: _lock
_CACHE_CAP = 64
# per-symbol fingerprint memo for the quantize bind-key lookup (a strong
# symbol ref for the same id-aliasing reason; bounded like _cache)
_fp_memo = collections.OrderedDict()  # id(symbol) -> (symbol, fp)  # guarded-by: _lock


def set_passes(spec):
    """Process-wide override of MXNET_GRAPH_PASSES (None clears); the
    bind-level structure cache is dropped so the next bind re-resolves."""
    core._SPEC_OVERRIDE = spec
    with _lock:
        _cache.clear()


def stats():
    """Pipeline counters (pipeline_runs, cache_hits, graphs_rewritten,
    folds, quantized_ops, ...), kept whether or not telemetry is on."""
    with _lock:
        return dict(_stats)


def reset_stats():
    with _lock:
        _stats.clear()


def recent_reports():
    """Chronological copy of the last per-program pass summaries (the
    flight-recorder provider's payload)."""
    with _lock:
        return list(_recent)


def _graph_pass_state():
    with _lock:
        if not _recent and not _stats:
            return None
        return {"stats": dict(_stats), "recent": list(_recent)}


def _arm_provider():
    global _provider_armed
    with _lock:
        if _provider_armed:
            return
        _provider_armed = True
    from ..observability import flight_recorder

    flight_recorder.register_provider("graph_pass", _graph_pass_state)


def note_program(kind, **summary):
    """Record an externally built program's pass facts (the generation
    engine's amp policy) into the provider ring."""
    _arm_provider()
    entry = {"program": str(kind)}
    entry.update(summary)
    with _lock:
        _recent.append(entry)


def graph_fingerprint(symbol_or_entries):
    """Stable graph fingerprint: node count + a hash of the op sequence with
    per-node op params (the JAX package's construction)."""
    entries = (symbol_or_entries._outputs
               if isinstance(symbol_or_entries, Symbol)
               else list(symbol_or_entries))
    topo = [n for n in topo_from(entries) if not n.is_variable]
    sig = ";".join(
        "%s{%s}" % (n.op, ",".join(
            "%s=%s" % (k, n.attrs[k]) for k in sorted(n.attrs)))
        for n in topo)
    return "g%d-%s" % (len(topo),
                       hashlib.sha1(sig.encode()).hexdigest()[:12])


class OptimizedGraph:
    """One pipeline run's result: the rewritten symbol plus what the bind
    layer needs (fold expressions, per-pass reports)."""

    __slots__ = ("symbol", "fold_exprs", "reports", "config", "graph_key",
                 "for_training", "nodes_before", "nodes_after")

    def __init__(self, symbol, fold_exprs, reports, config, graph_key,
                 for_training, nodes_before, nodes_after):
        self.symbol = symbol
        self.fold_exprs = list(fold_exprs)
        self.reports = list(reports)
        self.config = config
        self.graph_key = graph_key
        self.for_training = bool(for_training)
        self.nodes_before = nodes_before
        self.nodes_after = nodes_after

    def fold(self, values):
        """Evaluate the fold expressions once against ``values`` ({frozen
        var name: tensor}); returns {fold name: tensor}."""
        if not self.fold_exprs:
            return {}
        out = eval_fold_exprs(self.fold_exprs, values,
                              for_training=self.for_training)
        nbytes = sum(v.numel() * v.element_size() for v in out.values())
        with _lock:
            _stats["folds"] += 1
            _stats["folded_bytes"] += nbytes
        return out

    def summary(self):
        """JSON-safe per-program pass summary."""
        out = {"graph": self.graph_key, "for_training": self.for_training,
               "nodes_before": self.nodes_before,
               "nodes_after": self.nodes_after,
               "folded_constants": len(self.fold_exprs),
               "amp": "amp" in self.config.passes,
               "passes": list(self.reports)}
        for rep in self.reports:
            # the quantize coverage rides at the top level: what share of
            # this program is int8, and under which calibration table
            if rep["pass"] == "quantize" and "detail" in rep:
                d = rep["detail"]
                out["quantize"] = {
                    "ops_quantized": d.get("ops_quantized", 0),
                    "ops_eligible": d.get("ops_eligible", 0),
                    "skipped": dict(d.get("skipped", {})),
                    "table": d.get("table")}
            if rep["pass"] == "fuse" and "detail" in rep:
                d = rep["detail"]
                out["fuse"] = {
                    "regions": [dict(r) for r in d.get("regions", ())],
                    "rejected": dict(d.get("rejected", {})),
                    "saved_bytes": d.get("saved_bytes", 0)}
        return out


def optimize(symbol, for_training=False, frozen=(), arg_shapes=None,
             arg_dtypes=None, config=None):
    """Run the configured pipeline over ``symbol``; returns an
    :class:`OptimizedGraph`, or None when the layer is off or nothing
    changed (callers then run the original symbol)."""
    cfg = config if config is not None else PassConfig()
    if not cfg.enabled:
        return None
    _arm_provider()
    outputs, _memo = clone_entries(symbol._outputs)
    graph_key = graph_fingerprint(outputs)
    ctx = PassContext(outputs, for_training, frozen, arg_shapes,
                      arg_dtypes, cfg, graph_key)
    nodes_before = ctx.node_count()
    for name in PIPELINE_ORDER:
        if name not in cfg.passes:
            continue
        if for_training and name in INFERENCE_ONLY:
            continue
        before = ctx.node_count()
        t0 = time.perf_counter()
        rewrites = _PASS_FNS[name](ctx)
        report = {"pass": name, "rewrites": int(rewrites),
                  "nodes_before": before, "nodes_after": ctx.node_count(),
                  "wall_ms": round((time.perf_counter() - t0) * 1e3, 3)}
        extra = ctx.pass_extras.get(name)
        if extra is not None:
            report["detail"] = extra
        ctx.reports.append(report)
    nodes_after = ctx.node_count()
    changed = any(r["rewrites"] for r in ctx.reports)
    opt = OptimizedGraph(Symbol(list(ctx.outputs)), ctx.fold_exprs,
                         ctx.reports, cfg, graph_key, for_training,
                         nodes_before, nodes_after) if changed else None
    quant = ctx.pass_extras.get("quantize") or {}
    fused = ctx.pass_extras.get("fuse") or {}
    with _lock:
        _stats["pipeline_runs"] += 1
        if changed:
            _stats["graphs_rewritten"] += 1
            _stats["nodes_removed"] += max(0, nodes_before - nodes_after)
            _recent.append(opt.summary())
        if quant:
            _stats["quantized_ops"] += quant.get("ops_quantized", 0)
            # "*" is the no-table placeholder, not a skipped op
            _stats["quantize_skipped"] += len(
                [n for n in quant.get("skipped", {}) if n != "*"])
        if fused:
            _stats["fused_regions"] += len(fused.get("regions", ()))
            _stats["fused_saved_bytes"] += fused.get("saved_bytes", 0)
    from ..observability import metrics

    if metrics.enabled():
        amp_rw = sum(r["rewrites"] for r in ctx.reports
                     if r["pass"] == "amp")
        if amp_rw:
            metrics.counter("graph_pass.precision_rewrites").inc(amp_rw)
        if quant.get("ops_quantized"):
            metrics.counter("graph_pass.quantized_ops").inc(
                quant["ops_quantized"])
    return opt


def optimize_for_bind(symbol, for_training=False, frozen=(),
                      arg_shapes=None, arg_dtypes=None, config=None):
    """Cached :func:`optimize` for bind sites, keyed by (symbol id, pass
    config, mode, frozen set, input rank/dtype signature): only ranks key
    the cache, so a batch reshape reuses the structure."""
    cfg = config if config is not None else PassConfig()
    if not cfg.enabled:
        return None
    rank_sig = tuple(sorted(
        (k, len(v)) for k, v in (arg_shapes or {}).items()
        if v is not None))
    dtype_sig = tuple(sorted(
        (k, str(v)) for k, v in (arg_dtypes or {}).items()))
    key = (id(symbol), cfg.signature(), bool(for_training),
           frozenset(frozen or ()), rank_sig, dtype_sig)
    if "quantize" in cfg.passes:
        # the tuned skip list run_quantize consults is part of the
        # rewrite's identity: a tuning cache that changes quantize.layers
        # must miss here, not serve a graph built under the stale pins.
        # The fingerprint is memoized per symbol, so hits stay cheap.
        from .. import autotune

        with _lock:
            hit = _fp_memo.get(id(symbol))
            fp = hit[1] if hit is not None else None
        if fp is None:
            fp = graph_fingerprint(symbol)
            with _lock:
                _fp_memo[id(symbol)] = (symbol, fp)
                while len(_fp_memo) > _CACHE_CAP:
                    _fp_memo.popitem(last=False)
        tuned = autotune.lookup("quantize.layers", key=fp)
        skip = (tuple(sorted(tuned.get("skip") or ()))
                if isinstance(tuned, dict) else ())
        key = key + (skip,)
    with _lock:
        hit = _cache.get(key)
        if hit is not None:
            _cache.move_to_end(key)
            _stats["cache_hits"] += 1
            return hit[1]
    opt = optimize(symbol, for_training=for_training, frozen=frozen,
                   arg_shapes=arg_shapes, arg_dtypes=arg_dtypes, config=cfg)
    with _lock:
        _cache[key] = (symbol, opt)
        while len(_cache) > _CACHE_CAP:
            _cache.popitem(last=False)
    return opt
