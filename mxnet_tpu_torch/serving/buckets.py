"""Batch-shape bucketing: the program-count discipline of the serving
engine.

Counterpart of ``mxnet_tpu/serving/buckets.py``, whole. The server holds
one program per (replica, bucket) — on the card one CUDA graph, captured
once and replayed — so a server that made one per observed request size
would capture without bound. Requests are therefore padded up to a small
fixed ladder of batch buckets; the program count is bounded by
``len(buckets) * n_replicas``, never by traffic.

Power-of-two buckets keep the ladder short (waste is bounded by 2x minus
one row).
"""
from __future__ import annotations

import bisect
import os

from ..autotune import cost_model as _tune_cost
from ..autotune.cost_model import pow2_at_least as _pow2_at_least
from ..autotune.registry import declare as _declare_tunable

__all__ = ["parse_buckets", "pick_bucket", "DEFAULT_BUCKETS",
           "ladder_candidates", "traffic_signature"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def ladder_candidates(max_size=None, sizes=None):
    """Candidate bucket ladders for the autotuner, all topped by the
    smallest power of two covering ``max_size`` (default: the traffic
    sample's largest request, else the default ladder's top): the full
    power-of-two ladder, a sparse (x4-step) one, the two extremes
    (single bucket / {1, top}), and — given a traffic sample — a
    quantile ladder built from its p50/p95."""
    if max_size is None:
        max_size = max(sizes) if sizes else DEFAULT_BUCKETS[-1]
    top = _pow2_at_least(int(max_size))
    full = []
    b = 1
    while b <= top:
        full.append(b)
        b <<= 1
    sparse = sorted(set(full[::2]) | {1, top})
    cands = {tuple(full), tuple(sparse), (1, top), (top,)}
    if sizes:
        ordered = sorted(int(n) for n in sizes)
        q = {1, top}
        for pct in (0.5, 0.95):
            q.add(min(top, _pow2_at_least(
                ordered[int(pct * (len(ordered) - 1))])))
        cands.add(tuple(sorted(q)))
    return sorted(cands)


def traffic_signature(sizes):
    """Quantized fingerprint of a request-size sample — the traffic-shape
    half of a ``serving.buckets`` tuning-cache key."""
    ordered = sorted(int(n) for n in sizes)
    if not ordered:
        return "empty"
    pick = lambda pct: ordered[int(pct * (len(ordered) - 1))]  # noqa: E731
    return "p50x%d-p95x%d-maxx%d" % (
        _pow2_at_least(pick(0.5)), _pow2_at_least(pick(0.95)),
        _pow2_at_least(ordered[-1]))


# the ladder's knob declaration: candidates are whole ladders, ranked
# analytically by expected pad-waste + a per-bucket program penalty (the
# JAX package then measures them on a live server,
# autotune.tune_serving_buckets; not ported yet, ROADMAP A13)
_declare_tunable(
    "serving.buckets",
    space=lambda ctx: {"buckets": tuple(ladder_candidates(
        ctx.get("max_size"), ctx.get("sizes")))},
    default=lambda ctx: {"buckets": parse_buckets(None)},
    cost=_tune_cost.ladder_cost,
    doc="Serving batch-bucket ladder, keyed by (model fingerprint, "
        "traffic shape).")


def parse_buckets(spec=None):
    """Resolve the bucket ladder: explicit ``spec`` (iterable or
    comma-separated string) > ``MXNET_SERVING_BUCKETS`` env > the
    power-of-two default. Returns a sorted tuple of unique positive ints.
    """
    if spec is None:
        spec = os.environ.get("MXNET_SERVING_BUCKETS", "")
        if not spec.strip():
            return DEFAULT_BUCKETS
    if isinstance(spec, str):
        try:
            spec = [int(tok) for tok in spec.replace(",", " ").split()]
        except ValueError:
            raise ValueError(
                "bucket spec must be comma-separated ints, got %r" % (spec,))
    buckets = tuple(sorted(set(int(b) for b in spec)))
    if not buckets:
        raise ValueError("bucket spec resolved to an empty ladder")
    if buckets[0] < 1:
        raise ValueError("buckets must be positive, got %s" % (buckets,))
    return buckets


def pick_bucket(n_rows, buckets):
    """Smallest bucket that fits ``n_rows`` (the padding target). Rows
    beyond the largest bucket are the *caller's* problem — the engine
    splits oversize requests at admission so the dispatcher only ever
    sees request groups that fit one bucket."""
    if n_rows < 1:
        raise ValueError("need at least one row, got %d" % n_rows)
    i = bisect.bisect_left(buckets, n_rows)
    if i == len(buckets):
        raise ValueError(
            "%d rows exceed the largest bucket %d (the engine must chunk "
            "oversize requests before bucketing)" % (n_rows, buckets[-1]))
    return buckets[i]
