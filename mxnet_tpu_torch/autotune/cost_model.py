"""Analytic cost of a serving bucket ladder: the part of
``mxnet_tpu/autotune/cost_model.py`` the ladder's tunable declaration
(serving/buckets.py) uses. The roofline ceilings and the flash and fused
cost models, measured on a TPU there, wait for an H100 calibration
(ROADMAP A13).
"""
from __future__ import annotations

import math

__all__ = ["pow2_at_least", "expected_padding", "ladder_cost"]


def pow2_at_least(n):
    """Smallest power of two >= n (shape-bucket / ladder-top rounding)."""
    p = 1
    while p < n:
        p <<= 1
    return p


def expected_padding(ladder, sizes):
    """(padded_rows / real_rows) of serving ``sizes`` under ``ladder``,
    with oversize requests chunked at the largest bucket first — the
    engine's admission behavior (serving/engine.py)."""
    ladder = sorted(set(int(b) for b in ladder))
    top = ladder[-1]
    real = alloc = 0
    for n in sizes:
        n = int(n)
        real += n
        while n > top:
            alloc += top
            n -= top
        if n:
            i = 0
            while ladder[i] < n:
                i += 1
            alloc += ladder[i]
    if not real:
        return 0.0
    return (alloc - real) / real


def ladder_cost(candidate, ctx):
    """Rank bucket ladders: expected pad-waste ratio (the per-request
    compute overhead) plus a small per-bucket program penalty — the
    program count is len(ladder) x replicas forever (serving/buckets.py)."""
    ladder = candidate["buckets"]
    sizes = ctx.get("sizes") or (1,)
    if not ladder:
        return math.inf
    return expected_padding(ladder, sizes) + 0.02 * len(ladder)
