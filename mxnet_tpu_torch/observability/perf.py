"""Roofline attribution of the engines' programs: the ``perf`` section of
every engine stats snapshot.

Counterpart of ``mxnet_tpu/observability/perf.py``, :func:`summary_brief`
only: the JAX package's "perf off" shape, which its snapshots carry while
no program has measured attribution. MFU and HBM utilisation from
measured programs (its program table, the step waterfall and the perf
ledger) need the port's profiler and an H100 calibration, and wait for
ROADMAP A13.
"""
from __future__ import annotations

__all__ = ["summary_brief"]


def summary_brief():
    """The compact perf section engine ``get_stats()`` snapshots carry
    (stats_schema): attribution off, no measured program."""
    return {"enabled": False, "mfu_pct": None, "hbm_util_pct": None,
            "programs": 0, "waterfall": None}
