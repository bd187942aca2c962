"""The tuning cache and the registry of tunables: the counterpart of
``mxnet_tpu/autotune/`` that serving consults.

* :mod:`.registry` — call sites declare their knob and its search space
  (``serving.buckets``);
* :mod:`.cache` — winners persist per device fingerprint in
  ``MXNET_TUNE_CACHE`` (default ``~/.cache/mxnet_tpu_torch/tuning.json``);
  consumers pay one dict probe;
* :mod:`.cost_model` — the ladder's analytic cost.

Modes (``MXNET_TUNE``): ``0`` (default) consult the cache; ``-1`` bypass
lookups. The measured search (``search.py``, ``tuners.py``, e.g.
``tune_serving_buckets``), the learned cost model and the flash and fused
cost models wait for ROADMAP A13.
"""
from . import cache, cost_model, registry
from .cache import (cache_path, device_fingerprint, entries, lookup,
                    lookup_entry, record, reload, reset, reset_stats, save,
                    stats)
from .registry import declare, get as get_tunable, names as tunable_names

__all__ = ["cache", "registry", "cost_model", "cache_path",
           "device_fingerprint", "entries", "lookup", "lookup_entry",
           "record", "reload", "reset", "reset_stats", "save", "stats",
           "declare", "get_tunable", "tunable_names"]
