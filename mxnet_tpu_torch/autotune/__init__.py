"""The tuning cache and the registry of tunables: the counterpart of
``mxnet_tpu/autotune/`` that serving consults.

* :mod:`.registry` — call sites declare their knob and its search space
  (``serving.buckets``);
* :mod:`.cache` — winners persist per device fingerprint in
  ``MXNET_TUNE_CACHE`` (default ``~/.cache/mxnet_tpu_torch/tuning.json``);
  consumers pay one dict probe;
* :mod:`.cost_model` — the ladder's analytic cost.

* :mod:`.tuners` — the int8 paths' measured arbitrations:
  :func:`tune_generation_kv` (``generation.kv_dtype``) and
  :func:`tune_quantize_layers` (``quantize.layers``).

Modes (``MXNET_TUNE``): ``0`` (default) consult the cache; ``-1`` bypass
lookups. The generic measured search (``search.py``), the other tuners
(``tune_serving_buckets``, flash blocks, layout, remat), the learned cost
model and the flash and fused cost models wait for ROADMAP A13.
"""
from . import cache, cost_model, registry, tuners
from .cache import (cache_path, device_fingerprint, entries, lookup,
                    lookup_entry, note_measurements, record, reload, reset,
                    reset_stats, save, stats)
from .registry import declare, get as get_tunable, names as tunable_names
from .tuners import tune_generation_kv, tune_quantize_layers

__all__ = ["cache", "registry", "cost_model", "tuners", "cache_path",
           "device_fingerprint", "entries", "lookup", "lookup_entry",
           "note_measurements", "record", "reload", "reset", "reset_stats",
           "save", "stats", "declare", "get_tunable", "tunable_names",
           "tune_generation_kv", "tune_quantize_layers"]
