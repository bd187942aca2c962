"""Runtime flag surface: the ``MXNET_*`` environment layer.

Counterpart of ``mxnet_tpu/config.py``, with the same names and defaults for
the flags the ported slice reads:

``MXNET_GRAPH_PASSES`` (string, default ``default``)
    The graph-pass pipeline selection (graph_pass/core.py grammar). Read
    from the environment by :class:`~.graph_pass.PassConfig`, not here.
``MXNET_FUSION_KERNEL`` (default 1)
    Lower kernel-form fusion regions onto the hand-written fused matmul
    (parallel/fused.py). 0 keeps every region on its reference
    composition.
``MXNET_FUSION_MIN_BYTES`` (default 0)
    The fuse pass rejects regions whose scored interior traffic is below
    this many bytes.
``MXNET_SERVING_MAX_WAIT_MS`` (5), ``MXNET_SERVING_QUEUE`` (1024),
``MXNET_SERVING_PIPELINE`` (2), ``MXNET_SERVING_DEADLINE_MS`` (0),
``MXNET_SERVING_COOLDOWN_MS`` (1000)
    Serving micro-batch deadline, admission queue rows, in-flight batch
    window, per-request queue deadline and the circuit breaker's cooldown
    before a quarantined replica is probed (serving/engine.py).
    ``MXNET_SERVING_BUCKETS`` and ``MXNET_SERVING_BACKPRESSURE`` are
    strings read by serving itself.
``MXNET_TELEMETRY`` (default 0)
    Master switch of the metrics registry (observability/metrics.py): 0
    hands out one shared no-op instrument, 1 records counters, gauges and
    histograms.
``MXNET_OBS_TRACE_SAMPLE`` (default 1), ``MXNET_OBS_RESERVOIR`` (32)
    Request-trace sampling (0 off, 1 every request, N one in N) and the
    capacity of the tail-exemplar reservoir
    (observability/request_trace.py).
``MXNET_HEALTH_RING`` (default 256)
    Capacity of the flight recorder's ring of records
    (observability/flight_recorder.py).
``MXNET_TUNE`` (default 0)
    Autotuner mode (autotune/): 0 consults the tuning cache where a
    program, region or object is built (kernel tiles, remat, layout,
    bucket ladders, generation and pipeline knobs), a miss taking the
    default; 1 also runs the measured search on a miss at the shape-local
    call sites (the fused matmul and flash tiles), never while a stream is
    capturing a CUDA graph; -1 bypasses every lookup (the A/B baseline).
``MXNET_TUNE_TRIALS`` (default 12)
    Measurement budget of one search: candidates timed (median of k each)
    after the cost model's pruning.
``MXNET_TUNE_CACHE`` (default ``~/.cache/mxnet_tpu_torch/tuning.json``)
    Tuning-cache file. String-valued, env-only; ``MXNET_TUNE_FINGERPRINT``
    (env-only) overrides the device half of every cache key.
``MXNET_COST_MODEL`` (default 1), ``MXNET_COST_MODEL_MIN_SAMPLES`` (48),
``MXNET_COST_MODEL_RETRAIN`` (32)
    The learned cost model (autotune/learned.py): 1 records every measured
    search sample beside the tuning cache and lets a trained model re-rank
    candidates once its holdout Spearman is at least the analytic cost's;
    the samples needed before the first training, and the new samples
    that trigger a retrain. ``MXNET_COST_MODEL_PATH`` (env-only) is the
    model file (default ``<tuning cache>.model.json``).
``MXNET_FUSION_BLOCK_M`` / ``MXNET_FUSION_BLOCK_N`` (128 / 128)
    Upper bounds of the fused matmul's tile (parallel/fused.py) where no
    explicit argument and no ``fusion.blocks`` entry names one: the launch
    takes the default rule's tile (128 where that grid fills the card,
    else 64) capped at the largest compiled tile within both bounds. The
    JAX package's ``MXNET_FUSION_BLOCK_K`` has no counterpart: the
    kernel's K-slice depth follows its route, not a choice. Setting
    either flag (``set_flag``) drops the carried tiles.
``MXNET_DIST_BUCKET_BYTES`` (default 4194304)
    Read for parity of the flag surface: the default of the
    ``dist.bucket_bytes`` tunable, whose consumer (the mesh kvstore's
    gradient buckets) is not ported.
``MXNET_CONV_SPACE_TO_DEPTH`` (default 1)
    Read for parity of the flag surface. Its space-to-depth stem rewrite
    is a TPU lane-utilisation device and is not ported: the port's
    Convolution computes the same convolution directly.
``MXNET_FLASH_ATTENTION_BWD`` (default 1)
    Run the flash-attention backward as the tiled recompute kernels
    (parallel/flash_attention.py): the forward saves only (q, k, v, o,
    lse). 0 is the explicit escape hatch to dense autodiff of the plain
    formula, which materializes the T x T scores in the backward.
``MXNET_BACKWARD_DO_MIRROR`` (default 0)
    Rematerialize the training forward in the backward instead of storing
    its activations (``executor._maybe_mirror``): the reference's memory
    mirroring, as ``jax.checkpoint`` is in the JAX package.
``MXNET_FLASH_BLOCK_Q`` / ``MXNET_FLASH_BLOCK_K`` (1024),
``MXNET_FLASH_BWD_BLOCK_Q`` / ``MXNET_FLASH_BWD_BLOCK_K`` (512)
    Upper bounds of the flash kernels' rows a block (parallel/
    flash_attention.py) where no explicit argument and no
    ``flash_attention.fwd`` / ``.bwd`` entry names them: a pass takes its
    default rows (64 forward, 128 backward; 64 in fp32) capped at the
    largest compiled count within the bound. The defaults bound nothing.
``MXNET_GEN_PAGE_SIZE`` (16), ``MXNET_GEN_DECODE_BLOCKS`` (128),
``MXNET_GEN_MAX_BATCH`` (8), ``MXNET_GEN_MAX_SEQ`` (256),
``MXNET_GEN_POOL_PAGES`` (0 = max_batch x pages of max_seq + the trash
page), ``MXNET_GEN_QUEUE`` (64), ``MXNET_GEN_SUBMIT_TIMEOUT`` (0 ms = block
forever), ``MXNET_GEN_DEADLINE_MS`` (0 = none), ``MXNET_GEN_PREFIX_CACHE``
(0), ``MXNET_GEN_PREFIX_PAGES`` (0), ``MXNET_GEN_SLO_AGING_MS`` (500),
``MXNET_GEN_SPEC_K`` (0 = no speculation), ``MXNET_GEN_SPEC_NGRAM`` (2)
    The generation engine's knobs (serving/generation/engine.py), with the
    JAX package's defaults. ``MXNET_GEN_PREFILL_BUCKETS``,
    ``MXNET_GEN_BACKPRESSURE`` and ``MXNET_GEN_KV_DTYPE`` are strings read
    by the engine itself.
``MXNET_OBS_TS_INTERVAL_MS`` (1000), ``MXNET_OBS_TS_RETAIN`` (600)
    The time-series plane (observability/timeseries.py): the sampler's
    period in milliseconds (0 = ``start_sampler()`` starts none) and its
    ring depth in samples per instrument (at the default period, 10
    minutes of look-back).
``MXNET_AUTOSCALE_MIN`` (1), ``MXNET_AUTOSCALE_MAX`` (8),
``MXNET_AUTOSCALE_COOLDOWN_MS`` (30000)
    Replica autoscaling (serving/control/autoscale.py): the clamp bounds
    of every proposed replica count, and the least spacing between two
    actions.
``MXNET_IO_STREAMING`` (default 0)
    Backend switch of the ``ImageRecordIter`` factory: 1 returns the
    streaming pipeline (runtime/pipeline.py ``StreamingIter``), 0 keeps
    the synchronous shape (PrefetchingIter over ImageIter). An index-less
    ``.rec`` degrades to the synchronous backend with a warning; an
    explicit ``streaming=`` argument wins over the flag.
``MXNET_IO_DECODE_WORKERS`` (default 0 = auto: host cores, capped at 8)
    Decode worker count of the streaming pipeline. Resolution: explicit
    ``decode_workers=`` > ``io.decode_workers`` tuning-cache entry > this
    flag > auto. ``MXNET_IO_DECODE_BACKEND`` (``auto`` / ``process`` /
    ``thread``) is a string read by the pipeline itself.
``MXNET_IO_PREFETCH_DEPTH`` (default 2)
    Bound of the streaming pipeline's finished-batch queue, in batches
    (same resolution order, ``io.prefetch_depth``).
``MXNET_IO_STAGE_DEPTH`` (default 2)
    Batches the streaming pipeline keeps staged on the device ahead of
    the consumer (pinned host buffers, ``non_blocking`` copies); 1
    disables the overlap.
``MXNET_TELEMETRY_MEMSTATS`` (default 1)
    Under telemetry, sample the card's caching allocator
    (``torch.cuda.memory_allocated`` / ``max_memory_allocated``) into the
    ``hbm.live_bytes`` / ``hbm.peak_bytes`` gauges once per training step
    (host RSS on the CPU). 0 skips the sampling.
``MXNET_HEALTH`` (default ``off``)
    Active training-health policy (observability/health.py): one
    segmented non-finite reduction per step over loss/grads/params with
    grad-norm and update-to-param-ratio gauges. ``off`` keeps every wired
    call site on its no-op path; ``warn`` logs anomalies and dumps the
    flight recorder one step late; ``raise`` raises TrainingHealthError
    on the faulting step; ``skip_step`` additionally withholds the
    parameter update (``compile_step`` then copies the graph's results
    into the live tensors outside the graph, after the verdict) so
    weights stay bit-identical. String-valued and read straight from the
    environment (override at runtime with
    ``observability.health.set_policy``).
``MXNET_PERF`` (default 1)
    Roofline attribution layer (observability/perf.py): analytic
    FLOPs/HBM-bytes accounting per program, achieved-vs-roofline
    ``perf.mfu_pct`` / ``perf.hbm_util_pct`` from CUDA-event device spans,
    and the fit-loop step-time waterfall (data wait / host / blocked on
    the device / kvstore segments that sum to the step wall exactly).
    Cost walks run once per (program, shape signature); steady-state
    steps pay dict probes and two event records per program.
``MXNET_PERF_RING`` (default 64)
    Capacity of the per-step waterfall ring surfaced by the flight
    recorder's ``perf`` provider and ``/statusz``.
``MXNET_PROFILER_RING`` (default 200000)
    Bound of the profiler's in-memory event ring (profiler.py): beyond
    it the OLDEST events are evicted and counted
    (``profiler.dropped_events()``, the ``profiler.events_dropped``
    metric, ``droppedEventsCount`` in the dump).
``MXNET_PROFILER_MODE`` (default ``symbolic``)
    Initial profiler mode (``symbolic`` / ``imperative`` / ``all``) so a
    trace can be captured from an unmodified script via env alone.
    String-valued, read by profiler.py straight from the environment.
``MXNET_OBS_HTTP_PORT`` (default unset = off)
    Opt-in live exposition plane (observability/exposition.py): a stdlib
    HTTP daemon thread serving ``/metrics``, ``/statusz``, ``/healthz``,
    ``/tracez`` and ``/varz``. Set to a port (0 = ephemeral) before
    import, or call ``observability.exposition.start_http(port)``. Binds
    127.0.0.1 unless ``MXNET_OBS_HTTP_HOST`` widens it. String-valued,
    env-only (unset must mean "off", not port 0).
``MXNET_OBS_FLEET_INTERVAL_MS`` (1000), ``MXNET_OBS_FLEET_STALE_SCRAPES``
(3), ``MXNET_OBS_FLEET_DEAD_SCRAPES`` (10)
    The FleetAggregator (observability/fleet.py): its scrape period, and
    the consecutive failed scrapes before a worker is marked ``stale``
    and ``dead`` (a dead worker's series stop being appended, so they go
    stale in windowed queries).
``MXNET_RETRY_MAX`` (3), ``MXNET_RETRY_BASE_MS`` / ``MXNET_RETRY_MAX_MS``
(10 / 2000), ``MXNET_RETRY_DEADLINE_MS`` (30000; 0 = unbounded)
    The shared retry primitive (resilience/retry.py): attempts including
    the first, the first backoff and its doubling cap, and the wall-clock
    cap across all attempts, in milliseconds.
"""
import os

__all__ = ["get_flag", "set_flag"]

_overrides = {}

_DEFAULTS = {
    "MXNET_CONV_SPACE_TO_DEPTH": 1,
    "MXNET_BACKWARD_DO_MIRROR": 0,
    "MXNET_SERVING_MAX_WAIT_MS": 5,
    "MXNET_SERVING_QUEUE": 1024,
    "MXNET_SERVING_PIPELINE": 2,
    "MXNET_SERVING_DEADLINE_MS": 0,
    "MXNET_SERVING_COOLDOWN_MS": 1000,
    "MXNET_TELEMETRY": 0,
    "MXNET_OBS_TRACE_SAMPLE": 1,
    "MXNET_OBS_RESERVOIR": 32,
    "MXNET_HEALTH_RING": 256,
    "MXNET_TUNE": 0,
    "MXNET_TUNE_TRIALS": 12,
    "MXNET_COST_MODEL": 1,
    "MXNET_COST_MODEL_MIN_SAMPLES": 48,
    "MXNET_COST_MODEL_RETRAIN": 32,
    "MXNET_FUSION_BLOCK_M": 128,
    "MXNET_FUSION_BLOCK_N": 128,
    "MXNET_DIST_BUCKET_BYTES": 4 << 20,
    "MXNET_FUSION_KERNEL": 1,
    "MXNET_FUSION_MIN_BYTES": 0,
    "MXNET_FLASH_ATTENTION_BWD": 1,
    "MXNET_FLASH_BLOCK_Q": 1024,
    "MXNET_FLASH_BLOCK_K": 1024,
    "MXNET_FLASH_BWD_BLOCK_Q": 512,
    "MXNET_FLASH_BWD_BLOCK_K": 512,
    "MXNET_GEN_PAGE_SIZE": 16,
    "MXNET_GEN_DECODE_BLOCKS": 128,
    "MXNET_GEN_MAX_BATCH": 8,
    "MXNET_GEN_MAX_SEQ": 256,
    "MXNET_GEN_POOL_PAGES": 0,
    "MXNET_GEN_QUEUE": 64,
    "MXNET_GEN_SUBMIT_TIMEOUT": 0,
    "MXNET_GEN_DEADLINE_MS": 0,
    "MXNET_GEN_PREFIX_CACHE": 0,
    "MXNET_GEN_PREFIX_PAGES": 0,
    "MXNET_GEN_SLO_AGING_MS": 500,
    "MXNET_GEN_SPEC_K": 0,
    "MXNET_GEN_SPEC_NGRAM": 2,
    "MXNET_OBS_TS_INTERVAL_MS": 1000,
    "MXNET_OBS_TS_RETAIN": 600,
    "MXNET_AUTOSCALE_MIN": 1,
    "MXNET_AUTOSCALE_MAX": 8,
    "MXNET_AUTOSCALE_COOLDOWN_MS": 30000,
    "MXNET_IO_STREAMING": 0,
    "MXNET_IO_DECODE_WORKERS": 0,
    "MXNET_IO_PREFETCH_DEPTH": 2,
    "MXNET_IO_STAGE_DEPTH": 2,
    "MXNET_TELEMETRY_MEMSTATS": 1,
    "MXNET_PERF": 1,
    "MXNET_PERF_RING": 64,
    "MXNET_PROFILER_RING": 200000,
    "MXNET_OBS_FLEET_INTERVAL_MS": 1000,
    "MXNET_OBS_FLEET_STALE_SCRAPES": 3,
    "MXNET_OBS_FLEET_DEAD_SCRAPES": 10,
    "MXNET_RETRY_MAX": 3,
    "MXNET_RETRY_BASE_MS": 10,
    "MXNET_RETRY_MAX_MS": 2000,
    "MXNET_RETRY_DEADLINE_MS": 30000,
}


def get_flag(name, default=None):
    """Integer-valued flag: override > environment > default."""
    if name in _overrides:
        return _overrides[name]
    if default is None:
        default = _DEFAULTS.get(name, 0)
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _apply_telemetry(value):
    # keep the registry's cached switch in sync with the flag
    from .observability import metrics as _metrics

    _metrics._enabled = bool(value)


def _apply_obs_sample(value):
    # keep request_trace's cached sampling rate coherent with the flag
    from .observability import request_trace as _rtrace

    _rtrace._apply_sample_flag(value)


def _apply_perf(value):
    # keep perf's cached activity switch coherent with the flag
    from .observability import perf as _perf

    _perf._apply_perf_flag(value)


def _apply_tuning(value):
    # the kernel wrappers and programs carry what they resolved under the
    # tuning flags; a new value takes effect at their next resolution
    from .autotune import cache as _tune_cache

    _tune_cache.drop_carried()


_APPLIERS = {"MXNET_TELEMETRY": _apply_telemetry,
             "MXNET_OBS_TRACE_SAMPLE": _apply_obs_sample,
             "MXNET_PERF": _apply_perf}
_APPLIERS.update(dict.fromkeys(
    ("MXNET_TUNE", "MXNET_FUSION_BLOCK_M", "MXNET_FUSION_BLOCK_N",
     "MXNET_FLASH_BLOCK_Q", "MXNET_FLASH_BWD_BLOCK_Q",
     "MXNET_FLASH_BWD_BLOCK_K"), _apply_tuning))


def set_flag(name, value):
    """Programmatic override (None clears it)."""
    if value is None:
        _overrides.pop(name, None)
    else:
        _overrides[name] = int(value)
    if name in _APPLIERS:
        _APPLIERS[name](get_flag(name))
