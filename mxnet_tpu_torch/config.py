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
    Tuning-cache mode (autotune/cache.py): 0 consults the cache, -1
    bypasses every lookup. The search of mode 1 is not ported (ROADMAP
    A13).
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
    Read for parity of the flag surface. They bound the TPU kernels' VMEM
    blocks; the CUDA kernels pick their own tiles (64 x 64, sized for
    shared memory and registers) and mask ragged T, so they have no use
    for them.
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


_APPLIERS = {"MXNET_TELEMETRY": _apply_telemetry,
             "MXNET_OBS_TRACE_SAMPLE": _apply_obs_sample}


def set_flag(name, value):
    """Programmatic override (None clears it)."""
    if value is None:
        _overrides.pop(name, None)
    else:
        _overrides[name] = int(value)
    if name in _APPLIERS:
        _APPLIERS[name](get_flag(name))
