"""Search-based autotuner: the counterpart of ``mxnet_tpu/autotune/``.

Turns the hand-picked performance constants (the fused-matmul and
flash-attention tiles, the serving bucket ladder, per-graph layout and
remat, the generation, control-plane and input-pipeline knobs) into one
tuned, persisted, observable subsystem:

* :mod:`.registry` — call sites declare their knob and its search space
  (``flash_attention.fwd`` / ``.bwd``, ``serving.buckets``,
  ``exec.remat``; the knobs without one in-package call site are
  declared here);
* :mod:`.cost_model` — analytic roofline costs at the card's measured
  ceilings prune and rank candidates (a tile the kernel does not compile,
  or whose shared memory a block cannot hold, is ``inf``);
* :mod:`.learned` — a ridge model over measured samples re-ranks them
  once its holdout gate passes;
* :mod:`.search` — measured search decides (median of k, warmup
  discarded, the default tile or value always measured first);
* :mod:`.cache` — winners persist per device fingerprint in
  ``MXNET_TUNE_CACHE`` (default ``~/.cache/mxnet_tpu_torch/tuning.json``),
  the JAX package's file format; consumers pay one dict probe when they
  build a program, region or object, and the kernel wrappers and programs
  carry what they resolved in a :class:`cache.Carry`, emptied when the
  entries or a tuning flag change;
* :mod:`.tuners` — one measured tuner per knob family, each driving the
  live object on the card (kernels, ``InferenceServer``, ``Generator``,
  ``Module``, ``StreamingIter``).

Modes (``MXNET_TUNE``): ``0`` (default) consult the cache, never measure;
``1`` additionally search on a miss at the shape-local call sites (the
fused-matmul and flash tiles), never while a stream is capturing a CUDA
graph; ``-1`` bypass lookups entirely (the A/B baseline).
"""
from . import cache, cost_model, learned, registry, search
from .cache import (cache_path, device_fingerprint, entries, lookup,
                    lookup_entry, note_measurements, record, reload, reset,
                    reset_stats, save, scrub_stale, stats)
from .registry import declare, get as get_tunable, names as tunable_names
from .search import SearchConfig, SearchResult, median_time, tune_and_record

__all__ = ["cache", "registry", "cost_model", "learned", "search",
           "cache_path", "device_fingerprint", "entries", "lookup",
           "lookup_entry", "lookup_or_tune", "note_measurements", "record",
           "reload", "reset", "reset_stats", "save", "scrub_stale", "stats",
           "declare", "get_tunable", "tunable_names", "SearchConfig",
           "SearchResult", "median_time", "tune_and_record", "mode",
           "enabled", "tune_flash_attention", "tune_fused_matmul",
           "tune_serving_buckets", "tune_layout", "tune_remat",
           "tune_generation", "tune_generation_kv", "tune_generation_spec",
           "tune_quantize_layers", "tune_input_pipeline", "tune_control",
           "flash_shape_key"]


# the layout knob has no single in-package call site (models take
# layout= at construction), so it is declared here at package import:
# registry.get("graph.layout") works without the lazily loaded tuners
declare(
    "graph.layout",
    space={"layout": ("NHWC", "NCHW")},
    default=lambda ctx: {"layout": str(ctx.get("default", "NHWC"))},
    doc="Per-graph data layout, consulted by the layout graph pass at "
        "bind (graph_pass/passes.py run_layout). Measured through a "
        "caller-supplied train/infer step (tune_layout).")


def _flag_default(field, flag):
    # flags resolve at consult time, not at import, so env/config
    # ordering doesn't matter
    def default(ctx):
        from ..config import get_flag

        return {field: get_flag(flag)}
    return default


# generation-subsystem knobs: consulted by serving/generation/engine.py
# (explicit GenerationConfig arg > tuning cache > MXNET_GEN_* flag),
# measured by tuners.tune_generation. The consuming engine loads lazily,
# so the declarations live here where a fresh process registers them
declare(
    "generation.page_size",
    space={"page_size": (8, 16, 32, 64)},
    default=_flag_default("page_size", "MXNET_GEN_PAGE_SIZE"),
    doc="KV-cache page size in tokens: allocation granularity of the "
        "paged generation cache (small pages waste less on short "
        "sequences; large pages gather in fewer, longer runs).")
declare(
    "generation.decode_blocks",
    space=lambda ctx: {"decode_blocks": tuple(
        b for b in (32, 64, 128, 256, 512)
        if b <= int(ctx.get("max_seq", 512))) or (32,)},
    default=_flag_default("decode_blocks", "MXNET_GEN_DECODE_BLOCKS"),
    doc="Decode-attention key-block bound in tokens "
        "(paged_decode_attention's online-softmax streaming window).")


def _kv_dtypes():
    # the engine owns the valid dtype set (KV_DTYPES); resolving it
    # lazily keeps the space, the default and the engine in lockstep
    from ..serving.generation.engine import KV_DTYPES

    return KV_DTYPES


def _kv_dtype_default(ctx):
    # MXNET_GEN_KV_DTYPE is a string env, not an integer get_flag
    import os

    val = os.environ.get("MXNET_GEN_KV_DTYPE", "").strip().lower()
    return {"kv_dtype": val if val in _kv_dtypes() else "model"}


declare(
    "generation.kv_dtype",
    space=lambda ctx: {"kv_dtype": tuple(sorted(_kv_dtypes()))},
    default=_kv_dtype_default,
    doc="KV-page storage dtype of the paged decode cache: int8 pages carry "
        "per-(position, head) fp32 scales and dequantize inside the "
        "online-softmax recurrence. tune_generation_kv arbitrates the "
        "candidates against a measured token-agreement budget.")
declare(
    "generation.spec_k",
    space={"spec_k": (0, 1, 2, 4, 8)},
    default=_flag_default("spec_k", "MXNET_GEN_SPEC_K"),
    doc="Speculation depth of the generation engine: draft tokens "
        "proposed per slot per step, all verified in one batched step "
        "(0 = speculation off); measured by tune_generation_spec.")
# distributed-training knob: declared for parity of the registry; its
# consumer (the mesh kvstore's gradient buckets) is not ported yet
declare(
    "dist.bucket_bytes",
    space={"bucket_bytes": (1 << 20, 4 << 20, 16 << 20, 64 << 20)},
    default=_flag_default("bucket_bytes", "MXNET_DIST_BUCKET_BYTES"),
    doc="Gradient-bucket size in bytes for the mesh kvstore's fused "
        "collectives (declared only: its consumer is not ported).")
# serving-control-plane knobs: consulted by the generation engine at
# construction (explicit GenerationConfig arg > tuning cache >
# MXNET_GEN_* flag), measured by tuners.tune_control
declare(
    "control.prefix_pages",
    space=lambda ctx: {"prefix_pages": tuple(sorted(set(
        max(1, int(ctx.get("pool_pages", 64)) * f // 8)
        for f in (1, 2, 4, 8)))) or (8,)},
    default=_flag_default("prefix_pages", "MXNET_GEN_PREFIX_PAGES"),
    doc="Prefix-cache capacity in KV pages: a larger cache keeps more "
        "cold prefixes resident but competes with live sequences for pool "
        "pages.")
declare(
    "control.slo_aging",
    space={"aging_ms": (0, 100, 250, 500, 1000, 2000)},
    default=_flag_default("aging_ms", "MXNET_GEN_SLO_AGING_MS"),
    doc="SLO-admission aging interval in ms: queue wait per one-tier "
        "effective-priority boost (0 = strict priority).")
declare(
    "quantize.layers",
    space={},
    default=None,
    doc="Per-layer precision of the int8 graph pass: the cached value's "
        "{'skip': [op names]} pins layers to fp32 (tune_quantize_layers), "
        "keyed by graph fingerprint; run_quantize consults it at every "
        "bind.")
# input-pipeline knobs: consulted by runtime/pipeline.py at StreamingIter
# construction (explicit arg > tuning cache under io_pipeline_key > flag >
# auto), measured by tuners.tune_input_pipeline
declare(
    "io.decode_workers",
    space=lambda ctx: {"workers": tuple(sorted(set(
        w for w in (1, 2, 4, 8, 16,
                    int(ctx.get("cpus", 4)),
                    max(1, int(ctx.get("cpus", 4)) // 2))
        if w <= int(ctx.get("cpus", 4)))))},
    default=_flag_default("workers", "MXNET_IO_DECODE_WORKERS"),
    doc="Decode/augment worker-pool size of the streaming input "
        "pipeline: throughput scales with workers until the host's cores "
        "saturate.")
declare(
    "io.prefetch_depth",
    space={"depth": (2, 3, 4, 6, 8)},
    default=_flag_default("depth", "MXNET_IO_PREFETCH_DEPTH"),
    doc="Finished-batch queue bound of the streaming input pipeline, in "
        "batches: how far decode may run ahead of the consumer.")


# fused-matmul tiles: consulted by parallel/fused.py resolve_blocks
# (explicit call arg > tuning cache under the pow2 shape-bucket key, with
# "tc" appended on the tensor-core route > the launch's rule within the
# MXNET_FUSION_BLOCK_* bounds), measured by tuners.tune_fused_matmul. The
# space is the compiled tiles of the launch's route (ctx["route"],
# cost_model.FUSED_TILES); every other combination costs inf
def _fusion_default(ctx):
    from ..config import get_flag

    route = ctx.get("route", "simt")
    tile = cost_model.fused_default_tile(
        int(ctx.get("B", 1)), int(ctx.get("M", 1024)),
        int(ctx.get("N", 1024)),
        bound=min(get_flag("MXNET_FUSION_BLOCK_M"),
                  get_flag("MXNET_FUSION_BLOCK_N")), route=route)
    if route == "tc":
        return {"block_m": tile[0], "block_n": tile[1],
                "block_k": cost_model.FUSED_TILES["tc"][tile][0]}
    return {"block_m": tile, "block_n": tile,
            "block_k": cost_model.FUSED_TILES["simt"][tile][0]}


def _fusion_space(ctx):
    tiles = cost_model.FUSED_TILES[ctx.get("route", "simt")]
    if ctx.get("route", "simt") == "tc":
        return {"block_m": tuple(sorted({t[0] for t in tiles})),
                "block_n": tuple(sorted({t[1] for t in tiles})),
                "block_k": tuple(sorted({d[0] for d in tiles.values()}))}
    edges = tuple(sorted(tiles))
    depths = tuple(sorted(tiles[e][0] for e in edges))
    return {"block_m": edges, "block_n": edges, "block_k": depths}


declare(
    "fusion.blocks",
    space=_fusion_space,
    default=_fusion_default,
    cost=cost_model.fused_matmul_cost,
    doc="Fused matmul+epilogue output tile (parallel/fused.py) on the "
        "launch's route: on the CUDA-core route the tile edge (block_m = "
        "block_n, 128 or 64), with block_k the deepest K slice the edge "
        "compiles (recorded; the kernel's form picks the depth it runs); "
        "on the tensor-core route of 16-bit operands (block_m, block_n) "
        "of 128 or 64 each, block_k 64 (a stage). Keyed per pow2 (M, N, "
        "K) shape bucket, the tensor-core route's key ending in \"tc\".")


def mode():
    """MXNET_TUNE: -1 bypass, 0 consult-only (default), 1 search on
    miss."""
    from ..config import get_flag

    return get_flag("MXNET_TUNE")


def enabled():
    return mode() >= 0


def _capturing():
    """True while the current CUDA stream is capturing a graph: no search
    may run then (its launches would land in the graph)."""
    import torch

    return bool(torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


def lookup_or_tune(op, key, dtype=None, ctx=None):
    """The consulting call sites' entry point.

    Hit → the tuned value (one dict probe). Miss → None (the caller takes
    its default), EXCEPT when ``MXNET_TUNE=1`` and no stream is capturing
    a CUDA graph: then the op's auto-tuner runs a measured search on the
    spot, records the winner, and returns it. A miss during a capture
    never searches and returns None, so the captured launch takes its
    default tile; a failed search logs and returns None.
    """
    if mode() < 0:
        return None
    val = cache.lookup(op, key, dtype)
    if val is not None or mode() != 1:
        return val
    if _capturing():
        return None
    import importlib

    _fn = getattr(importlib.import_module(__name__ + ".tuners"),
                  "auto_tune")
    try:
        return _fn(op, key, dict(ctx or {}))
    except Exception as err:  # tuning is an optimization, never a crash
        import logging

        logging.getLogger(__name__).warning(
            "autotune: search for %s failed (%r); using defaults", op, err)
        return None


def __getattr__(name):
    # the tuners import serving, parallel and module lazily; loading them
    # on first use keeps `import mxnet_tpu_torch` free of that path
    # (importlib, not `from . import`: the latter probes this very
    # __getattr__ through hasattr and recurses)
    if name in ("tune_flash_attention", "tune_fused_matmul",
                "tune_serving_buckets",
                "tune_layout", "tune_remat", "tune_generation",
                "tune_generation_kv", "tune_generation_spec",
                "tune_quantize_layers",
                "tune_input_pipeline", "tune_control",
                "control_replay_measurer", "pipeline_replay_measurer",
                "generation_replay_measurer", "serving_replay_measurer",
                "flash_shape_key", "tuners"):
        import importlib

        tuners = importlib.import_module(__name__ + ".tuners")
        return tuners if name == "tuners" else getattr(tuners, name)
    raise AttributeError(name)
