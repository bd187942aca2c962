"""Concrete tuners: build a real measurer for each declared tunable and
drive the search.

Counterpart of ``mxnet_tpu/autotune/tuners.py``. Each ``tune_*`` function
is the explicit "tune once, ship the cache" entry point for one knob
family, measuring the live object on the card (or where the caller's
tensors and objects live):

* :func:`tune_flash_attention` — the rows a block owns of the flash
  forward and backward kernels, timing the kernels at the given shape
  through the per-call block arguments;
* :func:`tune_fused_matmul` — the fused matmul's output tile at one
  (M, N, K) shape;
* :func:`tune_serving_buckets` — replays a traffic sample of request sizes
  against a live :class:`~..serving.InferenceServer` per candidate ladder;
* :func:`tune_generation`, :func:`tune_generation_spec`,
  :func:`tune_control` — a live :class:`~..serving.generation.Generator`
  per candidate (its captured prefill and decode steps);
* :func:`tune_generation_kv` and :func:`tune_quantize_layers` — the int8
  paths' measured arbitrations against an accuracy budget;
* :func:`tune_layout` / :func:`tune_remat` — generic measured choices over
  a caller-supplied step measurer (a ``Module`` bound per candidate);
* :func:`tune_input_pipeline` — a live ``StreamingIter`` per candidate.

:func:`auto_tune` is the ``MXNET_TUNE=1`` miss hook: shape-local knobs
(the flash and fused tiles) tune on the spot from their call-site
context; workload-dependent knobs need a traffic sample or a step and
tune only through their explicit entry point.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ..base import MXNetError
from . import cache, registry
from .cost_model import pow2_at_least as _pow2_at_least
from .search import SearchConfig, median_time, search

__all__ = ["flash_shape_key", "kernel_time", "tune_flash_attention",
           "tune_fused_matmul",
           "model_key", "serving_replay_measurer", "tune_serving_buckets",
           "tune_layout", "tune_remat", "tune_generation",
           "tune_generation_kv", "tune_generation_spec",
           "tune_quantize_layers", "tune_control",
           "generation_replay_measurer", "control_replay_measurer",
           "pipeline_replay_measurer", "tune_input_pipeline", "auto_tune"]


def flash_shape_key(T, D, causal):
    """Shape-bucket key for flash-attention entries: T rounds up to a
    power of two (one tuning per T-bucket, not per exact length)."""
    return ("T%d" % _pow2_at_least(int(T)), "D%d" % int(D),
            "causal" if causal else "full")


def _device(device):
    import torch

    return torch.device(device if device is not None else "cuda")


def kernel_time(fn, cfg, calls=20):
    """Median seconds of one ``fn()`` call on the card: ``calls`` calls
    captured into a CUDA graph (after ``cfg.warmup`` + 1 eager runs on a
    side stream), replayed ``cfg.repeats`` times between CUDA events. A
    kernel of tens of microseconds launched from Python one call at a time
    measures the host's launch cost, the same for every tile, more than
    the card's time, which is what a tile changes. Off the card it is
    :func:`median_time` of one call."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return median_time(fn, repeats=cfg.repeats, warmup=cfg.warmup)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(cfg.warmup + 1):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(cfg.repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3 / calls)
    times.sort()
    return times[len(times) // 2]


def tune_flash_attention(T, D=64, B=1, H=4, dtype="bfloat16", causal=True,
                         forward=True, backward=True, trials=None, repeats=3,
                         fwd_blocks=None, device=None):
    """Measured search over the flash kernels' rows a block at one (T, D)
    shape; records ``flash_attention.fwd`` (and ``.bwd``) cache entries
    under the shape-bucket key. Returns ``{op: winning value dict}``.

    ``forward=False`` skips the forward sweep (and leaves any existing
    fwd entry untouched); the backward measurer then runs on
    ``fwd_blocks`` (or the forward's default) — the bwd-only path
    :func:`auto_tune` uses when only the bwd entry is missing. The
    measurement runs on ``device`` (default the current card): the forward
    alone, then forward and backward together (the JAX package's
    ``jax.grad`` of the loss), each candidate's card time from CUDA-graph
    replays (:func:`kernel_time`).
    """
    import torch

    from ..base import dtype_name, torch_dtype
    from ..parallel.flash_attention import _fwd_default, flash_attention

    dev = _device(device)
    dt = torch_dtype(dtype)
    rng = np.random.RandomState(0)
    q, k, v = (torch.tensor(rng.randn(B, H, T, D), dtype=torch.float32)
               .to(device=dev, dtype=dt) for _ in range(3))
    key = flash_shape_key(T, D, causal)
    ctx = {"T": T, "D": D, "B": B, "H": H, "causal": causal,
           "dtype_bytes": torch.empty((), dtype=dt).element_size()}
    cfg = SearchConfig(trials=trials, repeats=repeats, warmup=1)
    name = dtype_name(dt)
    out = {}

    if forward:
        def fwd_measure(c):
            def run():
                with torch.no_grad():
                    flash_attention(q, k, v, causal=causal,
                                    block_q=int(c["block_q"]),
                                    block_k=int(c["block_k"]))

            return kernel_time(run, cfg)

        res_f = search(registry.get("flash_attention.fwd"), fwd_measure,
                       ctx=ctx, cfg=cfg)
        cache.record("flash_attention.fwd", key, res_f.best, dtype=name,
                     ms=res_f.best_s * 1e3, trials=res_f.measured)
        out["flash_attention.fwd"] = res_f.best
        fwd_blocks = (int(res_f.best["block_q"]),
                      int(res_f.best["block_k"]))
    elif fwd_blocks is None:
        d = _fwd_default(ctx)
        fwd_blocks = (d["block_q"], d["block_k"])

    if backward:
        fq, fk = int(fwd_blocks[0]), int(fwd_blocks[1])
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def bwd_measure(c):
            def run():
                o = flash_attention(*leaves, causal=causal, block_q=fq,
                                    block_k=fk,
                                    block_q_bwd=int(c["block_q"]),
                                    block_k_bwd=int(c["block_k"]))
                torch.autograd.grad(o.float().sum(), leaves)

            return kernel_time(run, cfg)

        res_b = search(registry.get("flash_attention.bwd"), bwd_measure,
                       ctx=ctx, cfg=cfg)
        cache.record("flash_attention.bwd", key, res_b.best, dtype=name,
                     ms=res_b.best_s * 1e3, trials=res_b.measured)
        out["flash_attention.bwd"] = res_b.best
    return out


def tune_fused_matmul(M, N, K, dtype="float32", epilogue=(("bias",),
                                                          ("act", "relu")),
                      wt=True, trials=None, repeats=3, device=None):
    """Measured search over the fused matmul+epilogue kernel's tile at one
    (M, N, K) shape (parallel/fused.py), among the tiles of the route the
    shape takes at ``dtype`` in the ``wt`` form (the tensor-core route's
    for aligned bf16 / fp16 operands); records a ``fusion.blocks`` entry
    under that route's key (``fused_tile_key``) and returns the winning
    value dict.

    The default epilogue — bias + relu — is the modal carved region; the
    tile choice is dominated by the product, not the epilogue arithmetic,
    so one sweep serves every region at the shape bucket.
    """
    import torch

    from ..base import dtype_name, torch_dtype
    from ..parallel.fused import fused_matmul, fused_tile_key, route

    dev = _device(device)
    dt = torch_dtype(dtype)
    rng = np.random.RandomState(0)

    def arr(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.float32).to(
            device=dev, dtype=dt)

    x = arr(M, K)
    w = arr(N, K) if wt else arr(K, N)
    extras = []
    steps = tuple(tuple(s) if isinstance(s, (list, tuple)) else (s,)
                  for s in epilogue)
    for s in steps:
        if s[0] in ("bias", "vmul", "vadd"):
            extras.append(arr(N))
        elif s[0] == "res":
            extras.append(arr(M, N))
    path = route(x.dtype, w.dtype, N, K, wt, x.data_ptr(), w.data_ptr())
    key = fused_tile_key(M, N, K, path)
    ctx = {"M": int(M), "N": int(N), "K": int(K),
           "dtype_bytes": x.element_size(), "route": path}
    cfg = SearchConfig(trials=trials, repeats=repeats, warmup=1)

    def measure(c):
        return kernel_time(
            lambda: fused_matmul(x, w, extras=extras, epilogue=steps, wt=wt,
                                 block_m=int(c["block_m"]),
                                 block_n=int(c["block_n"]),
                                 block_k=int(c["block_k"])), cfg)

    res = search(registry.get("fusion.blocks"), measure, ctx=ctx, cfg=cfg)
    cache.record("fusion.blocks", key, res.best, dtype=dtype_name(dt),
                 ms=res.best_s * 1e3, trials=res.measured,
                 extra={"ranker": res.ranker})
    return res.best


def model_key(symbol):
    """Stable fingerprint of a Symbol graph (the executor's program
    tuning key)."""
    from ..executor import _GraphProgram

    return _GraphProgram(symbol).tuning_key()


def serving_replay_measurer(symbol, arg_params, data_shapes, sizes,
                            aux_params=None, max_wait_ms=2, devices=None,
                            repeats=3, warmup=1):
    """``measure(candidate)`` for bucket-ladder candidates: build a live
    InferenceServer with the candidate ladder, warm every bucket (each
    bucket's program captured), replay the traffic sample, return median
    wall seconds. One protocol shared by :func:`tune_serving_buckets` and
    any benchmark comparison, so the two cannot drift apart."""
    from ..serving import InferenceServer, ServingConfig

    row_shapes = [tuple(d[1][1:]) for d in data_shapes]

    def _request(n):
        arrs = [np.zeros((n,) + s, np.float32) for s in row_shapes]
        return arrs[0] if len(arrs) == 1 else arrs

    def measure(c):
        server = InferenceServer(
            symbol, arg_params, aux_params, data_shapes=data_shapes,
            devices=devices,
            config=ServingConfig(buckets=c["buckets"],
                                 max_wait_ms=max_wait_ms))
        try:
            server.warmup()

            def run():
                futs = [server.submit(_request(n)) for n in sizes]
                for f in futs:
                    f.result(timeout=300)

            return median_time(run, repeats=repeats, warmup=warmup)
        finally:
            server.stop(drain=True)

    return measure


def tune_serving_buckets(symbol, arg_params, data_shapes, sizes,
                         aux_params=None, traffic_key="default",
                         trials=None, max_wait_ms=2, measure=None,
                         devices=None):
    """Measured search over serving bucket ladders for one model and one
    traffic shape (``sizes``: a sample of request row counts). Each
    candidate ladder serves the whole sample on a live InferenceServer;
    wall time decides. Records the winner under BOTH the quantized
    traffic signature and ``traffic_key`` (the ladder a plain
    ``InferenceServer(...)`` construction picks up). Returns the winning
    ladder as a list.

    ``measure`` (tests) replaces the live-server measurer:
    ``measure(candidate) -> seconds``.
    """
    sizes = [int(n) for n in sizes]
    if not sizes:
        raise ValueError("need a non-empty traffic sample")
    mkey = model_key(symbol)
    ctx = {"sizes": sizes, "max_size": max(sizes)}
    cfg = SearchConfig(trials=trials, repeats=3, warmup=1)

    if measure is None:
        measure = serving_replay_measurer(
            symbol, arg_params, data_shapes, sizes,
            aux_params=aux_params, max_wait_ms=max_wait_ms,
            devices=devices, repeats=cfg.repeats, warmup=cfg.warmup)

    res = search(registry.get("serving.buckets"), measure, ctx=ctx, cfg=cfg)
    ladder = sorted(int(b) for b in res.best["buckets"])
    value = {"buckets": ladder}
    from ..serving.buckets import traffic_signature

    cache.record("serving.buckets", (mkey, traffic_signature(sizes)),
                 value, ms=res.best_s * 1e3, trials=res.measured)
    cache.record("serving.buckets", (mkey, traffic_key), value,
                 ms=res.best_s * 1e3, trials=res.measured)
    return ladder


def generation_replay_measurer(model, params, prompts, max_new=8,
                               max_batch=4, max_seq=128, fixed=None,
                               repeats=2, warmup=1):
    """``measure(candidate)`` for generation knobs: build a live
    continuous-batching :class:`~..serving.generation.Generator` with the
    candidate knob (merged over ``fixed``), warm every program (its
    prefill buckets and decode step captured), replay the prompt sample
    end to end, return median wall seconds. Shared by
    :func:`tune_generation` and benchmark comparisons so both measure the
    same protocol."""
    from ..serving.generation import (GenerationConfig, Generator,
                                      SamplingParams)

    def measure(c):
        kw = dict(fixed or {})
        kw.update(c)
        gen = Generator(model, params,
                        GenerationConfig(max_batch=max_batch,
                                         max_seq=max_seq, **kw))
        try:
            gen.warmup()
            sp = SamplingParams(max_new_tokens=max_new)

            def run():
                handles = [gen.submit(p, sp) for p in prompts]
                for h in handles:
                    h.result(timeout=300)

            return median_time(run, repeats=repeats, warmup=warmup)
        finally:
            gen.stop(drain=True)

    return measure


def _default_prompts(model, max_seq, max_new):
    vocab = int(model.cfg["vocab"])
    rng = np.random.RandomState(0)
    # every sample length must satisfy the generator's admission bound
    # (prompt + max_new <= max_seq), not just the largest
    top = max(1, max_seq - max_new)
    lengths = sorted({min(n, top) for n in (3, 9, 17, 29)})
    return [list(rng.randint(1, vocab, size=n) % vocab) for n in lengths]


def tune_generation(model, params, prompts=None, max_new=8, max_batch=4,
                    max_seq=128, trials=None, measure=None):
    """Measured search over ``generation.page_size`` and
    ``generation.decode_blocks`` for one checkpoint + slot geometry: each
    candidate serves a mixed-length prompt sample on a live
    continuous-batching generator; wall time decides. The two knobs are
    searched in turn (page size first, then decode blocks at the winning
    page size). Records both under the generator's tuning key
    (``generation_tune_key``) so a plain ``Generator(model, params)``
    construction picks the winners up. Returns ``{op: value dict}``.

    ``measure`` (tests) replaces the live-generator measurer:
    ``measure(candidate) -> seconds``.
    """
    from ..serving.generation.engine import generation_tune_key

    if prompts is None:
        prompts = _default_prompts(model, max_seq, max_new)
    prompts = [[int(t) for t in p] for p in prompts]
    key = generation_tune_key(model, max_batch, max_seq)
    ctx = {"max_seq": max_seq}
    cfg = SearchConfig(trials=trials, repeats=2, warmup=1)
    out = {}

    page_measure = measure or generation_replay_measurer(
        model, params, prompts, max_new=max_new, max_batch=max_batch,
        max_seq=max_seq, repeats=cfg.repeats, warmup=cfg.warmup)
    res_p = search(registry.get("generation.page_size"), page_measure,
                   ctx=ctx, cfg=cfg)
    cache.record("generation.page_size", key, res_p.best,
                 ms=res_p.best_s * 1e3, trials=res_p.measured)
    out["generation.page_size"] = res_p.best

    blk_measure = measure or generation_replay_measurer(
        model, params, prompts, max_new=max_new, max_batch=max_batch,
        max_seq=max_seq, fixed=dict(res_p.best),
        repeats=cfg.repeats, warmup=cfg.warmup)
    res_b = search(registry.get("generation.decode_blocks"), blk_measure,
                   ctx=ctx, cfg=cfg)
    cache.record("generation.decode_blocks", key, res_b.best,
                 ms=res_b.best_s * 1e3, trials=res_b.measured)
    out["generation.decode_blocks"] = res_b.best
    return out


def tune_generation_spec(model, params, prompts=None, max_new=16,
                         max_batch=4, max_seq=128, trials=None,
                         measure=None):
    """Measured search over ``generation.spec_k`` (speculation depth) for
    one checkpoint + slot geometry: each candidate k (0 = off included, so
    speculation must beat the plain decode loop to win) serves a prompt
    sample on a live generator through the shared replay measurer; wall
    time decides. The default sample is repetition-heavy (cyclic token
    patterns the n-gram proposer can hit); pass real prompts for
    production numbers. Records the winner under ``generation_tune_key``.
    Returns ``{"generation.spec_k": value dict}``.

    ``measure`` (tests) replaces the live-generator measurer.
    """
    from ..serving.generation.engine import generation_tune_key

    if prompts is None:
        vocab = int(model.cfg["vocab"])
        rng = np.random.RandomState(0)
        top = max(1, max_seq - max_new)
        prompts = []
        for n, period in ((12, 3), (17, 2), (24, 4), (31, 5)):
            pat = [int(t) for t in rng.randint(1, vocab, size=period)]
            reps = min(n, top) // period + 1
            prompts.append((pat * reps)[:min(n, top)])
    prompts = [[int(t) for t in p] for p in prompts]
    key = generation_tune_key(model, max_batch, max_seq)
    cfg = SearchConfig(trials=trials, repeats=2, warmup=1)
    mk = measure if measure is not None else generation_replay_measurer(
        model, params, prompts, max_new=max_new, max_batch=max_batch,
        max_seq=max_seq, repeats=cfg.repeats, warmup=cfg.warmup)
    res = search(registry.get("generation.spec_k"), mk,
                 ctx={"max_seq": max_seq}, cfg=cfg)
    cache.record("generation.spec_k", key, res.best,
                 ms=res.best_s * 1e3, trials=res.measured)
    return {"generation.spec_k": res.best}


def control_replay_measurer(model, params, prompts=None, shared_prefix=32,
                            max_new=8, max_batch=4, max_seq=128,
                            fixed=None, repeats=2, warmup=1):
    """``measure(candidate)`` for the serving-control-plane knobs: build a
    live Generator with the prefix cache on and the candidate knob (merged
    over ``fixed``), replay a shared-prefix prompt sample twice (the first
    pass seeds the radix tree, the second serves from it), return median
    wall seconds. The replay is mixed-class, so the aging knob is live
    during its own search."""
    from ..serving.generation import (GenerationConfig, Generator,
                                      SamplingParams)

    if prompts is None:
        vocab = int(model.cfg["vocab"])
        rng = np.random.RandomState(0)
        head = [int(t) for t in rng.randint(1, vocab, size=shared_prefix)]
        top = max(1, max_seq - max_new - shared_prefix)
        prompts = [head + [int(t) for t in rng.randint(
            1, vocab, size=1 + (n % top))] for n in (3, 9, 17, 29)]

    # knob fields -> GenerationConfig keyword names
    _ARGS = {"prefix_pages": "prefix_pages", "aging_ms": "slo_aging_ms"}
    _TIERS = ("interactive", "standard", "batch")

    def measure(c):
        merged = dict(fixed or {})
        merged.update(c)
        kw = {_ARGS.get(k, k): v for k, v in merged.items()}
        gen = Generator(model, params,
                        GenerationConfig(max_batch=max_batch,
                                         max_seq=max_seq,
                                         prefix_cache=True, **kw))
        try:
            gen.warmup()
            sp = SamplingParams(max_new_tokens=max_new)

            def run():
                for _ in range(2):  # pass 1 seeds, pass 2 hits
                    handles = [gen.submit(p, sp, slo=_TIERS[i % 3])
                               for i, p in enumerate(prompts)]
                    for h in handles:
                        h.result(timeout=300)

            return median_time(run, repeats=repeats, warmup=warmup)
        finally:
            gen.stop(drain=True)

    return measure


def tune_control(model, params, prompts=None, shared_prefix=32, max_new=8,
                 max_batch=4, max_seq=128, trials=None, measure=None):
    """Measured search over the serving control plane's two knobs —
    ``control.prefix_pages`` (prefix-cache capacity) then
    ``control.slo_aging`` (admission aging interval) at the winning
    capacity — on a shared-prefix replay. Records both under the
    generator's tuning key. Returns ``{op: value dict}``.

    ``measure`` (tests) replaces the live-generator measurer.
    """
    from ..serving.generation.engine import generation_tune_key

    key = generation_tune_key(model, max_batch, max_seq)
    # capacity candidates scale off the default pool geometry (the
    # auto-sized pool at the flag-default 16-token page)
    pool_pages = max_batch * (-(-max_seq // 16)) + 1
    ctx = {"pool_pages": pool_pages}
    cfg = SearchConfig(trials=trials, repeats=2, warmup=1)
    out = {}

    cap_measure = measure or control_replay_measurer(
        model, params, prompts, shared_prefix=shared_prefix,
        max_new=max_new, max_batch=max_batch, max_seq=max_seq,
        repeats=cfg.repeats, warmup=cfg.warmup)
    res_c = search(registry.get("control.prefix_pages"), cap_measure,
                   ctx=ctx, cfg=cfg)
    cache.record("control.prefix_pages", key, res_c.best,
                 ms=res_c.best_s * 1e3, trials=res_c.measured)
    out["control.prefix_pages"] = res_c.best

    age_measure = measure or control_replay_measurer(
        model, params, prompts, shared_prefix=shared_prefix,
        max_new=max_new, max_batch=max_batch, max_seq=max_seq,
        fixed=dict(res_c.best), repeats=cfg.repeats, warmup=cfg.warmup)
    res_a = search(registry.get("control.slo_aging"), age_measure,
                   ctx=ctx, cfg=cfg)
    cache.record("control.slo_aging", key, res_a.best,
                 ms=res_a.best_s * 1e3, trials=res_a.measured)
    out["control.slo_aging"] = res_a.best
    return out


def tune_generation_kv(model, params, prompts=None, max_new=8, max_batch=4,
                       max_seq=128, budget=0.9, measure=None):
    """Arbitrate the KV-page storage dtype against a measured accuracy
    budget: every ``generation.kv_dtype`` candidate decodes the same greedy
    prompt sample on a live generator; a candidate is admissible when its
    token agreement with the model-dtype decode is at least ``budget``,
    and the fastest admissible one wins. Records the winner under the
    generator's tuning key and returns ``{"kv_dtype": ..., "candidates":
    {dtype: {s, agreement}}}``.

    ``measure`` (tests) replaces the live run:
    ``measure(kv_dtype) -> (seconds, agreement)``.
    """
    from ..serving.generation import (GenerationConfig, Generator,
                                      SamplingParams)
    from ..serving.generation.engine import KV_DTYPES, generation_tune_key

    if prompts is None:
        vocab = int(model.cfg["vocab"])
        rng = np.random.RandomState(0)
        top = max(1, max_seq - max_new)
        lengths = sorted({min(n, top) for n in (3, 9, 17, 29)})
        prompts = [list(rng.randint(1, vocab, size=n)) for n in lengths]
    prompts = [[int(t) for t in p] for p in prompts]
    key = generation_tune_key(model, max_batch, max_seq)

    def live_run(kv_dtype):
        gen = Generator(model, params,
                        GenerationConfig(max_batch=max_batch,
                                         max_seq=max_seq,
                                         kv_dtype=kv_dtype))
        try:
            gen.warmup()
            sp = SamplingParams(max_new_tokens=max_new)  # greedy
            t0 = time.perf_counter()
            handles = [gen.submit(p, sp) for p in prompts]
            toks = [h.result(timeout=300) for h in handles]
            return time.perf_counter() - t0, toks
        finally:
            gen.stop(drain=True)

    ref_tokens = ref_secs = None
    if measure is None:
        # the reference run is also the "model" candidate: a greedy
        # decode of the same arm is deterministic
        ref_secs, ref_tokens = live_run("model")

    def agreement(toks):
        pairs = [(a, b) for r, s in zip(ref_tokens, toks)
                 for a, b in zip(r, s)]
        return float(np.mean([a == b for a, b in pairs])) if pairs else 1.0

    report = {}
    for kv in sorted(KV_DTYPES):
        if measure is not None:
            secs, agree = measure(kv)
        elif kv == "model":
            secs, agree = ref_secs, 1.0
        else:
            secs, toks = live_run(kv)
            agree = agreement(toks)
        report[kv] = {"s": float(secs), "agreement": float(agree)}
        cache.note_measurements()
    admissible = {kv: r for kv, r in report.items()
                  if r["agreement"] >= budget}
    if not admissible:  # budget impossible: the exact baseline stands
        admissible = {"model": report["model"]}
    winner = min(admissible, key=lambda kv: admissible[kv]["s"])
    cache.record("generation.kv_dtype", key, {"kv_dtype": winner},
                 ms=admissible[winner]["s"] * 1e3, trials=len(report),
                 extra={"budget": budget, "candidates": report})
    return {"kv_dtype": winner, "candidates": report}


def tune_quantize_layers(module, batches, table, budget=0.99, key=None,
                         max_drops=None):
    """Per-layer int8-or-fp32 arbitration for the ``quantize`` pass:
    starting from everything quantized, greedily pin the most damaging
    layer back to fp32 until the measured top-1 agreement with the fp32
    module meets ``budget``. Records ``quantize.layers`` ``{"skip":
    [...]}`` under the graph fingerprint, which every later quantized bind
    of this graph consults.

    ``module``: a bound fp32 inference Module (the baseline; the trial
    modules bind on its device); ``batches``: numpy arrays / DataBatches
    to score on; ``table``: the CalibrationTable. Returns ``{"skip":
    [...], "agreement": float}``. A custom ``key`` gets a bookkeeping copy
    of the winner but never steers the consult.
    """
    from .. import graph_pass
    from .. import io as mxio
    from .. import ndarray as nd
    from ..context import cpu
    from ..graph_pass import core as _gp_core
    from ..graph_pass import quantize as _quant
    from ..module import Module

    symbol = module.symbol
    fp_key = graph_pass.graph_fingerprint(symbol)
    arg_params, aux_params = module.get_params()
    data_shapes = [(d.name, d.shape) for d in module.data_shapes]

    def top1(mod, arrays):
        outs = []
        for arr in arrays:
            mod.forward(mxio.DataBatch(data=[nd.array(a, ctx=cpu())
                                             for a in arr]),
                        is_train=False)
            outs.append(mod.get_outputs()[0].asnumpy().argmax(axis=-1))
        return np.concatenate(outs)

    def as_arrays(b):
        if isinstance(b, np.ndarray):  # before the .data duck-check:
            return [b]                 # ndarray.data is a memoryview
        if isinstance(b, (list, tuple)):
            return list(b)
        if hasattr(b, "data"):  # a DataBatch
            return [np.asarray(a.asnumpy() if hasattr(a, "asnumpy")
                               else a) for a in b.data]
        return [b]

    arrays = [as_arrays(b) for b in batches]
    ref = top1(module, arrays)
    # trial binds are pure functions of this tuner's skip list: a stale
    # quantize.layers entry would otherwise union into every trial. The
    # prior entry comes back if the tune dies mid-run
    prior_entry = cache.lookup("quantize.layers", fp_key)
    cache.record("quantize.layers", fp_key, {"skip": []},
                 extra={"status": "tuning"})
    # the caller's process-wide overrides are restored after each trial
    prior_spec = _gp_core._SPEC_OVERRIDE
    prior_table = _quant._TABLE_OVERRIDE
    prior_skip = _quant._SKIP_OVERRIDE

    def agreement(skip):
        _quant.set_quantize_skip(skip)
        graph_pass.set_calibration_table(table)
        graph_pass.set_passes(_ambient_passes_plus_quantize())
        try:
            mod = Module(symbol, context=module._context,
                         data_names=[n for n, _ in data_shapes])
            mod.bind(data_shapes=data_shapes, for_training=False)
            mod.set_params(arg_params, aux_params, allow_missing=False)
            got = top1(mod, arrays)
        finally:
            graph_pass.set_passes(prior_spec)
            graph_pass.set_calibration_table(prior_table)
            _quant.set_quantize_skip(prior_skip)
        return float((got == ref).mean())

    try:
        # candidate set: the ops a fully quantized rewrite touches
        opt = graph_pass.optimize(
            symbol, for_training=False,
            frozen=set(arg_params) | set(aux_params),
            arg_shapes=dict(data_shapes),
            config=graph_pass.PassConfig(
                passes=set(graph_pass.DEFAULT_PASSES) | {"quantize"},
                quant_table=table))
        quantized = []
        if opt is not None:
            for rep in opt.reports:
                if rep["pass"] == "quantize" and "detail" in rep:
                    quantized = list(rep["detail"].get("quantized", ()))
        skip = []
        agree = agreement(skip)
        drops = 0
        bound = max_drops if max_drops is not None else len(quantized)
        while agree < budget and quantized and drops < bound:
            trials = [(agreement(skip + [name]), name) for name in quantized]
            cache.note_measurements(len(trials))
            best_agree, best_name = max(trials)
            if best_agree <= agree:
                break  # no single drop helps: stop instead of thrashing
            skip.append(best_name)
            quantized.remove(best_name)
            agree = best_agree
            drops += 1
    except BaseException:
        if isinstance(prior_entry, dict):
            cache.record("quantize.layers", fp_key, prior_entry,
                         extra={"status": "restored_after_failed_tune"})
        raise
    cache.record("quantize.layers", fp_key, {"skip": sorted(skip)},
                 trials=drops + 1,
                 extra={"budget": budget, "agreement": agree})
    if key is not None and key != fp_key:
        cache.record("quantize.layers", key, {"skip": sorted(skip)},
                     trials=drops + 1,
                     extra={"budget": budget, "agreement": agree,
                            "consulted_key": str(fp_key)})
    return {"skip": sorted(skip), "agreement": agree}


def _ambient_passes_plus_quantize():
    """The ambient pass spec (an active ``graph_pass.set_passes``
    override, else MXNET_GRAPH_PASSES) with ``quantize`` appended: the
    tuner trial-quantizes under the user's own pipeline."""
    from ..graph_pass import core as _gp_core

    spec = _gp_core._SPEC_OVERRIDE
    if spec is None:
        spec = os.environ.get("MXNET_GRAPH_PASSES", "default")
    spec = str(spec).strip()
    if spec.lower() in ("off", "none", "0", ""):
        spec = "default"
    return spec + ",quantize"


def tune_layout(measure, key, default="NHWC", trials=None):
    """Measured NHWC-vs-NCHW choice: ``measure({"layout": L}) ->
    seconds`` (the caller owns the model and its step: a ``Module`` bound
    per layout). Records ``graph.layout`` under ``key`` (the graph's
    fingerprint, which the layout pass consults at bind) and returns the
    winning layout string."""
    cfg = SearchConfig(trials=trials or 2, repeats=3, warmup=1)
    res = search(registry.get("graph.layout"), measure,
                 ctx={"default": default}, cfg=cfg)
    cache.record("graph.layout", key, res.best, ms=res.best_s * 1e3,
                 trials=res.measured)
    return res.best["layout"]


def tune_remat(measure, graph_key, trials=None):
    """Measured store-vs-recompute choice for one graph's training walk:
    ``measure({"mirror": 0|1}) -> seconds``. Records ``exec.remat`` under
    the graph's tuning key (``_GraphProgram.tuning_key``) and returns the
    winning mirror flag."""
    from .. import executor  # noqa: F401  (declares exec.remat)

    cfg = SearchConfig(trials=trials or 2, repeats=3, warmup=1)
    res = search(registry.get("exec.remat"), measure, ctx={}, cfg=cfg)
    cache.record("exec.remat", graph_key, res.best, ms=res.best_s * 1e3,
                 trials=res.measured)
    return int(res.best["mirror"])


def pipeline_replay_measurer(make_iter, batches=8):
    """``measure(candidate) -> seconds`` over a live streaming input
    pipeline: builds the iterator with the candidate's
    ``workers``/``depth`` via the caller's ``make_iter(decode_workers=,
    prefetch_depth=)`` factory and times the delivery of ``batches``
    batches (the consumer-side rate is what training sees)."""
    def measure(c):
        it = make_iter(decode_workers=c.get("workers"),
                       prefetch_depth=c.get("depth"))
        try:
            t0 = time.perf_counter()
            n = 0
            starved = 0
            while n < batches:
                try:
                    next(it)
                except StopIteration:
                    # two consecutive epoch ends with no batch between:
                    # the stream yields nothing (empty file or shard)
                    starved += 1
                    if starved > 1:
                        raise MXNetError(
                            "pipeline_replay_measurer: iterator yields "
                            "no batches (empty dataset or shard)")
                    it.reset()
                    continue
                starved = 0
                n += 1
            return time.perf_counter() - t0
        finally:
            closer = getattr(it, "close", None)
            if closer is not None:
                closer()

    return measure


def tune_input_pipeline(make_iter, key, batches=8, trials=None,
                        measure=None):
    """Measured search over the streaming input pipeline's
    ``io.decode_workers`` and ``io.prefetch_depth`` (worker count first,
    then queue depth at the winning worker count); records both under
    ``key`` (see ``runtime.pipeline.io_pipeline_key``, which
    ``StreamingIter`` consults at construction) and returns ``{op: winning
    value dict}``.

    ``make_iter(decode_workers=, prefetch_depth=)`` must build a fresh
    iterator (None = that knob's default); ``measure`` overrides the live
    replay measurer (tests use a stub)."""
    ctx = {"cpus": os.cpu_count() or 4}
    cfg = SearchConfig(trials=trials or 4, repeats=2, warmup=0)
    base = measure or pipeline_replay_measurer(make_iter, batches)

    res_w = search(registry.get("io.decode_workers"),
                   lambda c: base({"workers": int(c["workers"])}),
                   ctx=ctx, cfg=cfg)
    cache.record("io.decode_workers", key, res_w.best,
                 ms=res_w.best_s * 1e3, trials=res_w.measured)
    workers = int(res_w.best["workers"])
    res_d = search(registry.get("io.prefetch_depth"),
                   lambda c: base({"workers": workers,
                                   "depth": int(c["depth"])}),
                   ctx=ctx, cfg=cfg)
    cache.record("io.prefetch_depth", key, res_d.best,
                 ms=res_d.best_s * 1e3, trials=res_d.measured)
    return {"io.decode_workers": res_w.best,
            "io.prefetch_depth": res_d.best}


def auto_tune(op, key, ctx):
    """``MXNET_TUNE=1`` cache-miss hook (called through ``lookup_or_tune``
    from consulting call sites, never while a stream captures a CUDA
    graph). Only shape-local knobs can tune from call-site context;
    returns the freshly recorded value, or None when the op needs an
    explicit workload.

    Only the MISSING entries are searched: an existing (possibly shipped,
    measured) fwd or bwd entry is reused as-is, never re-measured or
    overwritten by an opportunistic local sweep."""
    if op == "fusion.blocks":
        # shape-local like the flash tiles: the region's (M, N, K) rides
        # in the consult context (parallel/fused.py resolve_blocks)
        if not all(k in ctx for k in ("M", "N", "K")):
            return None
        db = int(ctx.get("dtype_bytes", 4))
        dtype = ctx.get("dtype") or {2: "bfloat16", 4: "float32"}.get(
            db, "float32")
        return tune_fused_matmul(int(ctx["M"]), int(ctx["N"]),
                                 int(ctx["K"]), dtype=dtype,
                                 wt=bool(ctx.get("wt", True)),
                                 device=ctx.get("device"))
    if op not in ("flash_attention.fwd", "flash_attention.bwd"):
        return None
    dtype = ctx.get("dtype", "bfloat16")
    fwd_cached = cache.lookup("flash_attention.fwd", key, dtype=dtype)
    bwd_cached = cache.lookup("flash_attention.bwd", key, dtype=dtype)
    need_fwd = fwd_cached is None
    need_bwd = bwd_cached is None
    fwd_blocks = None
    if not need_fwd:
        try:
            fwd_blocks = (int(fwd_cached["block_q"]),
                          int(fwd_cached["block_k"]))
        except (TypeError, KeyError, ValueError):
            fwd_blocks = None  # corrupt entry: bwd measures on defaults
    if not (need_fwd or need_bwd):
        # both present — the "miss" was for another dtype/shape variant
        # of the same bucket resolved concurrently; nothing to do
        return {"flash_attention.fwd": fwd_cached,
                "flash_attention.bwd": bwd_cached}.get(op)
    # cap the batch*heads grid the sweep pays for: the rows are chosen
    # per (T, D); the grid axis is embarrassingly parallel
    bh = max(1, min(int(ctx.get("B", 1)) * int(ctx.get("H", 1)), 8))
    out = tune_flash_attention(
        T=int(ctx["T"]), D=int(ctx.get("D", 64)), B=1, H=bh,
        dtype=dtype, causal=bool(ctx.get("causal", False)),
        forward=need_fwd, backward=need_bwd, fwd_blocks=fwd_blocks,
        device=ctx.get("device"))
    out.setdefault("flash_attention.fwd", fwd_cached)
    out.setdefault("flash_attention.bwd", bwd_cached)
    return out.get(op)
