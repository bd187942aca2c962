"""The tuners of the int8 paths: measured arbitrations whose winners land
in the tuning cache, where the paths consult them.

Counterpart of the ``mxnet_tpu/autotune/tuners.py`` entries that the
int8 slice's paths read:

* :func:`tune_generation_kv` arbitrates the KV-page storage dtype of a
  :class:`~..serving.generation.Generator` against a token-agreement
  budget (``generation.kv_dtype``);
* :func:`tune_quantize_layers` pins the layers whose int8 rewrite costs
  the most top-1 agreement back to fp32 (``quantize.layers``, read by the
  ``quantize`` pass).

The rest of the JAX package's tuners (flash blocks, bucket ladders,
layout, remat, the input pipeline) wait for ROADMAP A13.
"""
from __future__ import annotations

import os
import time

import numpy as np

from . import cache

__all__ = ["tune_generation_kv", "tune_quantize_layers"]


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
