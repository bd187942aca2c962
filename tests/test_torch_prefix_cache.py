"""Port parity: the generation prefix cache (``serving/control/
prefix_cache.py`` over the refcounted ``PagePool``) and the prefix-cached
``Generator`` against the JAX package's, on the CPU, with the JAX tests'
small model (vocab 64, d 32, 4 heads, 2 layers, d_ff 64, 2 experts) and
geometry (page 8, 4 slots, max_seq 64, buckets 16 / 32 / 64).

* the operation sequences of tests/test_control.py (block-aligned match /
  insert, LRU capacity eviction and reclaim, interior pages surviving a
  leaf's eviction) give equal matches, evictions, refcounts and stats in
  both packages;
* a prefix-cached generator in fp32 greedy is token-exact against the JAX
  package's, with the same ``prefill_tokens_skipped``, hit rate and COW
  copies;
* warm-cache output equals cold output (fp32 pools, a bf16 checkpoint,
  bf16 and int8 pools under an fp32 model: tests/test_control.py's
  cases);
* a reader keeps decoding while the cache evicts its pages, and admission
  under pressure reclaims cold prefixes without shredding the one it
  shares;
* every pool drains without a leaked page.
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.transformer import TransformerParallel as JTP
from mxnet_tpu.serving import control as jcontrol
from mxnet_tpu.serving import generation as jgen
from mxnet_tpu_torch.parallel import TransformerParallel, make_mesh
from mxnet_tpu_torch.serving import control as tcontrol
from mxnet_tpu_torch.serving import generation as tgen
from mxnet_tpu_torch.serving.generation import (GenerationConfig, Generator,
                                                SamplingParams)

_CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            n_experts=2)
_GEOMETRY = dict(page_size=8, decode_blocks=128, max_batch=4, max_seq=64,
                 prefill_buckets=(16, 32, 64))
# every knob the JAX engine would look up in its tuning cache, explicit
_PINNED = dict(spec_k=0, amp=False, slo_aging_ms=500, prefix_pages=0)
_DTYPES = {"float32": np.dtype(np.float32),
           "bfloat16": np.dtype(ml_dtypes.bfloat16)}
_PROMPTS = [list(range(1, 17)),                 # page-aligned (COW)
            list(range(1, 17)) + [40, 41, 42],  # shared head + tail
            list(range(1, 9)),                  # one-block prefix
            [7] * 30]                           # unrelated


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(dtype="float32"):
    model = TransformerParallel(make_mesh({"dp": 1}, devices=[mx.cpu()]),
                                dtype=_DTYPES[dtype], **_CFG)
    return model, model.init(0)


def _generator(model, params, start=True, **kw):
    cfg = dict(_GEOMETRY, **_PINNED)
    cfg.update(kw)
    return Generator(model, params, GenerationConfig(**cfg), start=start)


def _jax_generator(**kw):
    mesh = jmake_mesh({"dp": 1}, devices=jax.devices("cpu")[:1])
    model = JTP(mesh, dtype=np.float32, **_CFG)
    cfg = dict(_GEOMETRY, **_PINNED)
    cfg.update(kw)
    return jgen.Generator(model, model.init(0), jgen.GenerationConfig(**cfg))


@pytest.fixture(scope="module")
def fp32():
    return _model()


# ---------------------------------------------------- the cache's scripts

def _match_and_drop(pool, cache, tokens):
    got, matched = cache.match(tokens)
    for p in got:
        pool.decref(p)
    return got, matched


def _script_match_insert(pkg):
    gen, ctl = pkg
    pool = gen.PagePool(32, 4)
    cache = ctl.PrefixCache(pool)
    prompt = list(range(1, 11))            # 10 tokens -> 2 full blocks
    pages = pool.admit(0, 10, 10)          # 3 pages (partial 3rd)
    out = [cache.insert(prompt, pages)]
    pool.release(0, 10)
    out.append(pool.pages_used())
    out.append(_match_and_drop(pool, cache, prompt))
    out.append(_match_and_drop(pool, cache, prompt[:4] + [99] * 6))
    out.append(_match_and_drop(pool, cache, [1, 2, 3]))
    out.append(cache.get_stats())
    out.append(cache.clear())
    pool.assert_no_leaks()
    return out


def _script_lru_and_reclaim(pkg):
    gen, ctl = pkg
    pool = gen.PagePool(32, 4)
    cache = ctl.PrefixCache(pool, capacity_pages=2)
    out = []
    for slot, block in enumerate(([1, 2, 3, 4], [5, 6, 7, 8],
                                  [9, 10, 11, 12])):
        pages = pool.admit(slot, 4, 4)
        out.append(cache.insert(block, pages))
        pool.release(slot, 4)
        out.append((len(cache), pool.get_stats()))
    out.append(_match_and_drop(pool, cache, [1, 2, 3, 4]))
    out.append(_match_and_drop(pool, cache, [9, 10, 11, 12]))
    out.append(cache.reclaim(10))
    out.append((len(cache), cache.get_stats()))
    pool.assert_no_leaks()
    return out


def _script_interior_pages(pkg):
    gen, ctl = pkg
    pool = gen.PagePool(32, 4)
    cache = ctl.PrefixCache(pool, capacity_pages=3)
    long = list(range(1, 13))              # 3 full blocks, one chain
    pages = pool.admit(0, 12, 12)
    out = [cache.insert(long, pages)]
    pool.release(0, 12)
    out.append(cache.reclaim(1))           # drops the LEAF
    got, matched = cache.match(long)
    out.append((got, matched, [pool.refcount(p) for p in got]))
    for p in got:
        pool.decref(p)
    # a reader holding a match keeps its page through the cache's clear
    held, _ = cache.match(long[:4])
    out.append(cache.clear())
    out.append([pool.refcount(p) for p in held])
    for p in held:
        pool.decref(p)
    out.append(cache.get_stats())
    pool.assert_no_leaks()
    return out


@pytest.mark.parametrize("script", [_script_match_insert,
                                    _script_lru_and_reclaim,
                                    _script_interior_pages])
def test_prefix_cache_scripts_match_jax(script):
    assert script((tgen, tcontrol)) == script((jgen, jcontrol))


def test_prefix_cache_expected_values():
    """The numbers tests/test_control.py asserts, on the port's run."""
    out = _script_match_insert((tgen, tcontrol))
    assert out[0] == 2 and out[1] == 2
    assert out[2][1] == 8 and out[3][1] == 4 and out[4] == ([], 0)
    assert out[5]["hits"] == 2 and out[5]["misses"] == 1
    assert out[5]["hit_tokens"] == 12
    out = _script_interior_pages((tgen, tcontrol))
    assert out[1] == 1 and out[2][1] == 8


# ------------------------------------------------ the prefix-cached engine

def _two_passes(gen):
    sp = SamplingParams(max_new_tokens=6)
    try:
        first = [gen.generate(p, sp, timeout=300) for p in _PROMPTS]
        second = [gen.generate(p, sp, timeout=300) for p in _PROMPTS]
        stats = gen.get_stats()
    finally:
        gen.stop()
    gen.pool.assert_no_leaks()
    return first, second, stats


def test_prefix_cached_generator_matches_jax(fp32):
    want = _two_passes(_jax_generator(prefix_cache=True))
    got = _two_passes(_generator(*fp32, prefix_cache=True))
    assert got[0] == want[0] and got[1] == want[1]
    for key in ("prefix_cache", "prefill_tokens_skipped", "cow_copies",
                "pages_shared"):
        assert got[2]["control"][key] == want[2]["control"][key], key
    cache = got[2]["control"]["prefix_cache"]
    assert cache["hits"] == 6 and cache["misses"] == 2
    assert got[2]["control"]["prefill_tokens_skipped"] == 85
    assert got[2]["prefix_hits"] == want[2]["prefix_hits"]
    assert got[2]["config"]["prefix_cache"] is True


@pytest.mark.parametrize("dtype,kv_dtype", [
    ("float32", None),            # fp32 pools
    ("bfloat16", None),           # bf16 checkpoint + pools
    ("float32", "bfloat16"),      # fp32 model, narrow bf16 pools
    ("float32", "int8"),          # fp32 model, int8 pools with scales
])
def test_cache_hit_identical_to_cold_path(dtype, kv_dtype):
    model, params = _model(dtype)
    kv = {} if kv_dtype is None else {"kv_dtype": kv_dtype}
    sp = SamplingParams(max_new_tokens=6)
    if kv_dtype is not None:
        # narrow pools: the cold path is the cache-enabled engine with an
        # EMPTY cache (its suffix prefill round-trips K/V through the
        # pages' dtype, as the JAX test's cold path does)
        ref = []
        for p in _PROMPTS:
            cold = _generator(model, params, prefix_cache=True, **kv)
            try:
                ref.append(cold.generate(p, sp, timeout=300))
            finally:
                cold.stop()
            cold.pool.assert_no_leaks()
    else:
        cold = _generator(model, params, **kv)
        try:
            ref = [cold.generate(p, sp, timeout=300) for p in _PROMPTS]
        finally:
            cold.stop()
        cold.pool.assert_no_leaks()
    first, second, stats = _two_passes(
        _generator(model, params, prefix_cache=True, **kv))
    assert first == ref, "cold-cache path diverged from the cold engine"
    assert second == ref, "cache-hit path diverged from the cold path"
    assert stats["control"]["prefix_cache"]["hits"] >= len(_PROMPTS)
    assert stats["control"]["cow_copies"] >= 1


def test_mid_flight_cache_eviction_keeps_reader_decoding(fp32):
    prompt = list(range(1, 17))
    solo = _generator(*fp32)
    try:
        ref = solo.generate(prompt, SamplingParams(max_new_tokens=12),
                            timeout=300)
    finally:
        solo.stop()
    gen = _generator(*fp32, prefix_cache=True)
    try:
        gen.generate(prompt, SamplingParams(max_new_tokens=2), timeout=300)
        assert len(gen.prefix_cache) == 2
        h = gen.submit(prompt, SamplingParams(max_new_tokens=12))
        stream = h.stream(timeout=120)
        early = [next(stream) for _ in range(3)]   # reader mid-decode...
        assert gen.prefix_cache.reclaim(100) == 2  # ...cache evicted
        assert early + list(stream) == ref
    finally:
        gen.stop()
    gen.pool.assert_no_leaks()


def test_pressure_reclaim_unblocks_admission(fp32):
    gen = _generator(*fp32, prefix_cache=True, pool_pages=10, max_batch=1,
                     prefill_buckets=(16, 32))
    try:
        for base in (1, 20, 40):           # fill the cache: 3 x 2 pages
            gen.generate(list(range(base, base + 16)),
                         SamplingParams(max_new_tokens=2), timeout=300)
        assert len(gen.prefix_cache) == 6
        out = gen.generate([3] * 16, SamplingParams(max_new_tokens=15),
                           timeout=300)
        assert len(out) == 15
        assert gen.prefix_cache.get_stats()["evicted_pages"] > 0
    finally:
        gen.stop()
    gen.pool.assert_no_leaks()


def test_pressure_gate_accounts_sharing_before_reclaiming(fp32):
    gen = _generator(*fp32, prefix_cache=True, pool_pages=9, max_batch=1,
                     max_seq=32, prefill_buckets=(16, 32))
    try:
        a = list(range(1, 25))
        b = list(range(30, 54))
        ref = gen.generate(a, SamplingParams(max_new_tokens=2), timeout=300)
        gen.generate(b, SamplingParams(max_new_tokens=2), timeout=300)
        assert len(gen.prefix_cache) == 6
        assert not gen.pool.can_admit(25)      # conservative gate fails
        assert gen.generate(a, SamplingParams(max_new_tokens=2),
                            timeout=300) == ref
        stats = gen.prefix_cache.get_stats()
        assert stats["evicted_pages"] == 0
        assert stats["hits"] == 1              # probe match not counted
        assert gen.pool.get_stats()["cow_copies"] == 1
    finally:
        gen.stop()
    gen.pool.assert_no_leaks()


def test_prefix_cache_warmup_and_flat_programs(fp32):
    gen = _generator(*fp32, prefix_cache=True, start=False)
    assert gen.warmup() == len(_GEOMETRY["prefill_buckets"]) + 1
    gen.start()
    head = list(range(1, 17))
    try:
        handles = [gen.submit(head + [30 + i] * (i % 3) if i % 2 else head,
                              SamplingParams(max_new_tokens=3),
                              slo=("interactive", "standard", "batch")[i % 3])
                   for i in range(9)]
        for h in handles:
            h.result(timeout=300)
        stats = gen.get_stats()
    finally:
        gen.stop()
    gen.pool.assert_no_leaks()
    assert stats["control"]["prefix_cache"]["hits"] > 0
    assert stats["captures"] == 0                  # eager steps here
    assert sorted(gen._steps) == ["decode", "prefill16", "prefill32",
                                  "prefill64"]
