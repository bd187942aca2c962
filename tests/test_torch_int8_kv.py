"""Port parity: int8 KV pages of the generation engine against the JAX
package's, on the CPU, with the JAX tests' small model (vocab 64, d 32,
4 heads, 2 layers, d_ff 64, 2 experts, fp32 checkpoints) and geometry
(page 8, 4 slots, max_seq 64, buckets 16 / 32 / 64).

* ``_quantize_kv``: int8 values equal to the JAX package's on the same
  inputs, scales within 1e-7 relative (measured: equal);
* paged decode and verify attention over the same int8 pages and scales
  agree with the JAX package's within 1e-5 (both dequantize on gather
  inside the same fp32 online softmax);
* the port's int8 ``Generator`` gives the JAX package's int8 greedy tokens
  on the same fp32 checkpoint (bar 1.0; measured 1.0), also with the
  prefix cache and with n-gram speculation (the verify step's scatter),
  and its first tokens equal the fp32 engine's (the prefill's logits are
  never read from quantized pages);
* the byte model is the JAX package's as integers (``bytes_per_token`` and
  ``kv_read_bytes_per_token`` for model, bfloat16 and int8 pools), and
  ``kv_dtype`` resolves in its order: explicit, then the tuning cache,
  then ``MXNET_GEN_KV_DTYPE``;
* ``tune_generation_kv`` records its winner and the next generator
  consults it; a lossy candidate outside the budget loses
  (tests/test_quantize.py:595-617).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu import autotune as jautotune
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.transformer import TransformerParallel as JTP
from mxnet_tpu.serving import generation as jgen
from mxnet_tpu_torch import autotune as tautotune
from mxnet_tpu_torch.parallel import TransformerParallel, make_mesh
from mxnet_tpu_torch.serving.generation import (GenerationConfig, Generator,
                                                SamplingParams)
from mxnet_tpu_torch.serving.generation.engine import (_quantize_kv,
                                                       generation_tune_key)

JFA = importlib.import_module("mxnet_tpu.parallel.flash_attention")
FA = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
JENG = importlib.import_module("mxnet_tpu.serving.generation.engine")

_CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            n_experts=2)
_GEOMETRY = dict(page_size=8, decode_blocks=128, max_batch=4, max_seq=64,
                 prefill_buckets=(16, 32, 64))
_PINNED = dict(spec_k=0, amp=False, slo_aging_ms=500)
# greedy token agreement of the port's int8 engine with the JAX package's
# int8 engine on the same checkpoint (measured 1.0)
TOKEN_BAR = 1.0
PAGED_TOL = 1e-5


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.delenv("MXNET_GEN_KV_DTYPE", raising=False)
    for at in (jautotune, tautotune):
        at.reset()
    yield
    for at in (jautotune, tautotune):
        at.reset()


def _models():
    tm = TransformerParallel(make_mesh({"dp": 1}, devices=[mx.cpu()]),
                             dtype=np.float32, **_CFG)
    jm = JTP(jmake_mesh({"dp": 1}, devices=jax.devices("cpu")[:1]),
             dtype=np.float32, **_CFG)
    return (tm, tm.init(0)), (jm, jm.init(0))


@pytest.fixture(scope="module")
def models():
    return _models()


def _generators(models, **kw):
    (tm, tp), (jm, jp) = models
    cfg = dict(_GEOMETRY, **_PINNED)
    cfg.update(kw)
    return (Generator(tm, tp, GenerationConfig(**cfg)),
            jgen.Generator(jm, jp, jgen.GenerationConfig(**cfg)))


def _run(gen, prompts, sp, stop=True):
    try:
        handles = [gen.submit(p, sp) for p in prompts]
        return [h.result(timeout=300) for h in handles]
    finally:
        if stop:
            gen.stop()


def _prompts(seed=3, lengths=(2, 9, 17, 28, 40)):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 64, size=n)] for n in lengths]


def _agreement(a, b):
    pairs = [(x, y) for r, s in zip(a, b) for x, y in zip(r, s)]
    assert len(pairs) == sum(len(r) for r in a)
    return float(np.mean([x == y for x, y in pairs]))


# ------------------------------------------------------------ quantize_kv

@pytest.mark.parametrize("shape", [(2, 5, 4, 8), (3, 4, 16), (1, 1, 1, 8)])
def test_quantize_kv_matches_jax(shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * rng.uniform(0.01, 5, shape[:-1] + (1,))) \
        .astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0      # an all-zero vector: 1e-8 floor
    # the JAX engine runs it inside its compiled programs
    jq, js = jax.jit(JENG._quantize_kv)(jnp.asarray(x))
    tq, ts = _quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7,
                               atol=0)
    assert np.abs(tq.numpy()).max() <= 127


# ------------------------------------------------- paged attention (int8)

def _int8_pool(seed, S=3, Q=4, H=2, d=8, page=4, n_pages=4, pool=16):
    rng = np.random.RandomState(seed)
    k = rng.randn(pool, page, H, d).astype(np.float32) * 2
    v = rng.randn(pool, page, H, d).astype(np.float32)
    kq, ks = JENG._quantize_kv(jnp.asarray(k))
    vq, vs = JENG._quantize_kv(jnp.asarray(v))
    table = rng.choice(np.arange(1, pool), S * n_pages,
                       replace=False).reshape(S, n_pages).astype(np.int32)
    q = rng.randn(S, Q, H, d).astype(np.float32)
    return q, [np.asarray(a) for a in (kq, vq, ks, vs)], table


@pytest.mark.parametrize("blocks", [None, 4, 8])
def test_paged_decode_attention_int8_matches_jax(blocks):
    q, (kq, vq, ks, vs), table = _int8_pool(0)
    q = q[:, 0]
    lengths = np.array([0, 7, 16], np.int32)
    want = np.asarray(JFA.paged_decode_attention(
        *map(jnp.asarray, (q, kq, vq, table, lengths)), block_tokens=blocks,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = FA.paged_decode_attention(
        *map(torch.from_numpy, (q, kq, vq, table, lengths)),
        block_tokens=blocks, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PAGED_TOL)
    assert not got[0].any()


@pytest.mark.parametrize("blocks", [None, 4, 8])
def test_paged_verify_attention_int8_matches_jax(blocks):
    q, (kq, vq, ks, vs), table = _int8_pool(1)
    lengths = np.array([0, 5, 12], np.int32)
    want = np.asarray(JFA.paged_verify_attention(
        *map(jnp.asarray, (q, kq, vq, table, lengths)), block_tokens=blocks,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    got = FA.paged_verify_attention(
        *map(torch.from_numpy, (q, kq, vq, table, lengths)),
        block_tokens=blocks, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PAGED_TOL)


# ------------------------------------------------------ the int8 Generator

@pytest.mark.parametrize("extra", [{}, {"prefix_cache": True},
                                   {"spec_k": 2}])
def test_int8_generator_tokens_match_jax(models, extra):
    sp_t, sp_j = SamplingParams(max_new_tokens=10), \
        jgen.SamplingParams(max_new_tokens=10)
    prompts = _prompts()
    waves = [prompts]
    if extra.get("prefix_cache"):
        # a second wave shares a 16-token head with the first
        waves.append([prompts[-1][:16] + p[:5] for p in prompts[:3]])
    tgen, jg = _generators(models, kv_dtype="int8", **extra)
    got, want = [], []
    for i, wave in enumerate(waves):
        last = i == len(waves) - 1
        got += _run(tgen, wave, sp_t, stop=last)
        want += _run(jg, wave, sp_j, stop=last)
    prompts = [p for wave in waves for p in wave]
    assert _agreement(got, want) >= TOKEN_BAR
    tgen.pool.assert_no_leaks()
    if extra.get("prefix_cache"):
        tstats, jstats = tgen.get_stats(), jg.get_stats()
        assert tstats["control"]["prefill_tokens_skipped"] == \
            jstats["control"]["prefill_tokens_skipped"] > 0
    if extra.get("spec_k"):
        assert tgen.get_stats()["speculative"]["steps"] > 0
    # the first token of every request comes from the exact prefill logits
    ref_gen, jref = _generators(models, kv_dtype="model", **extra)
    jref.stop()
    ref = _run(ref_gen, prompts, sp_t)
    assert [r[0] for r in ref] == [g[0] for g in got]


def test_int8_generator_warmup_and_programs(models):
    tgen, jg = _generators(models, kv_dtype="int8")
    jg.stop()
    try:
        assert tgen.warmup() == len(_GEOMETRY["prefill_buckets"]) + 1
        assert tgen._pools["k"].dtype == torch.int8
        assert tgen._pools["ks"].dtype == torch.float32
        assert tuple(tgen._pools["ks"].shape) == \
            tuple(tgen._pools["k"].shape[:-1])
        out = _run(tgen, _prompts(lengths=(2, 30, 11, 17)),
                   SamplingParams(max_new_tokens=6), stop=False)
        assert all(len(o) == 6 for o in out)
        assert tgen.get_stats()["pool"]["used"] == 0
        notes = [r for r in mx.graph_pass.recent_reports()
                 if r.get("program") == "generation"
                 and r.get("kv_dtype") == "int8"]
        assert notes
    finally:
        tgen.stop()


@pytest.mark.parametrize("kv", ["model", "bfloat16", "int8"])
def test_byte_model_matches_jax(models, kv):
    tgen, jg = _generators(models, kv_dtype=kv)
    try:
        for attr in ("bytes_per_token", "page_bytes"):
            t, j = getattr(tgen.pool, attr), getattr(jg.pool, attr)
            assert type(t) is int and t == j, attr
        for ctx in (1, 10, 64):
            t = tgen.kv_read_bytes_per_token(ctx)
            assert type(t) is int and t == jg.kv_read_bytes_per_token(ctx)
        assert tgen.pool.get_stats()["kv_dtype"] == kv
        assert tgen.pool.get_stats() == jg.pool.get_stats()
    finally:
        tgen.stop()
        jg.stop()
    # 2 (K+V) x 2 layers x 4 heads x 8 dims x width, + int8's fp32 scales
    want = {"model": 2 * 2 * 4 * 8 * 4, "bfloat16": 2 * 2 * 4 * 8 * 2,
            "int8": 2 * 2 * 4 * 8 + 2 * 2 * 4 * 4}[kv]
    assert tgen.pool.bytes_per_token == want


def test_kv_dtype_resolution_explicit_then_cache_then_env(models,
                                                          monkeypatch):
    (tm, tp), _ = models
    key = generation_tune_key(tm, 4, 64)

    def resolved(**kw):
        cfg = dict(_GEOMETRY, spec_k=0, amp=False)
        cfg.update(kw)
        gen = Generator(tm, tp, GenerationConfig(**cfg), start=False)
        gen.stop()
        return gen.kv_dtype

    assert resolved() == "model"
    monkeypatch.setenv("MXNET_GEN_KV_DTYPE", "bfloat16")
    assert resolved() == "bfloat16"
    tautotune.record("generation.kv_dtype", key, {"kv_dtype": "int8"})
    assert resolved() == "int8"
    assert resolved(kv_dtype="model") == "model"
    with pytest.raises(ValueError):
        GenerationConfig(kv_dtype="float8")


# ----------------------------------------------------------------- tuner

@pytest.mark.parametrize("int8_agreement,winner", [(0.95, "int8"),
                                                   (0.5, "bfloat16")])
def test_tune_generation_kv_records_and_is_consulted(models, int8_agreement,
                                                     winner):
    (tm, tp), _ = models

    def measure(kv):  # int8 fastest; inside the budget or not
        return ({"model": 2.0, "bfloat16": 1.5, "int8": 1.0}[kv],
                {"model": 1.0, "bfloat16": 0.99,
                 "int8": int8_agreement}[kv])

    before = tautotune.stats()["measurements"]
    out = tautotune.tune_generation_kv(tm, tp, max_batch=4, max_seq=64,
                                       budget=0.9, measure=measure)
    assert out["kv_dtype"] == winner
    assert sorted(out["candidates"]) == ["bfloat16", "int8", "model"]
    assert tautotune.stats()["measurements"] - before == 3
    gen = Generator(tm, tp, GenerationConfig(**dict(_GEOMETRY, spec_k=0,
                                                    amp=False)),
                    start=False)
    gen.stop()
    assert gen.kv_dtype == winner


def test_tune_generation_kv_live_run(models):
    """A live arbitration on the small model: int8 decodes within the
    budget here, and every candidate was measured."""
    (tm, tp), _ = models
    out = tautotune.tune_generation_kv(tm, tp, max_new=4, max_batch=4,
                                       max_seq=64, budget=0.5)
    assert out["candidates"]["model"]["agreement"] == 1.0
    assert out["candidates"]["int8"]["agreement"] >= 0.5
    entry = tautotune.lookup("generation.kv_dtype",
                             generation_tune_key(tm, 4, 64))
    assert entry == {"kv_dtype": out["kv_dtype"]}
