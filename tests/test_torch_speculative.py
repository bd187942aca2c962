"""Port parity: speculative decoding in the port's generation engine
(``mxnet_tpu_torch/serving/generation``), on the CPU.

The n-gram proposer gives the JAX package's proposals on random histories;
``PagePool.shrink`` rolls back as the JAX pool does; and with either
proposer (n-gram, or a draft model) the port's speculative engine emits the
tokens of its own non-speculative engine, for greedy (fp32 and bf16) and
seeded temperature requests alike, leaking no page through rejection
rollback, EOS mid-burst, drain or abort. The small model and geometry are
those of ``tests/test_speculative.py``.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.serving.generation import speculative as jspec
from mxnet_tpu_torch.parallel import TransformerParallel, make_mesh
from mxnet_tpu_torch.serving.generation import (GenerationConfig, Generator,
                                                NgramProposer, PagePool,
                                                SamplingParams, ngram_propose)

_CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            n_experts=2)
_DTYPES = {"float32": np.dtype(np.float32),
           "bfloat16": np.dtype(ml_dtypes.bfloat16)}


def _mesh():
    return make_mesh({"dp": 1}, devices=[mx.cpu()])


def _model(dtype="float32"):
    model = TransformerParallel(_mesh(), dtype=_DTYPES[dtype], **_CFG)
    return model, model.init(0)


def _draft():
    model = TransformerParallel(_mesh(), vocab=64, d_model=16, n_heads=2,
                                n_layers=1, d_ff=32, n_experts=2)
    return model, model.init(7)


@pytest.fixture(scope="module")
def fp32():
    return _model()


def _generator(model, params, start=True, draft=None, **kw):
    cfg = dict(page_size=8, max_batch=4, max_seq=64,
               prefill_buckets=(16, 32, 64))
    cfg.update(kw)
    extra = {} if draft is None else dict(draft_model=draft[0],
                                          draft_params=draft[1])
    return Generator(model, params, GenerationConfig(**cfg), start=start,
                     **extra)


def _mixed_requests(n=10, seed=0, vocab=64):
    """Mixed greedy + seeded-temperature requests with cyclic prompts, so
    the n-gram proposer gets real acceptances."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        period = int(rng.randint(2, 5))
        reps = int(rng.randint(2, 8))
        pat = rng.randint(1, vocab, size=period)
        prompt = [int(t) for t in np.tile(pat, reps)][:48]
        n_new = int(rng.randint(2, 12))
        sp = (SamplingParams(max_new_tokens=n_new) if i % 3
              else SamplingParams(max_new_tokens=n_new, temperature=0.7,
                                  top_k=8, seed=200 + i))
        reqs.append((prompt, sp))
    return reqs


def _serve(gen, requests, concurrent=False):
    try:
        if concurrent:
            hs = [gen.submit(p, sp) for p, sp in requests]
            return [h.result(timeout=120) for h in hs]
        return [gen.generate(p, sp, timeout=120) for p, sp in requests]
    finally:
        gen.stop(drain=True)


@pytest.fixture(scope="module")
def reference(fp32):
    """The non-speculative engine's tokens for the mixed requests."""
    reqs = _mixed_requests(8, seed=1)
    return reqs, _serve(_generator(*fp32), reqs)


# ------------------------------------------------------- n-gram proposer

def test_ngram_propose_units():
    assert list(ngram_propose([1, 2, 3, 4, 1, 2], k=3, ngram=2)) == [3, 4, 1]
    assert list(ngram_propose([1, 2, 3, 1, 2, 9, 1, 2], k=1)) == [9]
    assert list(ngram_propose([4, 5, 6, 4, 5], k=4)) == [6, 4, 5, 5]
    assert list(ngram_propose([1, 2, 3], k=2)) == [3, 3]
    assert ngram_propose([1, 2, 3], k=0).size == 0
    assert list(ngram_propose([], k=3)) == [0, 0, 0]
    assert list(ngram_propose([5], k=2, ngram=3)) == [5, 5]
    assert ngram_propose([1, 2, 1], k=2).dtype == np.int32
    prop = NgramProposer(3, ngram=2)
    assert list(prop([1, 2, 3, 4, 1, 2])) == [3, 4, 1]
    with pytest.raises(ValueError):
        NgramProposer(2, ngram=0)


def test_ngram_propose_matches_jax_on_random_histories():
    rng = np.random.RandomState(0)
    for _ in range(300):
        hist = rng.randint(0, int(rng.randint(2, 6)),
                           size=int(rng.randint(0, 40))).tolist()
        k, n = int(rng.randint(0, 6)), int(rng.randint(1, 4))
        np.testing.assert_array_equal(ngram_propose(hist, k, n),
                                      jspec.ngram_propose(hist, k, n))


# --------------------------------------------------- rollback accounting

def test_page_pool_shrink_restores_reservation():
    pool = PagePool(pool_pages=16, page_size=4)
    pool.admit(0, 6, 20)          # 2 pages now, 5 worst -> 3 reserved
    pool.extend(0)
    pool.extend(0)                # optimistic speculative extension
    assert pool.get_stats()["reserved"] == 1
    assert pool.shrink(0, 7) == 2
    assert len(pool.pages_of(0)) == 2
    assert pool.get_stats()["reserved"] == 3
    assert pool.shrink(0, 8) == 0
    pool.release(0, 20)
    pool.assert_no_leaks()


def test_page_pool_shrink_refuses_shared_tail_page():
    pool = PagePool(pool_pages=8, page_size=4)
    pool.admit(0, 4, 12)
    pool.extend(0)
    shared = pool.pages_of(0)[-1]
    pool.incref(shared)
    with pytest.raises(ValueError):
        pool.shrink(0, 4)
    pool.decref(shared)
    assert pool.shrink(0, 4) == 1
    pool.release(0, 12)
    pool.assert_no_leaks()


# ------------------------------------------------------- lossless parity

def test_ngram_speculation_is_lossless(fp32, reference):
    reqs, want = reference
    gen = _generator(*fp32, spec_k=3)
    got = _serve(gen, reqs)
    assert got == want
    stats = gen.get_stats()["speculative"]
    assert stats["mode"] == "ngram" and stats["proposed"] > 0
    gen.pool.assert_no_leaks()


def test_draft_speculation_is_lossless(fp32, reference):
    reqs, want = reference
    gen = _generator(*fp32, spec_k=2, draft=_draft())
    assert gen.spec_mode == "draft"
    assert gen._pools["dk"].shape[3:] == (2, 8)
    got = _serve(gen, reqs, concurrent=True)
    assert got == want
    gen.pool.assert_no_leaks()


def test_bf16_greedy_speculation_is_lossless():
    model, params = _model("bfloat16")
    reqs = [(p, sp) for p, sp in _mixed_requests(8, seed=1)
            if sp.temperature == 0.0]
    want = _serve(_generator(model, params), reqs)
    assert _serve(_generator(model, params, spec_k=3), reqs) == want


def test_seeded_temperature_independent_of_acceptance(fp32):
    """A seeded temperature request gives the same tokens solo on the
    speculative engine, beside other traffic on it, and on the plain
    engine: which step sampled a token never shows in the stream."""
    prompt = [3, 9, 3, 9, 3, 9, 3, 9, 5]
    sp = SamplingParams(max_new_tokens=10, temperature=0.8, top_k=8,
                        seed=42)
    [ref] = _serve(_generator(*fp32), [(prompt, sp)])
    gen = _generator(*fp32, spec_k=3)
    try:
        solo = gen.generate(prompt, sp, timeout=120)
        noise = [gen.submit(p, s) for p, s in _mixed_requests(3, seed=3)]
        concurrent = gen.generate(prompt, sp, timeout=120)
        for h in noise:
            h.result(timeout=120)
    finally:
        gen.stop(drain=True)
    assert solo == ref and concurrent == ref
    gen.pool.assert_no_leaks()


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_warmup_counts(fp32, mode):
    draft = _draft() if mode == "draft" else None
    gen = _generator(*fp32, spec_k=2, draft=draft, start=False)
    assert gen.warmup() == 3 + 1 + (2 if draft else 1)
    assert gen.get_stats()["captures"] == 0     # eager steps on the CPU


# -------------------------------------------------------- page hygiene

def test_rejection_rollback_leaks_nothing(fp32):
    gen = _generator(*fp32, spec_k=3, page_size=4)
    rng = np.random.RandomState(6)
    handles = []
    for _ in range(10):
        plen = int(rng.randint(1, 40))
        prompt = [int(t) for t in rng.randint(1, 64, size=plen)]
        n_new = int(rng.randint(1, min(12, 64 - plen)))
        handles.append(gen.submit(prompt,
                                  SamplingParams(max_new_tokens=n_new)))
    try:
        for h in handles:
            h.result(timeout=120)
        stats = gen.get_stats()["speculative"]
        assert stats["steps"] > 0 and stats["proposed"] > 0
    finally:
        gen.stop(drain=True)
    gen.pool.assert_no_leaks()


def test_eos_mid_burst_token_exact(fp32):
    prompt = [7, 11, 7, 11, 7, 11]
    [greedy] = _serve(_generator(*fp32),
                      [(prompt, SamplingParams(max_new_tokens=8))])
    sp = SamplingParams(max_new_tokens=8, eos_id=greedy[3])
    [ref] = _serve(_generator(*fp32), [(prompt, sp)])
    assert len(ref) < 8
    gen = _generator(*fp32, spec_k=3)
    assert _serve(gen, [(prompt, sp)]) == [ref]
    gen.pool.assert_no_leaks()


def test_stop_drain_finalizes_inflight(fp32, reference):
    reqs, want = reference
    gen = _generator(*fp32, spec_k=3)
    handles = [gen.submit(p, sp) for p, sp in reqs]
    gen.stop(drain=True)               # at once, mid-traffic
    assert [h.result(timeout=60) for h in handles] == want
    gen.pool.assert_no_leaks()


def test_abort_mid_traffic_leaks_nothing(fp32):
    gen = _generator(*fp32, spec_k=3, max_batch=1)
    handles = [gen.submit([1, 2] * 3, SamplingParams(max_new_tokens=40))
               for _ in range(3)]
    next(handles[0].stream(timeout=60))   # decoding; the others queued
    gen.stop(drain=False)
    for h in handles[1:]:
        with pytest.raises(Exception):
            h.result(timeout=60)
    gen.pool.assert_no_leaks()


def test_speculative_stats(fp32):
    gen = _generator(*fp32, spec_k=3)
    try:
        for p, sp in _mixed_requests(5, seed=8):
            gen.generate(p, sp, timeout=120)
        stats = gen.get_stats()
    finally:
        gen.stop(drain=True)
    spec = stats["speculative"]
    assert spec["mode"] == "ngram" and spec["k"] == 3 and spec["steps"] > 0
    assert 0 <= spec["accepted"] <= spec["proposed"]
    assert spec["accept_rate"] == pytest.approx(
        spec["accepted"] / spec["proposed"], abs=1e-3)
    assert spec["draft_ms"] >= 0 and spec["verify_ms"] > 0
    assert stats["config"]["spec_k"] == 3
    assert stats["config"]["spec_mode"] == "ngram"
    off = _generator(*fp32, start=False).get_stats()["speculative"]
    assert off["mode"] == "off" and off["k"] == 0
    assert off["accept_rate"] is None


def test_draft_vocab_must_match(fp32):
    small = TransformerParallel(_mesh(), vocab=32, d_model=16, n_heads=2,
                                n_layers=1, d_ff=32, n_experts=1)
    with pytest.raises(ValueError):
        _generator(*fp32, spec_k=2, draft=(small, small.init(0)),
                   start=False)
    with pytest.raises(ValueError):
        Generator(*fp32, GenerationConfig(spec_k=2), start=False,
                  draft_model=small)
    assert torch.is_grad_enabled()
