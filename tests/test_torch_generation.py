"""Port parity: the generation engine (``mxnet_tpu_torch/serving/generation``)
against the JAX package's ``Generator`` on the CPU, with the JAX tests'
small model (vocab 64, d 32, 4 heads, 2 layers, d_ff 64, 2 experts) and
geometry (page 8, 4 slots, max_seq 64, buckets 16 / 32 / 64).

* fp32 greedy output is token-exact against the JAX ``Generator`` (same
  ``init(0)`` parameters, bit for bit), for a mixed batch with a mid-flight
  join, also with bf16 KV pages;
* bf16 greedy output is token-exact against the port's own full-recompute
  oracle (as ``tests/test_generation.py`` holds the JAX package);
* the refcounted ``PagePool`` gives the JAX pool's page ids and stats for
  the same scripted calls;
* sampling: seeded runs repeat, do not depend on batch composition, and
  draw each token with the JAX package's distribution: at fixed logits the
  frequencies of both packages over N draws lie within 5 standard errors
  of the exact top-k / temperature probabilities (the streams differ:
  threefry there, a counter hash here);
* the engine's behaviour: EOS eviction, backpressure, submit validation, a
  pool too small, drain and abort, and the int8 / amp / prefix-cache
  options constructing.
"""
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.config import get_flag as jget_flag
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.transformer import TransformerParallel as JTP
from mxnet_tpu.serving import generation as jgen
from mxnet_tpu.serving.generation import sampling as jsampling
from mxnet_tpu_torch.config import get_flag
from mxnet_tpu_torch.parallel import TransformerParallel, make_mesh
from mxnet_tpu_torch.serving import generation as gen_mod
from mxnet_tpu_torch.serving.generation import (
    GenerationConfig, Generator, PagePool, QueueFullError, SamplingParams,
    ServerClosedError, default_prefill_ladder)
from mxnet_tpu_torch.serving.generation import sampling

_CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            n_experts=2)
_GEOMETRY = dict(page_size=8, decode_blocks=128, max_batch=4, max_seq=64,
                 prefill_buckets=(16, 32, 64))
# every knob the JAX engine would look up in its tuning cache, explicit
_PINNED = dict(spec_k=0, kv_dtype="model", amp=False, slo_aging_ms=500)
_DTYPES = {"float32": np.dtype(np.float32),
           "bfloat16": np.dtype(ml_dtypes.bfloat16)}


def _model(dtype="float32", **cfg):
    kw = dict(_CFG, **cfg)
    model = TransformerParallel(make_mesh({"dp": 1}, devices=[mx.cpu()]),
                                dtype=_DTYPES[dtype], **kw)
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
def jax_gen():
    gen = _jax_generator()
    yield gen
    gen.stop()


@pytest.fixture(scope="module")
def fp32():
    return _model()


def _recompute_tokens(model, params, prompt, n):
    """Greedy full-recompute oracle: the whole causal forward again for
    every generated token."""
    toks, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            logits, _, _ = model.prefill_forward(params, np.asarray([toks]))
            nxt = int(torch.argmax(logits[0, len(toks) - 1]))
            out.append(nxt)
            toks.append(nxt)
    return out


def _mixed_batch(gen):
    """A mid-flight join (A streams 3 tokens, then B joins) and then five
    prompts of mixed lengths submitted together."""
    ha = gen.submit([7, 3, 11, 30], SamplingParams(max_new_tokens=16))
    stream = ha.stream(timeout=120)
    early = [next(stream) for _ in range(3)]
    hb = gen.submit([5] * 9, SamplingParams(max_new_tokens=6))
    out = [early + list(stream), hb.result(timeout=120)]
    rng = np.random.RandomState(0)
    hs = [gen.submit([int(t) for t in rng.randint(1, 64, size=plen)],
                     SamplingParams(max_new_tokens=n))
          for plen, n in ((2, 9), (30, 3), (11, 7), (17, 12), (50, 5))]
    return out + [h.result(timeout=120) for h in hs]


# ------------------------------------------------------------ greedy parity

def test_fp32_greedy_matches_jax_generator(jax_gen, fp32):
    want = _mixed_batch(jax_gen)
    gen = _generator(*fp32)
    try:
        got = _mixed_batch(gen)
    finally:
        gen.stop()
    assert got == want
    gen.pool.assert_no_leaks()


def test_bf16_kv_pages_greedy_matches_jax_generator(fp32):
    jg = _jax_generator(kv_dtype="bfloat16")
    try:
        want = _mixed_batch(jg)
    finally:
        jg.stop()
    gen = _generator(*fp32, kv_dtype="bfloat16")
    try:
        assert gen._pools["k"].dtype == torch.bfloat16
        got = _mixed_batch(gen)
    finally:
        gen.stop()
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_matches_full_recompute_oracle(dtype):
    model, params = _model(dtype)
    gen = _generator(model, params)
    try:
        rng = np.random.RandomState(3)
        for plen, n_new in ((1, 6), (5, 10), (17, 8)):
            prompt = [int(t) for t in rng.randint(1, 64, size=plen)]
            got = gen.generate(prompt, SamplingParams(max_new_tokens=n_new),
                               timeout=120)
            assert got == _recompute_tokens(model, params, prompt, n_new)
    finally:
        gen.stop()


def test_warmup_count_and_no_capture_on_the_cpu(fp32):
    gen = _generator(*fp32)
    try:
        assert gen.warmup() == len(_GEOMETRY["prefill_buckets"]) + 1
        assert gen.generate([1, 2, 3], SamplingParams(max_new_tokens=4),
                            timeout=120)
        assert gen.get_stats()["captures"] == 0   # eager steps here
    finally:
        gen.stop()


# ------------------------------------------------------------------ PagePool

def _pool_script(mod):
    """The same calls on either package's PagePool: (return values,
    stats after each call)."""
    pool = mod.PagePool(12, 4, bytes_per_token=64, kv_dtype="model")
    held = []   # a page referenced from outside the slots, as a cache does
    calls = [("admit", lambda: (0, 6, 14)), ("admit", lambda: (1, 3, 9)),
             ("extend", lambda: (0,)), ("extend", lambda: (1,)),
             ("incref", lambda: held.append(pool.pages_of(0)[0]) or held),
             ("cow", lambda: (0, 0)), ("cow", lambda: (1, 0)),
             ("decref", lambda: held), ("shrink", lambda: (0, 6)),
             ("admit", lambda: (2, 4, 8)), ("release", lambda: (1, 9)),
             ("extend", lambda: (2,)), ("shrink", lambda: (2, 4)),
             ("release", lambda: (0, 14)), ("release", lambda: (2, 8))]
    out = []
    for name, args in calls:
        res = getattr(pool, name)(*args())
        out.append((name, res, pool.get_stats(),
                    {s: pool.pages_of(s) for s in range(3)},
                    pool.can_admit(20), pool.admission_shortfall(30)))
    pool.assert_no_leaks()
    return out


def test_page_pool_matches_jax_pool():
    assert _pool_script(gen_mod) == _pool_script(jgen)


def test_pool_admission_reservation_and_errors():
    pool = PagePool(8, 4)  # 7 allocatable
    assert pool.pages_for(9) == 3
    pool.admit(0, 8, 16)          # 2 now, 4 worst -> 2 reserved
    assert pool.pages_used() == 2
    assert pool.can_admit(12) and not pool.can_admit(16)
    with pytest.raises(ValueError):
        pool.admit(0, 4, 4)       # slot already owns pages
    with pytest.raises(MemoryError):
        pool.admit(1, 16, 16)     # 4 > 5 free - 2 reserved
    pool.extend(0)
    assert pool.pages_used() == 3
    assert pool.release(0, 16) == 3
    assert pool.pages_used() == 0 and pool.can_admit(28)
    pool.admit(2, 4, 16)          # 1 now, 3 reserved
    assert pool.release(3, 16) == 0
    assert pool.get_stats()["reserved"] == 3
    pool.release(2, 16)
    assert pool.get_stats()["reserved"] == 0
    with pytest.raises(ValueError):
        PagePool(1, 4)


# ----------------------------------------------------------------- sampling

def test_seeded_sampling_deterministic_and_seed_sensitive(fp32):
    gen = _generator(*fp32)
    try:
        prompt = [9, 4, 27]
        sp = dict(max_new_tokens=12, temperature=0.9, top_k=8)
        a = gen.generate(prompt, SamplingParams(seed=7, **sp), timeout=120)
        b = gen.generate(prompt, SamplingParams(seed=7, **sp), timeout=120)
        c = gen.generate(prompt, SamplingParams(seed=8, **sp), timeout=120)
        assert a == b and a != c
        g1 = gen.generate(prompt, SamplingParams(max_new_tokens=6, seed=1),
                          timeout=120)
        g2 = gen.generate(prompt, SamplingParams(max_new_tokens=6, seed=2),
                          timeout=120)
        assert g1 == g2               # greedy ignores the seed
    finally:
        gen.stop()


def test_sampling_independent_of_batch_composition(fp32):
    prompt = [13, 2, 40]
    sp = SamplingParams(max_new_tokens=8, temperature=0.7, top_k=5, seed=3)
    gen = _generator(*fp32)
    try:
        ref = gen.generate(prompt, sp, timeout=120)
        noise = [gen.submit([1 + (i % 60)] * (1 + i * 3),
                            SamplingParams(max_new_tokens=10, temperature=1.0,
                                           seed=i))
                 for i in range(3)]
        got = gen.generate(prompt, sp, timeout=120)
        for h in noise:
            h.result(timeout=120)
    finally:
        gen.stop()
    assert got == ref


_DIST_N = 20000


def _frequencies(draws, V):
    return np.bincount(np.asarray(draws).ravel(), minlength=V) / draws.size


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.6, 3),
                                               (1.7, 5)])
def test_sampling_distribution_matches_jax(temperature, top_k):
    V = 8
    logits = np.random.RandomState(1).randn(V).astype(np.float32) * 1.5
    scaled = logits / temperature
    keep = np.argsort(-scaled)[:top_k] if top_k else np.arange(V)
    exact = np.zeros(V)
    exact[keep] = np.exp(scaled[keep] - scaled[keep].max())
    exact /= exact.sum()
    jkeys = jax.random.split(jax.random.PRNGKey(0), _DIST_N)
    jtok, _ = jsampling.sample_tokens(
        jnp.tile(jnp.asarray(logits), (_DIST_N, 1)), jkeys,
        jnp.full(_DIST_N, temperature, jnp.float32),
        jnp.full(_DIST_N, top_k, jnp.int32))
    keys = torch.tensor([sampling.seed_key(i) for i in range(_DIST_N)])
    tok, new_keys = sampling.sample_tokens(
        torch.from_numpy(np.tile(logits, (_DIST_N, 1))), keys,
        torch.full((_DIST_N,), temperature), torch.full((_DIST_N,), top_k))
    assert torch.equal(new_keys[:, 1], keys[:, 1] + 1)   # one step each
    bound = 5 * np.sqrt(exact * (1 - exact) / _DIST_N) + 1e-12
    for name, draws in (("jax", np.asarray(jtok)), ("port", tok.numpy())):
        freq = _frequencies(draws, V)
        assert (np.abs(freq - exact) <= bound).all(), (name, freq, exact)
        assert not freq[exact == 0].any(), name   # outside the top k


def test_greedy_consumes_no_randomness_and_counters_advance():
    logits = torch.randn(3, 16)
    keys = torch.tensor([sampling.seed_key(5), sampling.seed_key(6),
                         sampling.seed_key(7)])
    temp = torch.tensor([0.0, 0.8, 0.8])
    tok, new = sampling.sample_tokens(logits, keys, temp,
                                      torch.zeros(3, dtype=torch.int64))
    assert int(tok[0]) == int(torch.argmax(logits[0]))
    assert new[:, 1].tolist() == [0, 1, 1]
    assert torch.equal(new[:, 0], keys[:, 0])
    # the same key draws the same token; the next counter usually not
    again, _ = sampling.sample_tokens(logits, keys, temp,
                                      torch.zeros(3, dtype=torch.int64))
    assert torch.equal(tok, again)


def test_verify_tokens_consume_the_stream_as_sequential_decode():
    """Drafts equal to the samples are accepted, and the emitted tokens and
    final keys equal Q sequential ``sample_tokens`` steps; a wrong draft
    stops the burst at its position with the sample emitted."""
    g = torch.Generator().manual_seed(0)
    S, Q, V = 4, 4, 32
    logits = torch.randn(S, Q, V, generator=g) * 2
    keys = torch.tensor([sampling.seed_key(s) for s in range(S)])
    temp = torch.tensor([0.0, 0.9, 1.3, 0.7])
    top_k = torch.tensor([0, 0, 6, 3])
    seq, cur = [], keys
    for i in range(Q):
        t, cur = sampling.sample_tokens(logits[:, i], cur, temp, top_k)
        seq.append(t)
    seq = torch.stack(seq, 1)
    span = torch.tensor([4, 4, 2, 4])
    active = torch.tensor([True, True, True, False])
    draft = seq[:, :Q - 1].clone()
    draft[1, 1] = (draft[1, 1] + 1) % V          # slot 1 rejects at 2
    out, n_emit, new_keys = sampling.verify_tokens(
        logits, draft, span, active, keys, temp, top_k)
    assert n_emit.tolist() == [4, 2, 2, 0]
    assert out[0].tolist() == seq[0].tolist()
    assert out[1, :2].tolist() == seq[1, :2].tolist()
    assert out[2, :2].tolist() == seq[2, :2].tolist()
    assert (out[3] == -1).all() and torch.equal(new_keys[3], keys[3])
    assert torch.equal(new_keys[0], cur[0])
    assert int(new_keys[1, 1] - keys[1, 1]) == 2


# ------------------------------------------------------- engine behaviour

def test_eos_evicts_early(fp32):
    gen = _generator(*fp32)
    try:
        prompt = [3, 17, 5]
        full = gen.generate(prompt, SamplingParams(max_new_tokens=8),
                            timeout=120)
        eos = full[3]
        got = gen.generate(prompt, SamplingParams(max_new_tokens=8,
                                                  eos_id=eos), timeout=120)
        assert got == full[:full.index(eos) + 1] and len(got) < len(full)
    finally:
        gen.stop()


def test_submit_validation(fp32):
    gen = _generator(*fp32, prefill_buckets=(16, 32))
    try:
        with pytest.raises(ValueError):
            gen.submit([])
        with pytest.raises(ValueError):
            gen.submit([1] * 33)                   # > largest bucket
        with pytest.raises(ValueError):
            gen.submit([1] * 16, SamplingParams(max_new_tokens=49))
        with pytest.raises(ValueError):
            gen.submit([1], slo="platinum")
        with pytest.raises(ValueError):
            SamplingParams(max_new_tokens=0)
        with pytest.raises(ValueError):
            GenerationConfig(backpressure="dropit")
        with pytest.raises(ValueError):
            GenerationConfig(max_seq=64, prefill_buckets=(16, 128))
        with pytest.raises(ValueError):
            GenerationConfig(kv_dtype="float8")
    finally:
        gen.stop()


def test_pool_too_small_for_request_rejected_at_submit(fp32):
    gen = _generator(*fp32, pool_pages=4)  # 3 pages = 24 tokens
    try:
        with pytest.raises(ValueError):
            gen.submit([1] * 16, SamplingParams(max_new_tokens=16))
        assert len(gen.generate([1] * 4, SamplingParams(max_new_tokens=2),
                                timeout=120)) == 2
    finally:
        gen.stop()


def test_backpressure_reject_and_block(fp32):
    gen = _generator(*fp32, max_queue=1, backpressure="reject", start=False)
    h = gen.submit([1, 2], SamplingParams(max_new_tokens=2))
    with pytest.raises(QueueFullError):
        gen.submit([3, 4], SamplingParams(max_new_tokens=2))
    gen.stop(drain=True)              # never started: drains inline
    assert len(h.result(timeout=60)) == 2

    gen2 = _generator(*fp32, max_queue=1, backpressure="block", start=False)
    gen2.submit([1, 2], SamplingParams(max_new_tokens=2))
    unblocked = []

    def blocked_submit():
        try:
            unblocked.append(
                gen2.submit([5, 6], SamplingParams(max_new_tokens=2)))
        except ServerClosedError as err:
            unblocked.append(err)

    t = threading.Thread(target=blocked_submit)
    t.start()
    time.sleep(0.2)
    assert not unblocked              # still blocked on the full queue
    gen2.start()
    t.join(120)
    assert not t.is_alive()
    assert unblocked and isinstance(unblocked[0].result(timeout=120), list)
    gen2.stop()

    gen3 = _generator(*fp32, max_queue=1, submit_timeout_ms=50, start=False)
    gen3.submit([1, 2], SamplingParams(max_new_tokens=2))
    with pytest.raises(QueueFullError):
        gen3.submit([3], SamplingParams(max_new_tokens=2))
    gen3.stop(drain=False)


def test_clean_drain_serves_everything(fp32):
    gen = _generator(*fp32)
    handles = [gen.submit([1 + i] * (2 + i), SamplingParams(max_new_tokens=5))
               for i in range(6)]
    gen.stop(drain=True)
    for h in handles:
        assert len(h.result(timeout=60)) == 5
    gen.pool.assert_no_leaks()
    with pytest.raises(ServerClosedError):
        gen.submit([1], SamplingParams(max_new_tokens=1))
    stats = gen.get_stats()
    assert stats["completed"] == 6 and stats["stopped"]


def test_abort_fails_queued_and_in_flight(fp32):
    gen = _generator(*fp32, max_batch=1)
    handles = [gen.submit([2 + i] * 3, SamplingParams(max_new_tokens=60))
               for i in range(4)]
    # the first is decoding (one token of 60 out), the rest are queued
    next(handles[0].stream(timeout=60))
    gen.stop(drain=False)
    failed = 0
    for h in handles:
        try:
            h.result(timeout=60)
        except ServerClosedError:
            failed += 1
    assert failed >= 3
    gen.pool.assert_no_leaks()


def test_slo_classes_and_queue_deadline(fp32):
    gen = _generator(*fp32, max_batch=1, start=False)
    order = []
    hs = [(name, gen.submit([3, 4], SamplingParams(max_new_tokens=1),
                            slo=name))
          for name in ("batch", "standard", "interactive")]
    expiring = gen.submit([5], SamplingParams(max_new_tokens=1),
                          slo=gen_mod.SLOClass("late", -20, deadline_ms=1))
    time.sleep(0.05)
    for name, h in hs:
        h.future.add_done_callback(lambda _f, n=name: order.append(n))
    gen.start()
    for _, h in hs:
        h.result(timeout=60)
    with pytest.raises(gen_mod.DeadlineExceeded):
        expiring.result(timeout=60)
    gen.stop()
    assert order == ["interactive", "standard", "batch"]
    assert gen.get_stats()["control"]["slo"]["expired"] == 1


def test_stats_carry_the_jax_engine_keys(jax_gen, fp32):
    gen = _generator(*fp32)
    try:
        for g in (gen, jax_gen):
            g.generate([1, 2, 3], SamplingParams(max_new_tokens=3),
                       timeout=120)
    finally:
        gen.stop()
    want = set(jax_gen.get_stats()) - {"perf"}
    got = gen.get_stats()
    assert want <= set(got), sorted(want - set(got))
    for section in ("capacity", "config", "resilience", "control", "pool",
                    "speculative"):
        assert set(jax_gen.get_stats()[section]) <= set(got[section]), \
            section
    assert gen.kv_read_bytes_per_token(10) == \
        jax_gen.kv_read_bytes_per_token(10)


# --------------------------------------------- config, and what is not ported

def test_flags_and_prefill_ladder_match_jax():
    for name in ("MXNET_GEN_PAGE_SIZE", "MXNET_GEN_DECODE_BLOCKS",
                 "MXNET_GEN_MAX_BATCH", "MXNET_GEN_MAX_SEQ",
                 "MXNET_GEN_POOL_PAGES", "MXNET_GEN_QUEUE",
                 "MXNET_GEN_SUBMIT_TIMEOUT", "MXNET_GEN_DEADLINE_MS",
                 "MXNET_GEN_PREFIX_CACHE", "MXNET_GEN_PREFIX_PAGES",
                 "MXNET_GEN_SLO_AGING_MS", "MXNET_GEN_SPEC_K",
                 "MXNET_GEN_SPEC_NGRAM"):
        assert get_flag(name) == jget_flag(name), name
    for n in (8, 16, 100, 256, 2048):
        assert default_prefill_ladder(n) == jgen.default_prefill_ladder(n)
    assert default_prefill_ladder(2048) == (16, 32, 64, 128, 256, 512, 1024,
                                            2048)
    assert sorted(gen_mod.__all__) == sorted(jgen.__all__)


def test_unported_parts_raise(fp32):
    # the control plane, amp and int8 KV pages are all ported now: each
    # option constructs, and none raises
    gen = _generator(*fp32, kv_dtype="int8", start=False)
    assert gen.kv_dtype == "int8"
    assert gen._pools["k"].dtype == torch.int8
    assert gen._pools["ks"].shape == gen._pools["k"].shape[:-1]
    gen.stop()
    assert "quantize" in mx.graph_pass.PassConfig(spec="quantize").passes
    gen = _generator(*fp32, prefix_cache=True, amp=True, start=False)
    assert isinstance(gen.prefix_cache, gen_mod.PrefixCache)
    assert gen.get_stats()["graph_pass"]["amp"] is True
    gen.stop()


def test_from_checkpoint_serves_a_jax_checkpoint(tmp_path, fp32):
    """The training-to-serving hand-off across packages: the JAX package's
    ``save_checkpoint`` file served by the port, token for token the
    port's own parameters' output."""
    mesh = jmake_mesh({"dp": 1}, devices=jax.devices("cpu")[:1])
    jtp = JTP(mesh, dtype=np.float32, **_CFG)
    path = str(tmp_path / "lm")
    jtp.save_checkpoint(jtp.init(0), path)
    model, params = fp32
    gen = Generator.from_checkpoint(path, model, config=GenerationConfig(
        **_GEOMETRY), start=True)
    ref = _generator(model, params)
    try:
        prompt = [4, 8, 15, 16, 23, 42]
        sp = SamplingParams(max_new_tokens=6)
        assert gen.generate(prompt, sp, timeout=120) == \
            ref.generate(prompt, sp, timeout=120)
    finally:
        gen.stop()
        ref.stop()
