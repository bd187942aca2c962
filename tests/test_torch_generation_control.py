"""Port parity: the Generator's control plane against the JAX package's, on
the CPU, with the JAX tests' small model (vocab 64, d 32, 4 heads, 2
layers, d_ff 64, 2 experts) and geometry (page 8, 4 slots, max_seq 64,
buckets 16 / 32 / 64).

* the amp policy: ``GenerationConfig(amp=True)`` (or ``amp`` in
  ``MXNET_GRAPH_PASSES``) casts the parameters to bf16 once, flags
  ``get_stats()["graph_pass"]["amp"]`` and records a ``generation`` entry
  in ``graph_pass.recent_reports()``; its prefill logits lie within 2e-2
  of max |logit| of the JAX amp generator's (tests/test_graph_passes.py
  test_generation_amp_policy);
* the tuning-cache consult: one cache file written by the JAX package
  resolves ``page_size``, ``decode_blocks``, ``spec_k``, ``kv_dtype``,
  ``prefix_pages`` and the SLO aging alike in both packages, explicit
  config beats the cache and a corrupt entry falls back to the flag;
* the ``generation.*`` counters and gauges after the same traffic equal
  the JAX package's, and one request's trace has the same phases;
* a ``generation.decode_step`` fault fails only the faulted step's slots;
* a queued interactive request overtakes a queued batch one, never an
  in-flight slot.
"""
import time

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu import autotune as jtune
from mxnet_tpu import graph_pass as jgp
from mxnet_tpu.observability import metrics as jmetrics
from mxnet_tpu.observability import request_trace as jtrace
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.transformer import TransformerParallel as JTP
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.serving import generation as jgen
from mxnet_tpu_torch import autotune as ttune
from mxnet_tpu_torch import graph_pass as tgp
from mxnet_tpu_torch.observability import metrics as tmetrics
from mxnet_tpu_torch.observability import request_trace as ttrace
from mxnet_tpu_torch.parallel import TransformerParallel, make_mesh
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.serving import generation as tgen
from mxnet_tpu_torch.serving.generation.engine import generation_tune_key

_CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            n_experts=2)
_GEOMETRY = dict(page_size=8, decode_blocks=128, max_batch=4, max_seq=64,
                 prefill_buckets=(16, 32, 64))
_PINNED = dict(spec_k=0, kv_dtype="model", amp=False, slo_aging_ms=500)
PKGS = {"jax": (jgen, jmetrics, jtrace, jfaults),
        "torch": (tgen, tmetrics, ttrace, tfaults)}


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.setenv("MXNET_TUNE_FINGERPRINT", "test")
    monkeypatch.delenv("MXNET_GRAPH_PASSES", raising=False)
    for f in (jfaults, tfaults):
        f.reset()
    jtune.reset()
    ttune.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    for f in (jfaults, tfaults):
        f.reset()
    jtune.reset()
    ttune.reset()
    jgp.set_passes(None)
    tgp.set_passes(None)


@pytest.fixture
def telemetry():
    for m in (jmetrics, tmetrics):
        m.set_enabled(True)
        m.reset_metrics()
    yield
    for m in (jmetrics, tmetrics):
        m.reset_metrics()
        m.set_enabled(False)


def _model(name):
    if name == "jax":
        mesh = jmake_mesh({"dp": 1}, devices=jax.devices("cpu")[:1])
        model = JTP(mesh, dtype=np.float32, **_CFG)
    else:
        model = TransformerParallel(
            make_mesh({"dp": 1}, devices=[tmx.cpu()]), dtype=np.float32,
            **_CFG)
    return model, model.init(0)


def _generator(name, start=True, **kw):
    cfg = dict(_GEOMETRY, **_PINNED)
    cfg.update(kw)
    cfg = {k: v for k, v in cfg.items() if v is not None}
    gen = PKGS[name][0]
    model, params = _model(name)
    return gen.Generator(model, params, gen.GenerationConfig(**cfg),
                         start=start)


# -------------------------------------------------------------- amp policy

def test_generation_amp_policy():
    gen = _generator("torch", amp=True)
    try:
        assert gen.get_stats()["graph_pass"]["amp"] is True
        assert all(v.dtype == torch.bfloat16 for v in gen._params.values())
        toks = gen.submit([1, 2, 3],
                          tgen.SamplingParams(max_new_tokens=4)).result(60)
        assert len(toks) == 4 and all(0 <= t < 64 for t in toks)
    finally:
        gen.stop()
    assert any(r.get("program") == "generation" and r.get("amp")
               for r in tgp.recent_reports())
    # the default stays fp32: amp is OFF unless opted in
    gen2 = _generator("torch")
    try:
        assert gen2.get_stats()["graph_pass"]["amp"] is False
    finally:
        gen2.stop()
    # amp in the pass spec turns it on for a config that leaves it unset
    tgp.set_passes("default,amp")
    gen3 = _generator("torch", amp=None, start=False)
    assert gen3.get_stats()["graph_pass"]["amp"] is True
    gen3.stop()


def test_amp_prefill_logits_match_jax():
    """The bf16 parameters of both amp generators through each package's
    ``prefill_forward``: fp32 logits within 2e-2 of max |logit|."""
    gens = {n: _generator(n, amp=True, start=False) for n in PKGS}
    tokens = np.random.RandomState(0).randint(1, 64, (1, 16))
    try:
        jlog, _, _ = gens["jax"]._model.prefill_forward(
            gens["jax"]._params, tokens)
        tlog, _, _ = gens["torch"]._model.prefill_forward(
            gens["torch"]._params, tokens)
    finally:
        for g in gens.values():
            g.stop()
    want = np.asarray(jlog, np.float32)
    got = tlog.float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


# ------------------------------------------------------------ tuning cache

_KNOBS = (("generation.page_size", {"page_size": 4}),
          ("generation.decode_blocks", {"decode_blocks": 64}),
          ("generation.spec_k", {"spec_k": 2}),
          ("generation.kv_dtype", {"kv_dtype": "bfloat16"}),
          ("control.prefix_pages", {"prefix_pages": 5}),
          ("control.slo_aging", {"aging_ms": 0}))


def _resolved(name, **kw):
    gen = _generator(name, start=False, prefix_cache=True, **kw)
    try:
        return (gen.page_size, gen.decode_blocks, gen.spec_k, gen.kv_dtype,
                gen.prefix_cache.capacity_pages, gen._aging_ms)
    finally:
        gen.stop()


_UNPINNED = dict(page_size=None, decode_blocks=None, spec_k=None,
                 kv_dtype=None, slo_aging_ms=None)


def test_tuning_cache_resolves_alike():
    jmodel, _ = _model("jax")
    tmodel, _ = _model("torch")
    key = generation_tune_key(tmodel, 4, 64)
    assert key == jgen.engine.generation_tune_key(jmodel, 4, 64)
    # one cache file, written by the JAX package, read by both
    for op, value in _KNOBS:
        jtune.record(op, key, value)
    ttune.reset()
    got = {n: _resolved(n, **_UNPINNED) for n in PKGS}
    assert got["torch"] == got["jax"] == (4, 64, 2, "bfloat16", 5, 0)
    # explicit config beats the cache
    explicit = dict(_UNPINNED, page_size=16, spec_k=0, slo_aging_ms=250)
    got = {n: _resolved(n, **explicit) for n in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 16 and got["torch"][2] == 0
    assert got["torch"][5] == 250


def test_tuning_cache_page_size_repair():
    """The repair's own witness: before it, the port took the flag's page
    size (16) where the JAX package took the cache's."""
    tmodel, _ = _model("torch")
    jtune.record("generation.page_size", generation_tune_key(tmodel, 4, 64),
                 {"page_size": 8})
    ttune.reset()
    sizes = {n: _generator(n, start=False, page_size=None).page_size
             for n in PKGS}
    assert sizes == {"jax": 8, "torch": 8}


def test_corrupt_tuning_entries_fall_back_to_the_flags():
    tmodel, _ = _model("torch")
    key = generation_tune_key(tmodel, 4, 64)
    jtune.record("generation.page_size", key, {"page_size": "x"})
    jtune.record("generation.spec_k", key, {"spec_k": -3})
    jtune.record("generation.kv_dtype", key, {"kv_dtype": "fp7"})
    ttune.reset()
    got = {n: _resolved(n, **_UNPINNED) for n in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == (16, 128, 0, "model")


# --------------------------------------------------------------- metrics

def _traffic(name):
    """Serial traffic through a prefix-cached generator: (outputs, the
    generation.* series, one trace's phases)."""
    gen_mod, metrics, rtrace, _ = PKGS[name]
    rtrace.reset()
    gen = _generator(name, prefix_cache=True)
    head = list(range(1, 17))
    try:
        outs = [gen.generate(p, gen_mod.SamplingParams(max_new_tokens=n),
                             timeout=120)
                for p, n in ((head, 3), (head + [40, 41], 4), ([5] * 9, 2),
                             (head, 2))]
        stats = gen.get_stats()
    finally:
        gen.stop()
    series = {}
    for mname, labels, kind, _b, payload in metrics.snapshot_values():
        if not mname.startswith("generation."):
            continue
        # histograms: observation counts (their values are wall times)
        value = payload[2] if kind == "histogram" else payload
        # a reset registry may keep instruments another test made, at 0
        if value:
            series[(mname, labels)] = value
    traces = rtrace.reservoir().recent()
    phases = [[e[0] for e in t.events] for t in traces]
    return outs, series, phases, stats


def test_generation_series_match_jax(telemetry):
    want = _traffic("jax")
    got = _traffic("torch")
    assert got[0] == want[0]
    assert got[1] == want[1]
    # 16 on the shared head, 15 on the page-aligned repeat (its last
    # token recomputed, copy-on-write)
    assert got[1][("generation.prefill_tokens_skipped", ())] == 31
    assert got[1][("generation.tokens_generated", ())] == 11
    assert got[2] == want[2]
    # each trace: submit, queue, the cache lookup, prefill (TTFT) and one
    # decode phase per token after the first
    assert sorted(len(p) for p in got[2]) == [5, 5, 6, 7]
    for phases in got[2]:
        assert phases[:4] == ["submit", "queue", "prefix_match", "prefill"]
        assert set(phases[4:]) == {"decode"}
    assert got[3]["control"]["prefill_tokens_skipped"] == 31
    text = tmetrics.dump_metrics()
    for series in ("generation_ttft_ms", "generation_itl_ms",
                   "generation_prefix_hits", "generation_slo_completed"):
        assert series in text, series


# ------------------------------------------------------------------ faults

def _faulted(name):
    gen_mod, _, _, faults = PKGS[name]
    faults.configure("generation.decode_step:raise@call=2", seed=0)
    gen = _generator(name, max_batch=2)
    try:
        h1 = gen.submit([1, 2, 3],
                        gen_mod.SamplingParams(max_new_tokens=8, seed=1))
        with pytest.raises(faults.InjectedFault):
            h1.result(timeout=60)
        # the loop survived: a later request decodes normally
        toks = gen.submit([4, 5], gen_mod.SamplingParams(
            max_new_tokens=4, seed=2)).result(timeout=60)
        stats = gen.get_stats()
    finally:
        gen.stop()
    gen.pool.assert_no_leaks()
    return toks, stats["decode_faults"], stats["resilience"]


def test_decode_fault_contained_to_its_step():
    got, want = _faulted("torch"), _faulted("jax")
    assert got == want
    assert got[1] == 1 and len(got[0]) == 4


# ---------------------------------------------------------- SLO overtake

def _admit_order(name):
    gen_mod = PKGS[name][0]
    gen = _generator(name, max_batch=1)
    order = []
    real = gen._prefill

    def spy(slot, ent, worst):
        order.append(ent.prompt[0])
        return real(slot, ent, worst)

    gen._prefill = spy
    try:
        blocker = gen.submit([9] * 4, gen_mod.SamplingParams(
            max_new_tokens=25), slo="batch")
        time.sleep(0.05)
        hb = gen.submit([10] * 4, gen_mod.SamplingParams(max_new_tokens=2),
                        slo="batch")
        hi = gen.submit([11] * 4, gen_mod.SamplingParams(max_new_tokens=2),
                        slo="interactive")
        n_blocker = len(blocker.result(timeout=120))
        hi.result(timeout=120)
        hb.result(timeout=120)
    finally:
        gen._prefill = real
        gen.stop()
    gen.pool.assert_no_leaks()
    return n_blocker, [t for t in order if t in (10, 11)]


def test_interactive_overtakes_queue_not_slots():
    got = _admit_order("torch")
    assert got == _admit_order("jax") == (25, [11, 10])
