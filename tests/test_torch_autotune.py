"""The port's autotuner against the JAX package's (tests/test_autotune.py's
cases, one counterpart each where it concerns what the port has): the
tuning cache's file protocol (one schema: a file written by either
package loads in the other, scrubs alike), the search loop's trajectory
and winner under the same deterministic measurer, the consulting call
sites (flash rows, fused tiles, executor remat, the layout pass, the
served ladder) and ``lookup_or_tune``'s guards. Everything here runs on
the CPU in seconds; the card's side (tiles launched, captures) is in
tests/test_torch_cuda.py.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autotune as jat
from mxnet_tpu import graph_pass as jgp
from mxnet_tpu_torch import autotune as tat
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import graph_pass as tgp
from mxnet_tpu_torch.autotune import (SearchConfig, cache, cost_model,
                                      registry)
from mxnet_tpu_torch.autotune import search as tsearch
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import fused as tfused

import importlib

TFA = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    """One hermetic cache file for both packages, a pinned fingerprint,
    clean counters."""
    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.setenv("MXNET_TUNE_FINGERPRINT", "fp-A")
    for c in (cache, jat.cache):
        c.reset()
        c.reset_stats()
    yield tmp_path
    for c in (cache, jat.cache):
        c.reset()
        c.reset_stats()


def _fc_net(mx, hidden=8):
    data = mx.sym.Variable("data")
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(data, num_hidden=hidden, name="fc"),
        name="softmax")


# --------------------------------------------------------------- cache
def test_round_trip_persistence(tune_env):
    key = ("T512", "D64", "causal")
    tat.record("flash_attention.fwd", key, {"block_q": 128, "block_k": 64},
               dtype="bfloat16", ms=1.25, trials=5)
    cache.reset()
    assert tat.lookup("flash_attention.fwd", key, dtype="bfloat16") == \
        {"block_q": 128, "block_k": 64}
    entry = tat.lookup_entry("flash_attention.fwd", key, dtype="bfloat16")
    assert entry["fingerprint"] == "fp-A"
    assert entry["ms"] == 1.25 and entry["trials"] == 5
    with open(os.environ["MXNET_TUNE_CACHE"]) as f:
        payload = json.load(f)
    assert payload["version"] == 1
    assert list(payload["entries"]) == [
        "fp-A|flash_attention.fwd|T512,D64,causal|bfloat16"]


def test_dtype_and_key_separate_entries(tune_env):
    tat.record("op", "k", {"v": 1}, dtype="bfloat16")
    tat.record("op", "k", {"v": 2}, dtype="float32")
    tat.record("op", "k2", {"v": 3}, dtype="bfloat16")
    assert tat.lookup("op", "k", dtype="bfloat16") == {"v": 1}
    assert tat.lookup("op", "k", dtype="float32") == {"v": 2}
    assert tat.lookup("op", "k2", dtype="bfloat16") == {"v": 3}


def test_concurrent_tuners_atomic_merge(tune_env):
    n = 12
    errs = []

    def tuner(i):
        try:
            tat.record("op%d" % i, ("k", i), {"winner": i})
        except Exception as err:  # pragma: no cover
            errs.append(err)

    threads = [threading.Thread(target=tuner, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs
    with open(os.environ["MXNET_TUNE_CACHE"]) as f:
        assert len(json.load(f)["entries"]) == n
    cache.reset()
    for i in range(n):
        assert tat.lookup("op%d" % i, ("k", i)) == {"winner": i}


def test_cross_process_merge_on_write(tune_env):
    """A second process writing the same file (the port's) does not lose
    this process's entries, and vice versa."""
    tat.record("op.mine", "k", {"v": "mine"})
    child = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r)\n"
         "from mxnet_tpu_torch import autotune\n"
         "autotune.record('op.theirs', 'k', {'v': 'theirs'})\n" % _REPO],
        env=dict(os.environ), capture_output=True, text=True, timeout=300)
    assert child.returncode == 0, child.stderr
    tat.record("op.mine2", "k", {"v": "mine2"})
    cache.reset()
    for op, v in (("op.mine", "mine"), ("op.theirs", "theirs"),
                  ("op.mine2", "mine2")):
        assert tat.lookup(op, "k") == {"v": v}, op


def test_cache_files_load_in_both_packages(tune_env):
    """One schema: entries the JAX package writes resolve in the port and
    the port's in the JAX package, keys and bodies alike."""
    jat.record("serving.buckets", ("g", "default"), {"buckets": [1, 4]},
               ms=2.0, trials=3)
    tat.record("exec.remat", "g", {"mirror": 1}, ms=1.5, trials=2)
    cache.reset()
    jat.cache.reset()
    assert tat.lookup("serving.buckets", ("g", "default")) == \
        {"buckets": [1, 4]}
    assert jat.lookup("exec.remat", "g") == {"mirror": 1}
    assert tat.cache.entries() == jat.cache.entries()
    for e in tat.cache.entries().values():
        assert set(e) >= {"value", "fingerprint", "op", "key", "dtype",
                          "time", "ms", "trials"}


def test_stale_fingerprint_invalidation(tune_env, monkeypatch):
    key = ("T512", "D64", "causal")
    tat.record("flash_attention.fwd", key, {"block_q": 128},
               dtype="bfloat16")
    monkeypatch.setenv("MXNET_TUNE_FINGERPRINT", "fp-B")
    cache.reset()
    assert tat.lookup("flash_attention.fwd", key, dtype="bfloat16") is None
    assert tat.scrub_stale() == 1
    with open(os.environ["MXNET_TUNE_CACHE"]) as f:
        assert json.load(f)["entries"] == {}
    monkeypatch.setenv("MXNET_TUNE_FINGERPRINT", "fp-A")
    cache.reset()
    assert tat.lookup("flash_attention.fwd", key, dtype="bfloat16") is None


def test_scrub_stale_agrees_with_the_jax_package(tune_env, monkeypatch):
    """The same mixed file, scrubbed by each package under the same
    fingerprint, keeps the same entries (and a TPU entry never survives on
    the card's fingerprint)."""
    path = os.environ["MXNET_TUNE_CACHE"]
    entries = {
        "fp-A|op.a|k|-": {"value": {"v": 1}, "fingerprint": "fp-A"},
        "fp-B|op.b|k|-": {"value": {"v": 2}, "fingerprint": "fp-B"},
        "tpu:TPU v5 lite|fusion.blocks|M128,N128,K128|float32": {
            "value": {"block_m": 128}, "fingerprint": "tpu:TPU v5 lite"},
        "fp-A|op.c|k|-": {"value": {"v": 3}},
        "fp-A|op.bad|k|-": "oops"}
    kept = []
    for scrub, c in ((tat.scrub_stale, cache), (jat.scrub_stale, jat.cache)):
        with open(path, "w") as f:
            json.dump({"version": 1, "entries": entries}, f)
        c.reset()
        n = scrub()
        with open(path) as f:
            kept.append((n, sorted(json.load(f)["entries"])))
    assert kept[0] == kept[1]
    assert kept[0] == (2, ["fp-A|op.a|k|-", "fp-A|op.c|k|-"])


def test_bypass_mode_skips_lookup(tune_env):
    tat.record("op", "k", {"v": 1})
    tconfig.set_flag("MXNET_TUNE", -1)
    try:
        assert tat.lookup("op", "k") is None
        assert tat.lookup_or_tune("op", "k") is None
    finally:
        tconfig.set_flag("MXNET_TUNE", None)
    assert tat.lookup("op", "k") == {"v": 1}


def test_carry_drops_with_entries_and_tuning_flags(tune_env, monkeypatch):
    """What the consumers carry is dropped by a record, save, reload,
    reset, scrub, another cache file and a tuning flag's set_flag; other
    flags and lookups leave it."""
    carry = cache.Carry()

    def filled():
        carry.values["k"] = 1
        return carry

    for change in (lambda: tat.record("op", "k", {"v": 1}), cache.save,
                   cache.reload, cache.reset, cache.scrub_stale,
                   lambda: tconfig.set_flag("MXNET_FUSION_BLOCK_M", 64),
                   lambda: tconfig.set_flag("MXNET_FLASH_BWD_BLOCK_K", 64),
                   lambda: tconfig.set_flag("MXNET_TUNE", -1)):
        filled()
        change()
        assert carry.values == {}, change
    for name in ("MXNET_FUSION_BLOCK_M", "MXNET_FLASH_BWD_BLOCK_K",
                 "MXNET_TUNE"):
        tconfig.set_flag(name, None)
    filled()
    tat.lookup("op", "k")
    tconfig.set_flag("MXNET_PERF", 0)
    tconfig.set_flag("MXNET_PERF", None)
    assert carry.values == {"k": 1}
    cache.entries()
    monkeypatch.setenv("MXNET_TUNE_CACHE",
                       os.environ["MXNET_TUNE_CACHE"] + ".other")
    tat.lookup("op", "k")
    assert carry.values == {}


# -------------------------------------------------------------- search
def test_search_measures_default_first_and_finds_optimum(tune_env):
    t = registry.declare(
        "test.knob", space={"a": (1, 2, 3, 4), "b": (10, 20)},
        default=lambda ctx: {"a": 4, "b": 20})
    log = []

    def measure(c):
        log.append(dict(c))
        return 1e-3 + abs(c["a"] - 2) * 1e-4 + abs(c["b"] - 10) * 1e-5

    res = tsearch.search(t, measure, cfg=SearchConfig(trials=16))
    assert log[0] == {"a": 4, "b": 20}, "incumbent default measured first"
    assert res.best == {"a": 2, "b": 10}
    assert res.measured == len(log) <= 16
    assert cache.stats()["measurements"] == len(log)
    assert cache.stats()["searches"] == 1


def test_search_budget_and_dedup(tune_env):
    t = registry.declare("test.knob2", space={"a": tuple(range(32))})
    calls = []
    res = tsearch.search(t, lambda c: calls.append(dict(c)) or 1.0,
                         cfg=SearchConfig(trials=5))
    assert res.measured == 5 and len(calls) == 5
    assert len({tuple(sorted(c.items())) for c in calls}) == 5


def _trajectory(pkg_search, pkg_registry, op, ctx, cost, trials):
    log = []

    def measure(c):
        log.append(dict(c))
        return cost(c)

    res = pkg_search.search(pkg_registry.get(op), measure, ctx=ctx,
                            cfg=pkg_search.SearchConfig(trials=trials))
    return log, res.best, res.best_s, res.measured, res.pruned


def _ladder_cost(c):
    b = c["buckets"]
    return 1e-3 * len(b) + 1e-4 * (max(b) != 8) + 1e-5 * min(b)


_SEARCH_CASES = [
    ("serving.buckets", {"sizes": [1, 1, 2, 3, 8, 5, 2],
                         "max_size": 8}, _ladder_cost, 8),
    ("serving.buckets", {"sizes": [4, 9, 17, 1], "max_size": 17},
     lambda c: 1.0 / (1 + len(c["buckets"])), 3),
    ("graph.layout", {"default": "NHWC"},
     lambda c: {"NHWC": 2e-3, "NCHW": 1e-3}[c["layout"]], 2),
    ("graph.layout", {"default": "NCHW"},
     lambda c: {"NHWC": 1e-3, "NCHW": 2e-3}[c["layout"]], 2),
    ("exec.remat", {}, lambda c: 1e-3 if c["mirror"] else 2e-3, 2),
    ("io.decode_workers", {"cpus": 12},
     lambda c: 1.0 / (1 + c["workers"]) + 0.05 * c["workers"], 4),
    ("io.prefetch_depth", {"cpus": 12},
     lambda c: abs(c["depth"] - 4) * 1e-3 + 1e-3, 4),
    ("generation.page_size", {"max_seq": 128},
     lambda c: abs(c["page_size"] - 32) * 1e-4 + 1e-3, 12),
    ("control.slo_aging", {"pool_pages": 33},
     lambda c: abs(c["aging_ms"] - 250) * 1e-6 + 1e-3, 3),
]


@pytest.mark.parametrize("case", range(len(_SEARCH_CASES)))
def test_search_trajectory_matches_the_jax_package(tune_env, case):
    """The same registry entry, the same deterministic measurer and the
    same SearchConfig: both searches visit the same candidates in the same
    order and return the same best."""
    from mxnet_tpu import executor  # noqa: F401  (declares exec.remat)
    from mxnet_tpu.autotune import registry as jreg
    from mxnet_tpu.autotune import search as jsearch
    from mxnet_tpu.serving import buckets  # noqa: F401

    op, ctx, cost, trials = _SEARCH_CASES[case]
    theirs = _trajectory(jsearch, jreg, op, ctx, cost, trials)
    ours = _trajectory(tsearch, registry, op, ctx, cost, trials)
    assert ours == theirs
    assert len(ours[0]) >= 2


def test_cache_hit_never_triggers_measurement(tune_env):
    t = registry.declare("test.knob3", space={"a": (1, 2)})
    res = tsearch.search(t, lambda c: 1.0, cfg=SearchConfig(trials=2))
    tat.record("test.knob3", "shape", res.best)
    assert cache.stats()["measurements"] > 0
    cache.reset_stats()
    tconfig.set_flag("MXNET_TUNE", 1)
    try:
        for _ in range(3):
            assert tat.lookup("test.knob3", "shape") == res.best
            assert tat.lookup_or_tune("test.knob3", "shape") == res.best
    finally:
        tconfig.set_flag("MXNET_TUNE", None)
    stats = cache.stats()
    assert stats["measurements"] == 0 and stats["searches"] == 0
    assert stats["hits"] == 6


def test_second_process_zero_measurements(tune_env):
    """A fresh process with a warm cache resolves the flash rows through
    the call site's resolution with zero measurements, even under
    MXNET_TUNE=1."""
    key = tat.flash_shape_key(128, 16, False)
    tat.record("flash_attention.fwd", key, {"block_q": 128, "block_k": 64},
               dtype="bfloat16")
    tat.record("flash_attention.bwd", key, {"block_q": 64, "block_k": 64},
               dtype="bfloat16")
    child_src = (
        "import sys, importlib; sys.path.insert(0, %r)\n"
        "from mxnet_tpu_torch import autotune\n"
        "FA = importlib.import_module("
        "'mxnet_tpu_torch.parallel.flash_attention')\n"
        "rows = FA.resolve_rows(1, 2, 128, 16, False, 'bfloat16')\n"
        "assert rows == (128, 64, 64), rows\n"
        "s = autotune.stats()\n"
        "assert s['measurements'] == 0 and s['searches'] == 0, s\n"
        "assert s['hits'] >= 2, s\n"
        "print('OK', s)\n" % _REPO)
    child = subprocess.run(
        [sys.executable, "-c", child_src],
        env=dict(os.environ, MXNET_TUNE="1"),
        capture_output=True, text=True, timeout=300)
    assert child.returncode == 0, child.stdout + child.stderr
    assert "OK" in child.stdout


def test_lookup_or_tune_never_searches_during_a_capture(tune_env,
                                                        monkeypatch):
    """A miss while a stream captures a CUDA graph (simulated) returns
    None and measures nothing, even with MXNET_TUNE=1; outside the
    capture the same miss searches."""
    registry.declare("test.captured", space={"a": (1, 2)})
    calls = []
    import mxnet_tpu_torch.autotune.tuners as tuners

    monkeypatch.setattr(tuners, "auto_tune",
                        lambda op, key, ctx: calls.append(op) or {"a": 2})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    tconfig.set_flag("MXNET_TUNE", 1)
    try:
        assert tat.lookup_or_tune("test.captured", "k") is None
        assert calls == []
        assert cache.stats()["measurements"] == 0
        assert cache.stats()["searches"] == 0
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: False)
        assert tat.lookup_or_tune("test.captured", "k") == {"a": 2}
        assert calls == ["test.captured"]
    finally:
        tconfig.set_flag("MXNET_TUNE", None)


def test_failed_search_logs_and_returns_none(tune_env, monkeypatch):
    import mxnet_tpu_torch.autotune.tuners as tuners

    def boom(op, key, ctx):
        raise RuntimeError("no card")

    monkeypatch.setattr(tuners, "auto_tune", boom)
    tconfig.set_flag("MXNET_TUNE", 1)
    try:
        assert tat.lookup_or_tune("fusion.blocks", "k",
                                  ctx={"M": 1, "N": 1, "K": 1}) is None
    finally:
        tconfig.set_flag("MXNET_TUNE", None)


# ---------------------------------------------------------- cost model
def test_flash_cost_prunes_what_the_kernels_do_not_compile():
    ctx = {"T": 8192, "D": 128, "B": 1, "H": 8, "causal": True,
           "dtype_bytes": 2}
    for bad in ({"block_q": 256, "block_k": 64},
                {"block_q": 128, "block_k": 128}):
        assert cost_model.flash_fwd_cost(bad, ctx) == float("inf")
    for rows in (64, 128):
        sane = cost_model.flash_fwd_cost({"block_q": rows, "block_k": 64},
                                         ctx)
        assert np.isfinite(sane) and sane > 0
        assert cost_model.flash_smem_bytes(rows, 128, 2, "fwd") <= \
            cost_model.SMEM_BYTES
    fp32 = dict(ctx, dtype_bytes=4)
    assert cost_model.flash_fwd_cost({"block_q": 128, "block_k": 64},
                                     fp32) == float("inf")
    assert np.isfinite(cost_model.flash_bwd_cost(
        {"block_q": 64, "block_k": 64}, fp32))
    assert cost_model.flash_bwd_cost({"block_q": 128, "block_k": 64},
                                     fp32) == float("inf")


def test_cost_penalizes_grids_that_leave_sms_idle():
    """Wave quantisation in place of the TPU's per-grid-step cost: at
    512 x 512 the 128-tile grid (16 blocks) leaves most SMs idle, so the
    64 tile (64 blocks) costs less; at ResNet-50's bucket-8 3136-row
    shapes the 128 tile fills the card and costs less."""
    small = {"M": 512, "N": 512, "K": 512, "dtype_bytes": 4}
    c128 = cost_model.fused_matmul_cost(
        {"block_m": 128, "block_n": 128, "block_k": 16}, small)
    c64 = cost_model.fused_matmul_cost(
        {"block_m": 64, "block_n": 64, "block_k": 32}, small)
    assert c64 < c128
    assert cost_model.wave_efficiency(16, 2) < cost_model.wave_efficiency(
        64, 2)
    big = {"M": 8 * 56 * 56, "N": 256, "K": 64, "dtype_bytes": 4}
    assert cost_model.fused_matmul_cost(
        {"block_m": 128, "block_n": 128, "block_k": 16}, big) < \
        cost_model.fused_matmul_cost(
            {"block_m": 64, "block_n": 64, "block_k": 32}, big)
    for bad in ({"block_m": 128, "block_n": 64, "block_k": 16},
                {"block_m": 256, "block_n": 256, "block_k": 16},
                {"block_m": 128, "block_n": 128, "block_k": 32}):
        assert cost_model.fused_matmul_cost(bad, big) == float("inf")


def test_expected_padding_math():
    assert cost_model.expected_padding((1, 2, 4), [1, 2, 3, 4]) == \
        pytest.approx(0.1)
    assert cost_model.expected_padding((1, 2, 4), [10]) == 0.0
    assert cost_model.expected_padding((4,), [1]) == 3.0
    for sizes in ([1, 2, 3, 4], [10], [1], [3, 9, 17, 200]):
        for ladder in ((1, 2, 4), (4,), (1, 8, 32)):
            assert cost_model.expected_padding(ladder, sizes) == \
                jat.cost_model.expected_padding(ladder, sizes)


def test_fusion_space_default_and_survivors():
    """The fusion.blocks space is the compiled tiles: of its candidates
    exactly one per tile edge survives the cost model, and the default
    is the launch's rule (128 where the grid fills the card)."""
    t = tat.get_tunable("fusion.blocks")
    ctx = {"M": 8 * 56 * 56, "N": 256, "K": 64, "dtype_bytes": 4}
    alive = [c for c in t.candidates(ctx)
             if np.isfinite(t.cost(c, ctx))]
    assert sorted((c["block_m"], c["block_k"]) for c in alive) == \
        [(64, 32), (128, 16)]
    assert t.default_value(ctx) == {"block_m": 128, "block_n": 128,
                                    "block_k": 16}
    small = dict(ctx, M=8 * 7 * 7, N=2048, K=512)
    assert t.default_value(small)["block_m"] == 64
    # block_k is the edge's deepest slice, recorded whatever the route;
    # the wrapper takes either depth the edge compiles and no other
    bf16 = dict(ctx, dtype_bytes=2)
    assert t.default_value(bf16) == t.default_value(ctx)
    assert tfused.resolve_blocks(8 * 56 * 56, 256, 64, block_m=128,
                                 block_k=8) == (128, 128, 8)
    assert tfused.resolve_blocks(8 * 56 * 56, 256, 64,
                                 block_k=32) == (64, 64, 32)
    with pytest.raises(MXNetError, match="not one the kernel compiles"):
        tfused.resolve_blocks(8 * 56 * 56, 256, 64, block_m=128,
                              block_k=32)


# ------------------------------------------------- consulting call sites
def test_flash_attention_consults_tuned_rows(tune_env):
    """A tuned entry steers the rows the call site resolves; the plain
    versions on the CPU give the same result at every rows argument."""
    key = tat.flash_shape_key(128, 16, True)
    assert TFA.resolve_rows(1, 2, 128, 16, True, "bfloat16") == \
        (64, 128, 128)
    tat.record("flash_attention.fwd", key, {"block_q": 128, "block_k": 64},
               dtype="bfloat16")
    tat.record("flash_attention.bwd", key, {"block_q": 64, "block_k": 64},
               dtype="bfloat16")
    cache.reset_stats()
    assert TFA.resolve_rows(1, 2, 100, 16, True, "bfloat16") == \
        (128, 64, 64)
    assert cache.stats()["hits"] == 2
    assert cache.stats()["measurements"] == 0
    # explicit arguments win over the cache
    assert TFA.resolve_rows(1, 2, 100, 16, True, "bfloat16",
                            block_q=64, block_k_bwd=128) == (64, 64, 128)
    rng = np.random.RandomState(3)
    q, k, v = (torch.tensor(rng.randn(1, 2, 100, 16), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    outs = []
    for rows in ((None,) * 4, (64, 64, 128, 64), (128, 64, 64, 128)):
        o = TFA.flash_attention(q, k, v, causal=True, block_q=rows[0],
                                block_k=rows[1], block_q_bwd=rows[2],
                                block_k_bwd=rows[3])
        g = torch.autograd.grad(o.sum(), (q, k, v))
        outs.append((o.detach(),) + g)
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


def test_flash_rows_not_compiled_raise(tune_env):
    with pytest.raises(MXNetError, match="not compiled"):
        TFA.resolve_rows(1, 2, 64, 16, True, "float32", block_q=128)
    key = tat.flash_shape_key(64, 16, True)
    tat.record("flash_attention.bwd", key, {"block_q": 256, "block_k": 64},
               dtype="bfloat16")
    with pytest.raises(MXNetError, match="cache entry"):
        TFA.resolve_rows(1, 2, 64, 16, True, "bfloat16")


def test_flag_values_are_upper_bounds(tune_env):
    assert TFA.resolve_rows(1, 1, 256, 64, False, "bfloat16") == \
        (64, 128, 128)
    tconfig.set_flag("MXNET_FLASH_BWD_BLOCK_Q", 64)
    tconfig.set_flag("MXNET_FUSION_BLOCK_M", 64)
    try:
        assert TFA.resolve_rows(1, 1, 256, 64, False, "bfloat16") == \
            (64, 64, 128)
        assert tfused.resolve_blocks(8 * 56 * 56, 256, 64)[0] == 64
    finally:
        tconfig.set_flag("MXNET_FLASH_BWD_BLOCK_Q", None)
        tconfig.set_flag("MXNET_FUSION_BLOCK_M", None)
    assert tfused.resolve_blocks(8 * 56 * 56, 256, 64)[0] == 128


def test_fused_resolution_order_and_plain_versions(tune_env):
    """Explicit > the fusion.blocks entry > the launch's rule; the plain
    versions give the same result at every tile argument."""
    M, N, K = 8 * 56 * 56, 256, 64
    assert tfused.resolve_blocks(M, N, K) == (128, 128, 16)
    tat.record("fusion.blocks", tfused.fused_shape_key(M, N, K),
               {"block_m": 64, "block_n": 64, "block_k": 32},
               dtype="float32")
    assert tfused.resolve_blocks(M, N, K) == (64, 64, 32)
    assert tfused.resolve_blocks(M, N, K, block_m=128) == (128, 128, 16)
    jfused = importlib.import_module("mxnet_tpu.parallel.fused")
    assert tfused.fused_shape_key(M, N, K) == jfused.fused_shape_key(M, N, K)
    with pytest.raises(MXNetError, match="not one the kernel compiles"):
        tfused.resolve_blocks(M, N, K, block_m=64, block_n=128)
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(37, 20), dtype=torch.float32)
    w = torch.tensor(rng.randn(11, 20), dtype=torch.float32)
    b = torch.tensor(rng.randn(11), dtype=torch.float32)
    ep = (("bias",), ("act", "relu"))
    want = tfused.fused_matmul(x, w, [b], ep)
    for edge in tfused.TILES:
        got = tfused.fused_matmul(x, w, [b], ep, block_m=edge,
                                  block_n=edge)
        assert torch.equal(got, want)
    xb, wb = torch.randn(3, 9, 5), torch.randn(3, 5, 7)
    want = tfused.fused_batch_matmul(xb, wb)
    for edge in tfused.TILES:
        assert torch.equal(tfused.fused_batch_matmul(
            xb, wb, block_m=edge, block_n=edge, block_k=8), want)


def test_graph_tuning_key_stable_and_shape_free():
    from mxnet_tpu.executor import _GraphProgram as JProg
    from mxnet_tpu_torch.executor import _GraphProgram as TProg

    net, net2 = _fc_net(tmx), _fc_net(tmx)
    other = tmx.sym.SoftmaxOutput(
        tmx.sym.Activation(tmx.sym.FullyConnected(
            tmx.sym.Variable("data"), num_hidden=8, name="fc"),
            act_type="relu"), name="softmax")
    wider = _fc_net(tmx, hidden=1024)
    assert TProg(net).tuning_key() == TProg(net2).tuning_key()
    assert TProg(net).tuning_key() != TProg(other).tuning_key()
    assert TProg(net).tuning_key() != TProg(wider).tuning_key()
    # the JAX package's fingerprint: one key resolves in both
    assert TProg(net).tuning_key() == JProg(_fc_net(jmx)).tuning_key()


def test_executor_consults_tuned_remat(tune_env, monkeypatch):
    """An exec.remat entry flips mirroring in both packages: the port's
    training walk then runs under torch.utils.checkpoint, and its
    gradients equal the stored-activation walk's."""
    from mxnet_tpu.executor import _GraphProgram as JProg
    from mxnet_tpu_torch.executor import _GraphProgram as TProg

    jprog, tprog = JProg(_fc_net(jmx)), TProg(_fc_net(tmx))
    assert jprog.remat_mirror() is False and tprog.remat_mirror() is False
    jat.record("exec.remat", jprog.tuning_key(), {"mirror": 1})
    cache.reload()
    assert jprog.remat_mirror() is True and tprog.remat_mirror() is True

    import torch.utils.checkpoint as ckpt

    calls = []
    real = ckpt.checkpoint

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", spy)

    def grads():
        net = _fc_net(tmx)
        ex = net.simple_bind(tmx.cpu(), data=(4, 6), grad_req="write")
        rng = np.random.RandomState(0)
        ex.arg_dict["data"][:] = rng.rand(4, 6).astype(np.float32)
        ex.arg_dict["fc_weight"][:] = rng.rand(8, 6).astype(np.float32) * .1
        ex.forward(is_train=True)
        ex.backward()
        return ex.grad_dict["fc_weight"].asnumpy()

    mirrored = grads()
    assert calls, "the tuned remat walk did not mirror"
    tat.record("exec.remat", tprog.tuning_key(), {"mirror": 0})
    del calls[:]
    stored = grads()
    assert not calls
    assert np.isfinite(mirrored).all() and np.abs(mirrored).sum() > 0
    np.testing.assert_array_equal(mirrored, stored)


def _conv_net(mx, layout):
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                           layout=layout, name="conv")
    a = mx.sym.Activation(c, act_type="relu", name="relu")
    p = mx.sym.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       layout=layout, name="pool")
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(p, num_hidden=4, name="fc"), name="softmax")


def test_tuned_layout_rewrites_both_graphs_alike(tune_env):
    """A graph.layout entry under the graph's fingerprint makes both
    packages' layout pass rewrite the NCHW graph to NHWC, to the same
    graph JSON; without it neither rewrites."""
    with jmx.name.NameManager():
        js = _conv_net(jmx, "NCHW")
    with tmx.NameManager():
        ts = _conv_net(tmx, "NCHW")
    key = jgp.graph_fingerprint(js)
    assert tgp.graph_fingerprint(ts) == key
    shapes = {"data": (2, 3, 8, 8)}

    def run():
        jopt = jgp.optimize(js, arg_shapes=shapes,
                            config=jgp.PassConfig(spec="layout"))
        topt = tgp.optimize(ts, arg_shapes=shapes,
                            config=tgp.PassConfig(spec="layout"))
        return jopt, topt

    jopt, topt = run()
    assert jopt is None and topt is None
    jat.record("graph.layout", key, {"layout": "NHWC"})
    cache.reload()
    jopt, topt = run()
    assert topt is not None and jopt is not None
    assert topt.symbol.tojson() == jopt.symbol.tojson()
    assert any(r["pass"] == "layout" and r["rewrites"] > 0
               for r in topt.reports)


def test_serving_consults_tuned_ladder(tune_env):
    from mxnet_tpu_torch.autotune.tuners import model_key
    from mxnet_tpu_torch.serving import InferenceServer, ServingConfig

    net = _fc_net(tmx)
    rng = np.random.RandomState(0)
    w = rng.randn(8, 4).astype(np.float32)
    arg_params = {"fc_weight": torch.tensor(w), "fc_bias": torch.zeros(8)}
    mkey = model_key(net)
    assert mkey == jat.tuners.model_key(_fc_net(jmx))
    tat.record("serving.buckets", (mkey, "default"), {"buckets": [1, 4, 16]})
    tat.record("serving.buckets", (mkey, "batchy"), {"buckets": [8, 64]})
    kw = dict(data_shapes=[("data", (1, 4))], devices=[tmx.cpu()])
    srv = InferenceServer(net, arg_params, start=False, **kw)
    assert srv._cfg.buckets == (1, 4, 16)
    srv2 = InferenceServer(net, arg_params, start=False,
                           traffic_key="batchy", **kw)
    assert srv2._cfg.buckets == (8, 64)
    srv3 = InferenceServer(net, arg_params, start=False,
                           config=ServingConfig(buckets=(1, 2)), **kw)
    assert srv3._cfg.buckets == (1, 2)
    srv.start()
    try:
        x = rng.rand(3, 4).astype(np.float32)
        out = srv.predict(x, timeout=120)
        logits = x @ w.T
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        np.testing.assert_allclose(out, e / e.sum(axis=1, keepdims=True),
                                   atol=1e-5)
    finally:
        srv.stop()
        for s in (srv2, srv3):
            s.stop()


def test_ladder_candidates_and_signature():
    from mxnet_tpu.serving import buckets as jb
    from mxnet_tpu_torch.serving.buckets import (ladder_candidates,
                                                 traffic_signature)

    sizes = [1, 1, 2, 3, 8, 20]
    cands = ladder_candidates(sizes=sizes)
    assert all(max(c) == 32 for c in cands)
    assert (1, 2, 4, 8, 16, 32) in cands and (32,) in cands
    assert cands == jb.ladder_candidates(sizes=sizes)
    assert traffic_signature(sizes) == "p50x2-p95x8-maxx32" == \
        jb.traffic_signature(sizes)
    assert traffic_signature([]) == "empty"


def test_corrupt_cache_entries_degrade_to_defaults(tune_env):
    """A non-integer or non-dict entry reads as a miss at every consult
    (tuning is an optimization); only a well-formed entry naming a tile
    the kernels do not compile raises."""
    from mxnet_tpu_torch.autotune.tuners import model_key
    from mxnet_tpu_torch.serving import InferenceServer
    from mxnet_tpu_torch.serving.buckets import DEFAULT_BUCKETS

    net = _fc_net(tmx)
    params = {"fc_weight": torch.zeros(8, 4), "fc_bias": torch.zeros(8)}
    kw = dict(data_shapes=[("data", (1, 4))], devices=[tmx.cpu()],
              start=False)
    tat.record("serving.buckets", (model_key(net), "default"),
               {"buckets": []})
    assert InferenceServer(net, params, **kw)._cfg.buckets == \
        DEFAULT_BUCKETS
    tat.record("serving.buckets", (model_key(net), "default"), [1, 2, 4])
    assert InferenceServer(net, params, **kw)._cfg.buckets == \
        DEFAULT_BUCKETS
    key = tat.flash_shape_key(128, 16, False)
    tat.record("flash_attention.fwd", key,
               {"block_q": "garbage", "block_k": -5}, dtype="bfloat16")
    tat.record("flash_attention.bwd", key, "64", dtype="bfloat16")
    assert TFA.resolve_rows(1, 2, 128, 16, False, "bfloat16") == \
        (64, 128, 128)
    tat.record("fusion.blocks", tfused.fused_shape_key(64, 64, 64),
               [128, 128], dtype="float32")
    assert tfused.resolve_blocks(64, 64, 64)[0] == 64


def test_non_dict_entry_body_reads_as_miss(tune_env):
    tat.record("op.good", "k", {"v": 1})
    path = os.environ["MXNET_TUNE_CACHE"]
    with open(path) as f:
        payload = json.load(f)
    payload["entries"]["fp-A|op.bad|k|-"] = "oops"
    with open(path, "w") as f:
        json.dump(payload, f)
    cache.reset()
    assert tat.lookup("op.bad", "k") is None
    assert tat.lookup("op.good", "k") == {"v": 1}
    assert tat.scrub_stale() == 0
    cache.save()
    cache.reset()
    assert "fp-A|op.bad|k|-" not in cache.entries()


def test_scrub_preserves_other_process_entries(tune_env):
    tat.record("op.mine", "k", {"v": 1})
    path = os.environ["MXNET_TUNE_CACHE"]
    with open(path) as f:
        payload = json.load(f)
    payload["entries"]["fp-A|op.theirs|k|-"] = {
        "value": {"v": 2}, "fingerprint": "fp-A"}
    payload["entries"]["fp-B|op.old|k|-"] = {
        "value": {"v": 3}, "fingerprint": "fp-B"}
    with open(path, "w") as f:
        json.dump(payload, f)
    assert tat.scrub_stale() == 1
    cache.reset()
    assert tat.lookup("op.mine", "k") == {"v": 1}
    assert tat.lookup("op.theirs", "k") == {"v": 2}
    with open(path) as f:
        assert "fp-B|op.old|k|-" not in json.load(f)["entries"]


def test_auto_tune_bwd_miss_preserves_shipped_fwd_entry(tune_env,
                                                        monkeypatch):
    """auto_tune's documented contract: with only the bwd entry missing,
    only the backward space is searched; the shipped fwd winner is
    reused (the backward measures on its rows), not re-measured or
    overwritten. The JAX package's own case fails on this install
    (ROADMAP's reference-side caveats); this one holds the port to the
    contract, with the flash kernels' measurer on the CPU."""
    from mxnet_tpu_torch.autotune import tuners

    key = tat.flash_shape_key(64, 8, True)
    shipped = {"block_q": 64, "block_k": 64, "marker": "shipped"}
    tat.record("flash_attention.fwd", key, shipped, dtype="float32")
    seen = []
    real = tuners.tune_flash_attention

    def spy(**kw):
        seen.append(kw)
        return real(**kw)

    monkeypatch.setattr(tuners, "tune_flash_attention", spy)
    tconfig.set_flag("MXNET_TUNE", 1)
    try:
        rows = TFA.resolve_rows(1, 1, 64, 8, True, "float32",
                                device="cpu")
    finally:
        tconfig.set_flag("MXNET_TUNE", None)
    assert rows == (64, 64, 64)
    assert len(seen) == 1 and seen[0]["forward"] is False
    assert seen[0]["fwd_blocks"] == (64, 64)
    assert seen[0]["device"] == "cpu"
    assert tat.lookup("flash_attention.fwd", key, dtype="float32") == shipped
    assert tat.lookup("flash_attention.bwd", key,
                      dtype="float32") == {"block_q": 64, "block_k": 64}
    assert cache.stats()["searches"] == 1  # bwd only, no fwd re-sweep


def test_all_tunables_registered_at_package_import(tune_env):
    """Every declared knob is visible in a fresh process without touching
    the lazily loaded tuners module, and the port's names are a superset
    of the JAX package's."""
    child = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r)\n"
         "import mxnet_tpu_torch\n"
         "from mxnet_tpu_torch.autotune import registry, tunable_names\n"
         "names = tunable_names()\n"
         "for n in ('exec.remat', 'flash_attention.fwd',\n"
         "          'flash_attention.bwd', 'serving.buckets',\n"
         "          'graph.layout', 'fusion.blocks'):\n"
         "    assert n in names, (n, names)\n"
         "    registry.get(n)\n"
         "assert 'mxnet_tpu_torch.autotune.tuners' not in sys.modules\n"
         "print(' '.join(names))\n" % _REPO],
        env=dict(os.environ), capture_output=True, text=True, timeout=300)
    assert child.returncode == 0, child.stdout + child.stderr
    import mxnet_tpu.executor  # noqa: F401
    import mxnet_tpu.parallel.flash_attention  # noqa: F401
    import mxnet_tpu.serving.buckets  # noqa: F401

    assert set(child.stdout.split()) >= set(jat.tunable_names())


def test_tune_layout_generic(tune_env):
    from mxnet_tpu_torch.autotune.tuners import tune_layout

    times = {"NHWC": 2e-3, "NCHW": 1e-3}
    assert tune_layout(lambda c: times[c["layout"]], key=("toy", "b4"),
                       default="NHWC") == "NCHW"
    assert tat.lookup("graph.layout", ("toy", "b4")) == {"layout": "NCHW"}


def test_tune_remat_generic(tune_env):
    from mxnet_tpu_torch.autotune.tuners import tune_remat

    assert tune_remat(lambda c: 1e-3 if c["mirror"] else 2e-3,
                      "g-key") == 1
    assert tat.lookup("exec.remat", "g-key") == {"mirror": 1}


def test_median_time_discards_warmup_and_takes_the_median(monkeypatch):
    clock = iter([0.0, 5.0, 10.0, 11.0, 20.0, 23.0])
    monkeypatch.setattr(tsearch.time, "perf_counter", lambda: next(clock))
    calls = []
    assert tsearch.median_time(lambda: calls.append(1), repeats=3,
                               warmup=1) == 3.0
    assert len(calls) == 4


def test_hill_climb_never_measures_an_infeasible_neighbor(tune_env):
    """The fusion.blocks space is a product in which only the compiled
    (edge, depth) pairs are feasible; the hill climb's one-notch mutations
    of the best (e.g. block_m 128 with block_n 64) cost inf and are never
    measured, since the kernel raises on them."""
    t = tat.get_tunable("fusion.blocks")
    ctx = {"M": 8 * 56 * 56, "N": 256, "K": 64, "dtype_bytes": 4}
    seen = []

    def measure(c):
        assert np.isfinite(t.cost(c, ctx)), c
        seen.append(dict(c))
        return 1e-3 if c["block_m"] == 128 else 2e-3

    res = tsearch.search(t, measure, ctx=ctx, cfg=SearchConfig(trials=12))
    assert res.best == {"block_m": 128, "block_n": 128, "block_k": 16}
    assert len(seen) == 2 and res.pruned == 6


def test_module_bind_resolves_remat_under_the_tuners_key(tune_env):
    """tune_remat records under model_key(symbol); a Module bind's program
    (the pass-rewritten graph, keyed by the original's fingerprint)
    resolves that entry."""
    from mxnet_tpu_torch.autotune.tuners import model_key

    net = _fc_net(tmx)
    tat.record("exec.remat", model_key(net), {"mirror": 1})
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4, 6))],
             label_shapes=[("softmax_label", (4,))])
    prog = mod._exec_group.execs[0]._prog
    assert prog.tuning_key() == model_key(net)
    assert prog.remat_mirror() is True


def test_carried_resolution_lasts_until_the_cache_changes(tune_env):
    """What a wrapper resolves at a shape's first launch is carried, with
    no cache lookup, until a record, reload, reset or tuning flag."""
    calls = []
    carry = cache.Carry()

    def resolve():
        calls.append(1)
        return tat.lookup("fusion.blocks", "k")

    assert carry.get(("t", 1), resolve) is None
    cache.reset_stats()
    for _ in range(5):
        assert carry.get(("t", 1), resolve) is None
    assert len(calls) == 1
    assert cache.stats()["hits"] + cache.stats()["misses"] == 0
    tat.record("fusion.blocks", "k", {"block_m": 64})
    assert carry.get(("t", 1), resolve) == {"block_m": 64}
    tconfig.set_flag("MXNET_TUNE", -1)
    try:
        assert carry.get(("t", 1), resolve) is None
    finally:
        tconfig.set_flag("MXNET_TUNE", None)
    assert carry.get(("t", 1), resolve) == {"block_m": 64}
    assert len(calls) == 4
    # the kernel wrappers' and the executor's carries are such carries
    assert isinstance(tfused._TILE_CARRY, cache.Carry)
    assert isinstance(TFA._ROWS_CARRY, cache.Carry)
