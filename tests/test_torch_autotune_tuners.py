"""The port's tuners and learned cost model against the JAX package's, from
the same inputs: each tuner with the same deterministic stub measurer
records the same cache entries (bucket ladders, layout, remat, the input
pipeline, the generation and control-plane knobs), and the learned
model's features, ridge weights, Spearman and holdout gate agree to
1e-12 on the same sample rows, as do the ledger and cache ingestion
paths. CPU only, seconds.
"""
import json
import types

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autotune as jat
from mxnet_tpu.autotune import learned as jlearned
from mxnet_tpu_torch import autotune as tat
from mxnet_tpu_torch.autotune import learned as tlearned


@pytest.fixture
def tune_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.setenv("MXNET_TUNE_FINGERPRINT", "fp-A")
    for c in (tat.cache, jat.cache):
        c.reset()
        c.reset_stats()
    for lm in (tlearned, jlearned):
        lm.reset()
    yield tmp_path
    for c in (tat.cache, jat.cache):
        c.reset()
        c.reset_stats()


def _entries(pkg):
    """The package's cache entries without their timestamps."""
    out = {}
    for k, e in pkg.cache.entries().items():
        e = dict(e)
        e.pop("time", None)
        out[k] = e
    return out


def _both(tune_env, monkeypatch, run):
    """``run(autotune package)`` once per package, each into its own cache
    file; returns the two entry maps (JAX first)."""
    got = []
    for name, pkg in (("jax", jat), ("torch", tat)):
        monkeypatch.setenv("MXNET_TUNE_CACHE",
                           str(tune_env / ("%s.json" % name)))
        pkg.cache.reset()
        run(pkg)
        got.append(_entries(pkg))
    return got


def _fc_net(mx):
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                              name="fc"), name="softmax")


def test_tune_serving_buckets_records_the_same_entries(tune_env,
                                                       monkeypatch):
    sizes = [1, 1, 2, 3, 8, 5, 13, 2, 2, 1]

    def measure(c):
        ladder = c["buckets"]
        return 1e-3 * len(ladder) + (0.1 if max(ladder) != 16 else 0.0) + \
            1e-5 * sum(ladder)

    def run(pkg):
        mx = jmx if pkg is jat else tmx
        net = _fc_net(mx)
        ladder = pkg.tuners.tune_serving_buckets(
            net, {}, [("data", (1, 4))], sizes, measure=measure, trials=6)
        assert max(ladder) == 16

    theirs, ours = _both(tune_env, monkeypatch, run)
    assert ours == theirs and len(ours) == 2


def test_tune_layout_and_remat_record_the_same_entries(tune_env,
                                                       monkeypatch):
    times = {"NHWC": 2e-3, "NCHW": 1e-3}

    def run(pkg):
        assert pkg.tuners.tune_layout(lambda c: times[c["layout"]],
                                      key=("resnet50", "b16")) == "NCHW"
        assert pkg.tuners.tune_remat(
            lambda c: 1e-3 if c["mirror"] else 3e-3, "g-key") == 1

    theirs, ours = _both(tune_env, monkeypatch, run)
    assert ours == theirs and len(ours) == 2


def test_tune_input_pipeline_records_the_same_entries(tune_env,
                                                      monkeypatch):
    def measure(c):
        w = c["workers"]
        d = c.get("depth", 2)
        return 1.0 / (1 + w) + 0.01 * w + abs(d - 4) * 1e-3

    def run(pkg):
        out = pkg.tuners.tune_input_pipeline(
            None, ("cpu8", "b32", "3x224x224"), measure=measure)
        assert set(out) == {"io.decode_workers", "io.prefetch_depth"}

    theirs, ours = _both(tune_env, monkeypatch, run)
    assert ours == theirs and len(ours) == 2


def _lm_stub():
    return types.SimpleNamespace(
        cfg={"n_layers": 2, "d_model": 64, "n_heads": 4, "d_ff": 128,
             "n_experts": 0, "vocab": 97}, dtype="float32")


def test_generation_tuners_record_the_same_entries(tune_env, monkeypatch):
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]

    def gen_measure(c):
        return (abs(c.get("page_size", 16) - 32) * 1e-4
                + abs(c.get("decode_blocks", 64) - 64) * 1e-6
                + abs(c.get("spec_k", 0) - 2) * 1e-3 + 1e-3)

    def ctl_measure(c):
        return (abs(c.get("prefix_pages", 8) - 16) * 1e-4
                + abs(c.get("aging_ms", 500) - 250) * 1e-6 + 1e-3)

    def run(pkg):
        model = _lm_stub()
        t = pkg.tuners
        out = t.tune_generation(model, None, prompts=prompts,
                                measure=gen_measure)
        assert out["generation.page_size"] == {"page_size": 32}
        spec = t.tune_generation_spec(model, None, prompts=prompts,
                                      measure=gen_measure)
        assert spec["generation.spec_k"] == {"spec_k": 2}
        t.tune_control(model, None, prompts=prompts, measure=ctl_measure)

    theirs, ours = _both(tune_env, monkeypatch, run)
    assert ours == theirs and len(ours) == 5


def test_generation_entries_resolve_in_a_fresh_generator_config(
        tune_env, monkeypatch):
    """The keys the generation tuners write are the ones the port's
    Generator consults (generation_tune_key is the JAX package's)."""
    from mxnet_tpu.serving.generation.engine import \
        generation_tune_key as jkey
    from mxnet_tpu_torch.serving.generation.engine import \
        generation_tune_key as tkey

    model = _lm_stub()
    assert tkey(model, 4, 128) == jkey(model, 4, 128)


# ------------------------------------------------------- learned model
def _samples(n_groups=10, per_group=6, seed=0):
    rng = np.random.RandomState(seed)
    rows = []
    for g in range(n_groups):
        M, N, K = (int(2 ** rng.randint(6, 13)) for _ in range(3))
        for i in range(per_group):
            edge = (64, 128)[i % 2]
            analytic = 2.0 * M * N * K / 5e13 * (1 + 0.1 * i)
            rows.append({
                "op": "fusion.blocks" if g % 3 else "flash_attention.fwd",
                "candidate": {"block_m": edge, "block_n": edge,
                              "block_k": (32, 16)[i % 2] + i},
                "ctx": {"M": M, "N": N, "K": K, "dtype_bytes": 4,
                        "layout": "NHWC" if g % 2 else "NCHW"},
                "s": analytic * (1.5 + 0.3 * np.sin(i + g)) +
                     1e-6 * rng.rand(),
                "analytic_s": analytic if i % 5 else None})
    return rows


def test_featurize_fit_and_spearman_agree():
    rows = _samples()
    for r in rows[:12]:
        a = jlearned.featurize(r["op"], r["candidate"], r["ctx"],
                               r["analytic_s"])
        b = tlearned.featurize(r["op"], r["candidate"], r["ctx"],
                               r["analytic_s"])
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    wj = jlearned.CostModel.fit(rows).w
    wt = tlearned.CostModel.fit(rows).w
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-12)
    rng = np.random.RandomState(1)
    for _ in range(5):
        a, b = rng.rand(9), rng.rand(9)
        a[3] = a[4]  # ties share their mean rank
        assert abs(tlearned.spearman(a, b) - jlearned.spearman(a, b)) \
            <= 1e-12
    assert tlearned.spearman([1, 1], [1, 2]) == 0.0


def test_train_gate_agrees(tune_env):
    rows = _samples(n_groups=24)
    mj = jlearned.train(samples=rows, min_samples=2, persist=False)
    mt = tlearned.train(samples=rows, min_samples=2, persist=False)
    np.testing.assert_allclose(mt.w, mj.w, rtol=0, atol=1e-12)
    for k in ("n_samples", "n_fit", "n_groups", "n_holdout_groups",
              "in_sample", "gate_ok", "fingerprint"):
        assert mt.meta[k] == mj.meta[k], k
    for k in ("spearman_learned", "spearman_analytic"):
        assert abs(mt.meta[k] - mj.meta[k]) <= 1e-12, k
    assert mt.meta["n_holdout_groups"] >= 1


def test_a_model_file_loads_across_packages_and_ranks_alike(tune_env):
    """The persisted model is one format: written by the JAX package it
    loads in the port, and both rank the same candidates in the same
    order once its gate passed."""
    rows = _samples(n_groups=24)
    model = jlearned.train(samples=rows, min_samples=2)
    model.meta["gate_ok"] = True  # rank with it whatever the holdout said
    model.save()
    cands = [{"block_m": e, "block_n": e, "block_k": k}
             for e in (64, 128) for k in (8, 16, 32)]
    ctx = {"M": 1024, "N": 256, "K": 64, "dtype_bytes": 4}
    order_j = jlearned.rank_candidates("fusion.blocks", cands, ctx)
    tlearned.reset()
    loaded = tlearned.load()
    np.testing.assert_array_equal(loaded.w, model.w)
    order_t = tlearned.rank_candidates("fusion.blocks", cands, ctx)
    assert order_t == order_j and order_t is not None


def _ledger(path):
    rows = [
        {"ts": "2026-01-01T00:00:00", "fingerprint": {"device": "fp-A"},
         "programs": [
             {"graph": "resnet/200n", "mode": "train", "flops": 1e12,
              "hbm_bytes": 2e9, "roofline_ms": 20.0, "device_ms_ema": 67.0},
             {"graph": "mlp/5n", "mode": "infer", "flops": 1e8,
              "hbm_bytes": 1e6, "roofline_ms": 0.01,
              "device_ms_last": 0.05},
             {"graph": "empty/1n", "mode": "infer", "roofline_ms": 0}]},
        {"ts": "2026-01-02T00:00:00",
         "fingerprint": {"device": "TPU v5 lite"},
         "programs": [{"graph": "resnet/200n", "mode": "train",
                       "flops": 1e12, "hbm_bytes": 2e9,
                       "roofline_ms": 8.0, "device_ms_ema": 30.0}]}]
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return path


def test_ingest_ledger_and_cache_agree(tune_env, monkeypatch):
    """The ledger's program rows and the cache's measured winners become
    the same sample rows in both packages; the TPU row keeps its device
    string, so training on this fingerprint leaves it out; a second
    ingestion adds nothing."""
    ledger = _ledger(str(tune_env / "ledger.jsonl"))
    got = []
    for name, lm, pkg in (("jax", jlearned, jat), ("torch", tlearned, tat)):
        monkeypatch.setenv("MXNET_TUNE_CACHE",
                           str(tune_env / ("%s.json" % name)))
        pkg.cache.reset()
        pkg.record("fusion.blocks", ("M1024", "N256", "K64"),
                   {"block_m": 64, "block_n": 64, "block_k": 32},
                   dtype="float32", ms=0.5, trials=2)
        pkg.cache.entries()  # load
        n_ledger = lm.ingest_ledger(ledger)
        n_cache = lm.ingest_tune_cache()
        assert (lm.ingest_ledger(ledger), lm.ingest_tune_cache()) == (0, 0)
        rows = lm.read_samples()
        for r in rows:
            r.pop("ts", None)
        got.append((n_ledger, n_cache, rows))
    assert got[0] == got[1]
    n_ledger, n_cache, rows = got[1]
    assert (n_ledger, n_cache) == (3, 1)
    assert sorted(r["fingerprint"] for r in rows) == \
        ["TPU v5 lite", "fp-A", "fp-A", "fp-A"]
