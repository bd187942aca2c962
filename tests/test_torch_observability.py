"""The port's serving telemetry, fault injection, staging window, bucket
ladder and tuning cache against the JAX package's, on the CPU.

* ``faults``: the same specs and seeds fire the same sequences.
* ``metrics``: the same hand-fed series render to the same Prometheus
  text; after one deterministic traffic through both servers the
  ``serving.*`` series names and counter values are equal.
* ``stats_schema``: the same core keys, and the same ``capacity`` and
  ``resilience`` sections from both servers.
* ``request_trace``: one sampled request yields the same events and
  annotations through both servers.
* ``autotune``: one cache file, one ``serving.buckets`` entry: both
  servers resolve the same ladder, and a corrupt entry falls back alike.
* ``buckets`` and ``PipelineWindow`` behave as the JAX package's.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autotune as jtune
from mxnet_tpu.autotune import cost_model as jcost
from mxnet_tpu.observability import metrics as jmetrics
from mxnet_tpu.observability import request_trace as jtrace
from mxnet_tpu.observability import stats_schema as jschema
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.runtime.staging import PipelineWindow as JWindow
from mxnet_tpu.serving import buckets as jbuckets
from mxnet_tpu_torch import autotune as ttune
from mxnet_tpu_torch.autotune import cost_model as tcost
from mxnet_tpu_torch.observability import flight_recorder as tflight
from mxnet_tpu_torch.observability import metrics as tmetrics
from mxnet_tpu_torch.observability import request_trace as ttrace
from mxnet_tpu_torch.observability import stats_schema as tschema
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.runtime.staging import PipelineWindow as TWindow
from mxnet_tpu_torch.runtime.staging import stage_pytree
from mxnet_tpu_torch.serving import buckets as tbuckets

PKGS = {"jax": (jmx, jmetrics, jtrace, jfaults),
        "torch": (tmx, tmetrics, ttrace, tfaults)}


def _mlp(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=5, name="fc")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc_weight": rng.randn(5, 7).astype(np.float32),
            "fc_bias": rng.randn(5).astype(np.float32)}


def _server(name, config=True, n_replicas=2, start=True, **cfg):
    pkg = PKGS[name][0]
    if name == "jax":
        import jax

        devices = jax.devices()[:n_replicas]
    else:
        devices = [tmx.cpu()] * n_replicas
    cfg.setdefault("buckets", (1, 2, 4))
    cfg.setdefault("max_wait_ms", 0)
    return pkg.serving.InferenceServer(
        _mlp(pkg), _params(), data_shapes=[("data", (1, 7))],
        devices=devices, start=start,
        config=pkg.serving.ServingConfig(**cfg) if config else None)


@pytest.fixture
def telemetry():
    """Both registries on, emptied, and restored afterwards."""
    saved = []
    for m in (jmetrics, tmetrics):
        with m._lock:
            saved.append(dict(m._registry))
            m._registry.clear()
        m.set_enabled(True)
    yield
    for m, reg in zip((jmetrics, tmetrics), saved):
        m.set_enabled(False)
        with m._lock:
            m._registry.clear()
            m._registry.update(reg)


@pytest.fixture
def clean_faults():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


# ------------------------------------------------------------------ faults
def _fire(faults, point, tag=None):
    try:
        faults.inject(point, tag=tag)
        return "ok"
    except faults.InjectedDrop:
        return "drop"
    except faults.InjectedFault:
        return "raise"


_SCRIPTS = [
    ("kvstore.push:raise@call=2", 42, [("kvstore.push", None)] * 4),
    ("kvstore.push[a]:drop@calls=1-2", 0,
     [("kvstore.push", "b"), ("kvstore.push", "a"), ("kvstore.push", "a"),
      ("kvstore.push", "a"), ("kvstore.push", None)]),
    ("kvstore.pull:raise@p=0.5", 42, [("kvstore.pull", None)] * 64),
    ("kvstore.pull:drop@p=0.3,every=2;kvstore.pull:raise@every=5", 7,
     [("kvstore.pull", None)] * 40),
    ("serving.replica_execute[1]:raise@calls=1-2", 0,
     [("serving.replica_execute", i % 3) for i in range(12)]),
    ("x.y:delay=0@every=3;x.y:raise@call=4", 3, [("x.y", None)] * 8),
]


@pytest.mark.parametrize("spec,seed,calls", _SCRIPTS,
                         ids=[s[0] for s in _SCRIPTS])
def test_fault_sequences_match(clean_faults, spec, seed, calls):
    runs = []
    for faults in (jfaults, tfaults):
        faults.configure(spec, seed=seed, strict=False)
        runs.append(([_fire(faults, p, t) for p, t in calls],
                     faults.fired()))
    assert runs[0] == runs[1]
    assert any(r != "ok" for r in runs[1][0])


def test_fault_grammar_errors_match(clean_faults):
    assert "serving.replica_execute" in tfaults.points()
    for spec, err in (("no.such.point:raise", KeyError),
                      ("serving.replica_execute:explode", ValueError),
                      ("serving.replica_execute:drop@p=1.5", ValueError),
                      ("serving.replica_execute:drop@every=0", ValueError),
                      ("serving.replica_execute:raise@when=1", ValueError),
                      ("serving.replica_execute", ValueError)):
        for faults in (jfaults, tfaults):
            with pytest.raises(err):
                faults.configure(spec)
    tfaults.configure("serving.replica_execute[sub]:delay=5@calls=2-3,"
                      "every=1")
    assert tfaults.enabled()
    tfaults.configure(None)
    assert not tfaults.enabled()


def test_fault_env_spec_loaded_lazily(clean_faults, monkeypatch):
    monkeypatch.setenv("MXNET_FAULTS", "kvstore.push:raise@p=0.5")
    monkeypatch.setenv("MXNET_FAULTS_SEED", "3")
    seqs = []
    for faults in (jfaults, tfaults):
        faults.reset()
        seqs.append([_fire(faults, "kvstore.push") for _ in range(32)])
    assert seqs[0] == seqs[1] and "raise" in seqs[1]


# ----------------------------------------------------------------- metrics
def _feed(m):
    m.counter("serving.requests", help="requests admitted").inc(3)
    m.counter("serving.requests", labels={"engine": 'a"b\\c'}).inc()
    m.counter("dispatch.eager").inc(2)
    m.gauge("serving.queue_depth").set(7)
    m.gauge("hbm.peak", labels={"device": "0"}).set_max(5.5)
    m.gauge("hbm.peak", labels={"device": "0"}).set_max(2)
    h = m.histogram("serving.latency_ms", help="latency\nof requests")
    for v in (0.003, 0.5, 1.0, 7.25, 1e5, 2e7, float("nan")):
        h.observe(v)
    m.histogram("step.ms", buckets=(1, 10, 100),
                labels={"phase": "fwd"}).observe(12.5)
    return h


def test_dump_metrics_text_matches(telemetry):
    jh, th = _feed(jmetrics), _feed(tmetrics)
    assert tmetrics.dump_metrics() == jmetrics.dump_metrics(extras=False)
    assert tmetrics.snapshot_values() == jmetrics.snapshot_values()
    for q in (0.0, 0.5, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    assert (th.mean, th.min, th.max, th.nonfinite) == \
        (jh.mean, jh.min, jh.max, jh.nonfinite)
    assert tmetrics.get_value("serving.queue_depth") == 7
    for m in (jmetrics, tmetrics):
        assert m.unregister("hbm.peak") == 1
        with pytest.raises(TypeError):
            m.gauge("dispatch.eager")
        with pytest.raises(ValueError):
            m.counter("bad", labels={"a.b": 1})
    assert tmetrics.dump_metrics() == jmetrics.dump_metrics(extras=False)
    assert tmetrics.percentile([1, 2, 3, 4], 50) == \
        jmetrics.percentile([1, 2, 3, 4], 50)


def test_disabled_metrics_are_noops():
    assert not tmetrics.enabled()
    c = tmetrics.counter("serving.requests")
    c.inc()
    assert c is tmetrics.NOOP and tmetrics.get_value("nope") is None


def test_serving_metrics_after_one_traffic_match(telemetry):
    xs = [np.random.RandomState(i).rand(1 + i % 4, 7).astype(np.float32)
          for i in range(10)]
    series = {}
    for name in PKGS:
        m = PKGS[name][1]
        srv = _server(name)
        try:
            for x in xs:
                srv.predict(x, timeout=60)
        finally:
            srv.stop()
        names = {i.name for i in m.all_instruments().values()
                 if i.name.startswith("serving.")}
        values = {k: m.get_value("serving." + k) for k in
                  ("requests", "batches", "rows_real", "rows_padded",
                   "bucket_compiles")}
        series[name] = (names, values,
                        m.get_value("serving.latency_ms"),
                        m.get_value("serving.occupancy_pct"))
    assert series["torch"] == series["jax"]
    # rows 1, 2, 3, 4, ... round-robin: replica 0 runs buckets 1 and 4,
    # replica 1 buckets 2 and 4
    assert series["torch"][1] == {"requests": 10, "batches": 10,
                                  "rows_real": 23, "rows_padded": 2,
                                  "bucket_compiles": 4}
    # the owned gauges went with stop()
    assert "serving.queue_depth" not in series["torch"][0]


def test_every_serving_series_reaches_the_dump(telemetry, monkeypatch):
    """The JAX names, each in the exposition once its event happened: a
    fault at dispatch (quarantine, retry, probe, readmission), then one at
    the fetch (the fetch-side retry), a resize and an expired request."""
    import time

    from mxnet_tpu_torch.serving import engine

    real_fetch = engine._fetch
    fail_next = []

    def fetch(outs, ready):
        if fail_next:
            fail_next.pop()
            raise RuntimeError("device fault at fetch")
        return real_fetch(outs, ready)

    monkeypatch.setattr(engine, "_fetch", fetch)
    tfaults.configure("serving.replica_execute[1]:raise@call=1", seed=0)
    srv = _server("torch", cooldown_ms=50, deadline_ms=30)
    try:
        x = np.ones((1, 7), np.float32)
        for _ in range(3):
            srv.predict(x, timeout=60)
        time.sleep(0.08)
        srv.predict(x, timeout=60)
        fail_next.append(1)
        np.testing.assert_allclose(srv.predict(x, timeout=60),
                                   srv.predict(x, timeout=60))
        srv.resize_replicas(1)
        srv.stop()
        srv = _server("torch", start=False, deadline_ms=30)
        stale = srv.submit(x)
        time.sleep(0.06)
        srv.start()
        with pytest.raises(tmx.serving.DeadlineExceeded):
            stale.result(timeout=30)
        text = tmetrics.dump_metrics()
    finally:
        srv.stop()
        tfaults.reset()
    for n in ("requests", "batches", "rows_real", "rows_padded",
              "occupancy_pct", "latency_ms", "queue_depth",
              "replicas_configured", "replicas_available", "resizes",
              "replica_quarantined", "replica_readmitted",
              "batch_retries", "bucket_compiles", "deadline_expired"):
        assert "# TYPE mxnet_serving_%s " % n in text, n


# ------------------------------------------------------------ stats schema
def test_stats_schema_sections_match():
    from mxnet_tpu.observability import perf as jperf
    from mxnet_tpu_torch.observability import perf as tperf

    assert tschema.SCHEMA_VERSION == jschema.SCHEMA_VERSION
    assert tschema.CORE_KEYS == jschema.CORE_KEYS
    # the perf sections are live: fits run earlier in this process have
    # filled both packages' program tables and waterfall rings
    tperf.reset()
    jperf.reset()
    stats = {}
    for name in PKGS:
        srv = _server(name, cooldown_ms=500)
        try:
            for i in range(4):
                srv.predict(np.ones((1 + i, 7), np.float32), timeout=60)
            stats[name] = srv.get_stats()
        finally:
            srv.stop()
    jschema.validate(stats["jax"])
    tschema.validate(stats["torch"])
    for key in ("capacity", "resilience", "config", "requests",
                "completed", "rejected", "queue_depth", "engine",
                "running", "stopped", "buckets", "replicas"):
        assert stats["torch"][key] == stats["jax"][key], key
    assert set(stats["torch"]) == set(stats["jax"])
    assert tschema.summarize(stats["torch"]) == \
        jschema.summarize(stats["jax"])
    # the live attribution layer (MXNET_PERF on by default), no measured
    # program yet: the JAX package's section
    assert stats["torch"]["perf"] == stats["jax"]["perf"] == {
        "enabled": True, "mfu_pct": None, "hbm_util_pct": None,
        "programs": 0, "waterfall": None}
    with pytest.raises(ValueError):
        tschema.validate({k: v for k, v in stats["torch"].items()
                          if k != "perf"})


# ------------------------------------------------------------ request trace
def test_request_trace_events_match():
    traces = {}
    for name in PKGS:
        rt = PKGS[name][2]
        rt.reset()
        srv = _server(name)
        try:
            srv.predict(np.ones((3, 7), np.float32), timeout=60)
        finally:
            srv.stop()
        (trace,) = rt.reservoir().recent()
        d = trace.to_dict()
        traces[name] = ([e[0] for e in trace.events], dict(trace.meta),
                        trace.status, sorted(d), sorted(d["phases_ms"]),
                        rt.tracez()["offered"])
        assert abs(sum(d["phases_ms"].values()) - d["total_ms"]) < 1e-3
    assert traces["torch"] == traces["jax"]
    assert traces["torch"][0] == ["submit", "queue", "batch", "compute",
                                  "fetch"]
    assert traces["torch"][1] == {"rows": 3, "parts": 1, "bucket": 4,
                                  "replica": 0}


def test_trace_sampling_and_reservoir():
    tmx.config.set_flag("MXNET_OBS_TRACE_SAMPLE", 0)
    try:
        assert ttrace.begin("serving") is ttrace.NOOP_TRACE
    finally:
        tmx.config.set_flag("MXNET_OBS_TRACE_SAMPLE", None)
    picks = [ttrace.begin("k", sample=3) is not ttrace.NOOP_TRACE
             for _ in range(9)]
    assert sum(picks) == 3
    res = ttrace.TraceReservoir(capacity=2)
    for ms in (1, 5, 3):
        t = ttrace.RequestTrace("k")
        t.events.append(("done", t.events[0][1] + ms / 1e3, 0))
        res.offer(t)
    assert [round(t.total_us / 1e3) for t in res.slowest()] == [5, 3]
    assert [round(t.total_us / 1e3) for t in res.recent()] == [3, 5]
    t = ttrace.RequestTrace("k")
    with ttrace.activate(t):
        assert ttrace.current() is t
    assert ttrace.current() is None


def test_flight_recorder_dump(tmp_path):
    srv = _server("torch")
    try:
        srv.predict(np.ones((1, 7), np.float32), timeout=60)
        tflight.record({"loss": 1.0}, anomaly=True)
        path = tflight.dump("test", path=str(tmp_path / "d.json"))
    finally:
        srv.stop()
    with open(path) as f:
        payload = json.load(f)
    assert payload["reason"] == "test"
    assert payload["records"][-1]["anomaly"] is True
    assert payload["fingerprint"]["torch"]["version"] == torch.__version__
    section = payload["providers"]["serving"]
    views = section.get("servers", [section])
    assert any(v.get("engine") == "serving" for v in views)
    assert payload["spans_tail"] == []


# ------------------------------------------------------------ tuning cache
def test_tuning_cache_ladder_resolves_alike(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.setenv("MXNET_TUNE_FINGERPRINT", "test")
    monkeypatch.delenv("MXNET_SERVING_BUCKETS", raising=False)
    jtune.reset()
    ttune.reset()
    fp = jmx.graph_pass.graph_fingerprint(_mlp(jmx))
    assert tmx.graph_pass.graph_fingerprint(_mlp(tmx)) == fp
    try:
        # one entry, written by the JAX package, read by both
        jtune.record("serving.buckets", key=(fp, "default"),
                     value={"buckets": [2, 8]})
        ttune.reset()
        ladders = [_server(n, config=False) for n in PKGS]
        for srv in ladders:
            srv.stop()
        assert [s._cfg.buckets for s in ladders] == [(2, 8), (2, 8)]
        # another traffic key misses
        srv = tmx.serving.InferenceServer(
            _mlp(tmx), _params(), data_shapes=[("data", (1, 7))],
            devices=[tmx.cpu()], traffic_key="bursty", start=False)
        assert srv._cfg.buckets == tbuckets.DEFAULT_BUCKETS
        srv.stop()
        # a corrupt entry, written by the port, falls back alike
        ttune.record("serving.buckets", key=(fp, "default"),
                     value={"buckets": "1,x"})
        jtune.reset()
        with open(tmp_path / "tuning.json") as f:
            assert len(json.load(f)["entries"]) == 1
        ladders = [_server(n, config=False) for n in PKGS]
        for srv in ladders:
            srv.stop()
        assert [s._cfg.buckets for s in ladders] == \
            [jbuckets.DEFAULT_BUCKETS, tbuckets.DEFAULT_BUCKETS]
        assert ttune.entries() == jtune.cache.entries()
        assert ttune.stats()["hits"] >= 2
    finally:
        jtune.reset()
        ttune.reset()


def test_device_fingerprint_names_the_device(monkeypatch):
    monkeypatch.delenv("MXNET_TUNE_FINGERPRINT", raising=False)
    ttune.reset()
    try:
        assert ttune.device_fingerprint() == "cpu:cpu"
        monkeypatch.setenv("MXNET_TUNE_FINGERPRINT", "fleet-a")
        assert ttune.device_fingerprint() == "fleet-a"
        monkeypatch.setenv("MXNET_TUNE", "-1")
        assert ttune.lookup("serving.buckets", key="k") is None
    finally:
        ttune.reset()


def test_graph_fingerprint_matches_on_resnet50():
    fps = [pkg.graph_pass.graph_fingerprint(
        pkg.models.get_resnet(num_layers=50, layout=layout))
        for layout in ("NHWC", "NCHW") for pkg in (jmx, tmx)]
    assert fps[0] == fps[1] and fps[2] == fps[3] and fps[0] != fps[2]


# ----------------------------------------------------------------- buckets
@pytest.mark.parametrize("max_size,sizes", [
    (None, None), (5, None), (None, [1, 1, 2, 9, 3]), (64, [1] * 50 + [33]),
    (1, [1]), (None, [300, 2, 7, 7, 7])])
def test_ladder_candidates_and_padding_match(max_size, sizes):
    assert tbuckets.ladder_candidates(max_size, sizes) == \
        jbuckets.ladder_candidates(max_size, sizes)
    if sizes:
        assert tbuckets.traffic_signature(sizes) == \
            jbuckets.traffic_signature(sizes)
        for ladder in tbuckets.ladder_candidates(max_size, sizes):
            assert tcost.expected_padding(ladder, sizes) == \
                jcost.expected_padding(ladder, sizes)
            ctx = {"sizes": sizes}
            assert tcost.ladder_cost({"buckets": ladder}, ctx) == \
                jcost.ladder_cost({"buckets": ladder}, ctx)
    ctx = {"max_size": max_size, "sizes": sizes}
    tt, jt = (m.get_tunable("serving.buckets") for m in (ttune, jtune))
    assert tt.candidates(ctx) == jt.candidates(ctx)
    assert tt.default_value(ctx) == jt.default_value(ctx)


def test_bucket_helpers_match():
    assert tbuckets.traffic_signature([]) == jbuckets.traffic_signature([])
    for spec in ("1,2,4,8", [8, 2, 2, 32], " 4  16 "):
        assert tbuckets.parse_buckets(spec) == jbuckets.parse_buckets(spec)
    for bad in ("0,4", "", "a,b"):
        for mod in (tbuckets, jbuckets):
            with pytest.raises(ValueError):
                mod.parse_buckets(bad)
    assert [tbuckets.pick_bucket(n, (1, 2, 4, 8)) for n in range(1, 9)] == \
        [jbuckets.pick_bucket(n, (1, 2, 4, 8)) for n in range(1, 9)]
    assert [tcost.pow2_at_least(n) for n in range(1, 40)] == \
        [jcost.pow2_at_least(n) for n in range(1, 40)]


# --------------------------------------------------------- staging window
def _window_script(cls):
    w = cls(2)
    log = [len(w), bool(w), w.full]
    w.push("a")
    w.push("b")
    log += [len(w), w.full, w.pushed, w.snapshot()]
    log.append(w.pop_timed(lambda e: e * 2))
    log.append(w.pop())
    log += [bool(w), w.pushed, w.wait_s >= 0.0]
    w.push("c")
    w.clear()
    log.append(len(w))
    try:
        w.pop()
    except IndexError:
        log.append("empty")
    try:
        cls(0)
    except ValueError:
        log.append("bad depth")
    return log


def test_pipeline_window_matches():
    assert _window_script(TWindow) == _window_script(JWindow)


def test_stage_pytree_on_the_cpu_copies():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    tree = {"x": [a, (a * 2,)], "y": torch.ones(2)}
    out = stage_pytree(tree, tmx.cpu())
    a[0, 0] = 99.0
    assert isinstance(out["x"], list) and isinstance(out["x"][1], tuple)
    assert out["x"][0][0, 0].item() == 0.0
    assert torch.equal(out["x"][1][0], torch.arange(6.).reshape(2, 3) * 2)
    assert out["y"].data_ptr() != tree["y"].data_ptr()
