"""The port's profiler, span tracing and instruments, on the CPU.

* ``profiler``: the chrome-trace dump of a session (host spans nested as
  they ran, program events, the ``torch.profiler`` session's op records in
  the imperative modes, ``kernelRecords`` — 0 on the CPU), the bounded
  ring and its drop count in the dump, atomic dumps under a concurrent
  recorder, ``MXNET_PROFILER_MODE``; the same events a JAX session
  records for the same spans (names, categories, nesting).
* ``tracing``: ``trace_span`` off without a session or telemetry, its
  duration histograms under telemetry; ``device_scope`` labels the ops
  in a ``torch.profiler`` trace.
* ``instruments``: captures and kernel builds counted with their keys,
  ``device_peak_bytes`` / ``sample_memory`` on the host fallback,
  ``record_step``.
* ``request_trace``: a finished trace lands in the profiler ring.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.observability import tracing as jtracing
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch.observability import instruments
from mxnet_tpu_torch.observability import metrics as M
from mxnet_tpu_torch.observability import request_trace, trace_span
from mxnet_tpu_torch.observability.tracing import device_scope


@pytest.fixture
def session(tmp_path):
    path = str(tmp_path / "prof.json")
    profiler.set_config(mode="symbolic", filename=path)
    yield path
    profiler.set_state("stop")
    profiler.set_config(mode="symbolic", filename="profile.json")
    profiler.configure_ring(None)


@pytest.fixture
def telemetry():
    M.set_enabled(True)
    M.reset_metrics()
    yield
    M.reset_metrics()
    M.set_enabled(False)


def _spans(trace_span_fn):
    with trace_span_fn("outer", "phase"):
        time.sleep(0.002)
        with trace_span_fn("inner", "phase"):
            time.sleep(0.002)
        time.sleep(0.002)


def test_dump_nests_spans_like_the_jax_session(session, telemetry, tmp_path):
    profiler.set_state("run")
    _spans(trace_span)
    path = profiler.dump_profile()
    payload = json.load(open(path))
    events = payload["traceEvents"]
    by_name = {ev["name"]: ev for ev in events}
    for ev in events:
        for field in ("ph", "ts", "dur", "cat", "name", "pid", "tid"):
            assert field in ev
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["dur"] > inner["dur"]
    assert M.get_value("span.outer.ms", 0) == 1
    assert payload["kernelRecords"] == 0   # no card here
    assert payload["kernelRecordsByName"] == {}
    assert "droppedEventsCount" not in payload

    # the JAX package's session records the same spans the same way
    # (its device trace stubbed: the host events are under test)
    import jax

    jpath = str(tmp_path / "jax.json")
    start, stop = jax.profiler.start_trace, jax.profiler.stop_trace
    jax.profiler.start_trace = lambda logdir: None
    jax.profiler.stop_trace = lambda: None
    try:
        # events another test in this process left in the JAX package's
        # ring (a dump drains it) are not this session's
        with jmx.profiler._lock:
            jmx.profiler._events.clear()
        jmx.profiler.set_config(mode="symbolic", filename=jpath)
        jmx.profiler.set_state("run")
        _spans(jtracing.trace_span)
        jmx.profiler.dump_profile()
    finally:
        jax.profiler.start_trace, jax.profiler.stop_trace = start, stop
        jmx.profiler.set_config(mode="symbolic", filename="profile.json")
    jevents = json.load(open(jpath))["traceEvents"]
    key = lambda evs: sorted((e["name"], e["cat"], e["ph"]) for e in evs)
    assert key(events) == key(jevents)


def test_span_noop_without_profiler_or_telemetry():
    assert not M.enabled() and not profiler.spans_active()
    with trace_span("nothing", "x"):
        pass
    assert M.get_value("span.nothing.ms") is None
    assert profiler.events_tail(4) == [] or \
        all(e["name"] != "nothing" for e in profiler.events_tail(4))


def test_fit_session_records_steps_programs_and_ops(session):
    profiler.set_config(mode="all", filename=session)
    rng = np.random.RandomState(0)
    data = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data, num_hidden=4, name="fc"), name="softmax")
    with mx.cpu():
        it = mx.io.NDArrayIter(rng.rand(16, 6).astype(np.float32),
                               rng.randint(0, 4, 16).astype(np.float32),
                               batch_size=4)
        mod = mx.mod.Module(net, context=mx.cpu())
        profiler.set_state("run")
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.1),))
    payload = json.load(open(profiler.dump_profile()))
    names = [e["name"] for e in payload["traceEvents"]]
    cats = {e["cat"] for e in payload["traceEvents"]}
    assert names.count("step") == 4 and names.count("update") == 4
    assert names.count("forward_backward") == 4
    assert {"module", "executor", "op"} <= cats
    # op records sit on the host timeline inside the session's span
    steps = [e for e in payload["traceEvents"] if e["name"] == "step"]
    ops = [e for e in payload["traceEvents"] if e["cat"] == "op"]
    lo = min(e["ts"] for e in steps) - 1e3
    hi = max(e["ts"] + e["dur"] for e in steps) + 1e3
    assert ops and sum(lo <= e["ts"] <= hi for e in ops) > len(ops) // 2


def test_ring_drops_are_counted_in_the_dump(session):
    profiler.configure_ring(8)
    profiler.set_state("run")
    for i in range(20):
        profiler.record("ev%d" % i, "test", float(i), 1.0)
    assert profiler.dropped_events() == 12
    assert [e["name"] for e in profiler.events_tail(3)] == \
        ["ev17", "ev18", "ev19"]
    payload = json.load(open(profiler.dump_profile()))
    assert payload["droppedEventsCount"] == 12
    assert [e["name"] for e in payload["traceEvents"]
            if e["cat"] == "test"] == ["ev%d" % i for i in range(12, 20)]
    assert profiler.dropped_events() == 0   # the dump consumed the loss


def test_concurrent_record_and_dump_stay_atomic(session, tmp_path,
                                                monkeypatch):
    # the torch.profiler session is orthogonal to the host-event locking
    # under test; real sessions are covered above
    monkeypatch.setattr(profiler, "_start_device_trace", lambda: None)
    stop = threading.Event()

    def hammer():
        i = 0
        while not stop.is_set():
            profiler.record("ev%d" % (i % 7), "operator", float(i), 1.0)
            i += 1
            if i % 64 == 0:
                time.sleep(0.0005)

    t = threading.Thread(target=hammer)
    t.start()
    try:
        for _ in range(10):
            profiler.set_state("run")
            profiler.pause()
            profiler.resume()
            time.sleep(0.002)
            payload = json.load(open(profiler.dump_profile()))
            assert "traceEvents" in payload
    finally:
        stop.set()
        t.join()
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_profiler_mode_env(monkeypatch):
    monkeypatch.setenv("MXNET_PROFILER_MODE", "imperative")
    assert profiler._env_mode() == "imperative"
    monkeypatch.setenv("MXNET_PROFILER_MODE", "bogus")
    assert profiler._env_mode() == "symbolic"
    with pytest.raises(ValueError):
        profiler.set_config(mode="bogus")


def test_device_scope_labels_ops():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with device_scope("mx::scope"):
            torch.ones(4).add_(1)
    assert any(e.name == "mx::scope" for e in prof.events())


def test_request_trace_lands_in_the_ring(session):
    profiler.set_state("run")
    tr = request_trace.begin("serving", sample=1)
    tr.event("queue")
    tr.event("compute")
    tr.finish()
    payload = json.load(open(profiler.dump_profile()))
    req = [e for e in payload["traceEvents"] if e["cat"] == "request"]
    assert {e["ph"] for e in req} == {"X", "s", "f"}
    assert {e["name"] for e in req if e["ph"] == "X"} == \
        {"req.serving.queue", "req.serving.compute"}
    assert all(e["args"]["trace_id"] == tr.trace_id for e in req)


# ------------------------------------------------------------ instruments

def test_captures_and_builds_counted(telemetry):
    c0, b0 = instruments.captures(), instruments.kernel_builds()
    instruments.note_capture(("bucket", 8), 0.25)
    instruments.note_kernel_build("flash_attention", 20.0, True)
    instruments.note_kernel_build("fused_matmul", 0.01, False)
    assert instruments.captures() == c0 + 1
    assert instruments.kernel_builds() == b0 + 2
    assert instruments.retrace_causes()[-1] == "('bucket', 8)"
    assert M.get_value("cuda_graph.capture_count") == 1
    assert M.get_value("kernel.build_count", labels={"nvcc": "1"}) == 1
    assert M.get_value("kernel.build_count", labels={"nvcc": "0"}) == 1


def test_memory_watermarks_host_fallback(telemetry):
    peak = instruments.device_peak_bytes()
    assert peak and peak > 0
    live = instruments.sample_memory()
    assert live > 0
    assert M.get_value("hbm.source") == 1
    assert M.get_value("hbm.peak_bytes") >= live
    instruments.record_step(0.01)
    assert M.get_value("step.count") == 1


def test_memory_sampling_off_without_telemetry():
    assert not M.enabled()
    assert instruments.sample_memory() is None
    before = M.get_value("step.count")
    instruments.record_step(0.01)
    assert M.get_value("step.count") == before
