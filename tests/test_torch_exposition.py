"""The port's exposition plane and fleet aggregator against the JAX
package's, on the CPU and localhost.

* ``exposition``: ``/metrics`` parses through the port's ``promparse``,
  ``/statusz`` carries the live ``perf`` section (after a fit: MFU None on
  the CPU, the waterfall, the program table as a provider section), the
  training section and the same top-level keys as the JAX package's
  ``statusz()``; ``/healthz``, ``/tracez``, ``/varz`` answer; an unknown
  path is a 404; ``MXNET_OBS_HTTP_PORT`` starts the plane.
* ``fleet``: the same scrape scripts as the JAX package's tests give the
  same merged windows (bit-exact histogram merges, counter resets never
  negative, heterogeneous label sets, stale/dead workers), with worker
  texts rendered by either package's registry; a live aggregator scrapes
  two endpoints of this process and merges them.
"""
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from mxnet_tpu.observability import exposition as jexposition
from mxnet_tpu.observability import fleet as jfleet
from mxnet_tpu.observability import metrics as JM
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.observability import exposition, fleet, perf, promparse
from mxnet_tpu_torch.observability import metrics as M
from time_limit import time_limit  # noqa: F401

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture
def telemetry():
    M.set_enabled(True)
    M.reset_metrics()
    JM.set_enabled(True)
    JM.reset_metrics()
    perf.reset()
    yield
    M.reset_metrics()
    M.set_enabled(False)
    JM.reset_metrics()
    JM.set_enabled(False)
    perf.reset()


def _toy_fit(steps=2):
    rng = np.random.RandomState(0)
    data = mx.sym.Variable("data")
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        data, num_hidden=4, name="fc"), name="softmax")
    with mx.cpu():
        it = mx.io.NDArrayIter(rng.rand(4 * steps, 6).astype(np.float32),
                               rng.randint(0, 4, 4 * steps)
                               .astype(np.float32), batch_size=4)
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.1),))


def _get(port, path):
    r = urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                               timeout=10)
    return r.read().decode()


def test_endpoints_on_localhost(telemetry):
    _toy_fit(steps=2)
    port = exposition.start_http(0)
    try:
        assert exposition.start_http(0) == port   # idempotent
        parsed = promparse.parse_text(_get(port, "/metrics"))
        assert parsed.types.get("mxnet_step_ms") == "histogram"
        assert parsed.samples["mxnet_step_count"][()] == 2.0
        statusz = json.loads(_get(port, "/statusz"))
        assert set(statusz) == set(jexposition.statusz())
        pz = statusz["perf"]
        assert pz["enabled"] and pz["programs"] == 1
        assert pz["mfu_pct"] is None          # a CPU run has no MFU
        assert pz["waterfall"]["step"] == 2
        assert statusz["providers"]["perf"]["programs"][0]["mode"] == "train"
        assert statusz["training"]["steps_recorded"] == 2
        assert statusz["profiler_dropped_events"] == 0
        health = json.loads(_get(port, "/healthz"))
        assert health["status"] == "ok" and health["pid"] == os.getpid()
        assert "recent" in json.loads(_get(port, "/tracez"))
        assert isinstance(json.loads(_get(port, "/varz?window=5")), dict)
        with pytest.raises(urllib.error.HTTPError) as err:
            _get(port, "/nope")
        assert err.value.code == 404
    finally:
        exposition.stop_http()
    assert exposition.http_port() is None


def test_env_port_starts_the_plane():
    probe = ("import json, urllib.request\n"
             "import mxnet_tpu_torch.observability as obs\n"
             "port = obs.exposition.http_port()\n"
             "body = urllib.request.urlopen('http://127.0.0.1:%d/healthz'"
             " % port, timeout=10).read()\n"
             "print(json.loads(body)['status'])\n")
    env = dict(os.environ, PYTHONPATH=_REPO, MXNET_OBS_HTTP_PORT="0")
    out = subprocess.run([sys.executable, "-c", probe], cwd=_REPO,
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_statusz_without_training_is_clean(telemetry):
    s = exposition.statusz()
    assert s["training"] is None
    assert s["perf"]["programs"] == 0 and s["perf"]["waterfall"] is None


# ------------------------------------------------------------------ fleet

class FakeFleet:
    """url -> exposition text, mutable between scrapes; raising entries
    simulate a down worker."""

    def __init__(self, texts):
        self.texts = dict(texts)

    def __call__(self, url):
        body = self.texts[url]
        if isinstance(body, Exception):
            raise body
        return body


def _render(registry, build):
    registry.reset_metrics()
    build(registry)
    text = registry.dump_metrics()
    registry.reset_metrics()
    return text


def _aggs(texts, workers=("a", "b"), **kw):
    """The port's and the JAX package's aggregators over one fake fleet
    and one fake clock."""
    clock = {"t": 0.0}
    fetch = FakeFleet(texts)
    kw.setdefault("interval_ms", 1000)
    kw.setdefault("stale_after", 2)
    kw.setdefault("dead_after", 4)
    kw.setdefault("retain", 64)
    urls = {w: "http://%s/metrics" % w for w in workers}
    made = [mod.FleetAggregator(urls, clock=lambda: clock["t"], fetch=fetch,
                                **kw) for mod in (fleet, jfleet)]
    return made, clock, fetch


def _worker_a(R):
    h = R.histogram("w.lat", buckets=(1, 2, 4))
    for v in (0.5, 1.5, 3.0, 9.0):
        h.observe(v)
    R.counter("w.req").inc(10)


def _worker_b(R):
    h = R.histogram("w.lat", buckets=(1, 2, 4))
    for v in (0.2, 0.9, 5.0):
        h.observe(v)
    R.counter("w.req").inc(20)


@pytest.mark.parametrize("renderer", ["port", "jax", "mixed"])
def test_merge_is_bit_exact_per_worker_sum(telemetry, renderer):
    ra, rb = {"port": (M, M), "jax": (JM, JM), "mixed": (JM, M)}[renderer]
    (t, j), clock, _fetch = _aggs({
        "http://a/metrics": _render(ra, _worker_a),
        "http://b/metrics": _render(rb, _worker_b)})
    for agg in (t, j):
        agg.scrape_once()
    clock["t"] = 10.0
    for agg in (t, j):
        agg.scrape_once()
    win = t.hist_window("mxnet_w_lat", 60, now=10.0)
    assert win == j.hist_window("mxnet_w_lat", 60, now=10.0)
    assert win["counts"] == [3, 1, 1, 2] and win["count"] == 7
    wa = t.hist_window("mxnet_w_lat", 60, labels=(("worker", "a"),),
                       now=10.0)
    assert wa["count"] == 4 and wa["counts"] == [1, 1, 1, 1]
    assert t.rate("mxnet_w_req", 60, now=10.0) == \
        j.rate("mxnet_w_req", 60, now=10.0)


def test_worker_restart_counter_reset_rate_never_negative(telemetry):
    before = _render(M, lambda R: R.counter("w.req").inc(1000))
    (t, j), clock, fetch = _aggs({"http://a/metrics": before,
                                  "http://b/metrics": before})
    for agg in (t, j):
        agg.scrape_once()
    fetch.texts["http://b/metrics"] = _render(
        M, lambda R: R.counter("w.req").inc(3))
    clock["t"] = 10.0
    for agg in (t, j):
        agg.scrape_once()
    rate = t.rate("mxnet_w_req", 60, now=10.0)
    assert rate == pytest.approx(0.3)
    assert rate == j.rate("mxnet_w_req", 60, now=10.0)


def test_two_workers_different_label_sets(telemetry):
    def boot_a(R):
        R.counter("w.cls", labels={"slo": "premium"}).inc(0)
        R.counter("w.cls", labels={"slo": "batch"}).inc(0)

    def run_a(R):
        R.counter("w.cls", labels={"slo": "premium"}).inc(5)
        R.counter("w.cls", labels={"slo": "batch"}).inc(7)

    (t, j), clock, fetch = _aggs({
        "http://a/metrics": _render(M, boot_a),
        "http://b/metrics": _render(
            M, lambda R: R.counter("w.cls", labels={"slo": "premium"})
            .inc(0))})
    for agg in (t, j):
        agg.scrape_once()
    fetch.texts["http://a/metrics"] = _render(M, run_a)
    fetch.texts["http://b/metrics"] = _render(
        M, lambda R: R.counter("w.cls", labels={"slo": "premium"}).inc(11))
    clock["t"] = 10.0
    for agg in (t, j):
        agg.scrape_once()
    assert t.store.increase("mxnet_w_cls", 60, now=10.0) == 23.0
    assert t.store.increase(
        "mxnet_w_cls", 60, labels=(("slo", "premium"), ("worker", "b")),
        now=10.0) == 11.0
    assert t.fleet_status(60.0, now=10.0)["series"] == \
        j.fleet_status(60.0, now=10.0)["series"]


def test_dead_worker_series_stale_not_flat(telemetry):
    def worker(R):
        R.gauge("w.depth").set(42.0)
        R.counter("w.req").inc(100)

    text = _render(M, worker)
    (t, j), clock, fetch = _aggs({"http://a/metrics": text,
                                  "http://b/metrics": text})
    for i in range(3):
        clock["t"] = i * 10.0
        assert t.scrape_once()["b"] == "ok"
        j.scrape_once()
    fetch.texts["http://b/metrics"] = ConnectionRefusedError("down")
    statuses = []
    for i in range(3, 9):
        clock["t"] = i * 10.0
        statuses.append(t.scrape_once()["b"])
        j.scrape_once()
    assert statuses[0] == "ok" and "stale" in statuses
    assert statuses[-1] == "dead"
    assert t.alive_workers() == ["a"] == j.alive_workers()
    gb = t.gauge_window("mxnet_w_depth", 20, labels=(("worker", "b"),),
                        now=clock["t"])
    assert gb["n"] == 0 and gb["last"] is None
    up = t.gauge_window("fleet.worker_up", 20, labels=(("worker", "b"),),
                        now=clock["t"])
    assert up["n"] > 0 and up["max"] == 0.0
    row = t.worker_status()["b"]
    assert row["status"] == "dead" and row["consecutive_failures"] >= 4
    assert "ConnectionRefusedError" in row["last_error"]
    assert row == j.worker_status()["b"]


def test_live_fleet_over_two_endpoints(telemetry):
    _toy_fit(steps=2)
    port = exposition.start_http(0)
    try:
        url = "http://127.0.0.1:%d/metrics" % port
        agg = fleet.FleetAggregator({"w0": url, "w1": url},
                                    interval_ms=1000)
        assert agg.scrape_once() == {"w0": "ok", "w1": "ok"}
        M.counter("step.count").inc(3)
        assert agg.scrape_once() == {"w0": "ok", "w1": "ok"}
        # both workers saw 2 -> 5 steps: the fleet's increase sums them
        assert agg.store.increase("mxnet_step_count", 1e6,
                                 now=agg.now()) == 6.0
        assert agg.fleet_status()["workers"]["w1"]["status"] == "ok"
        agg.start()
        assert agg.running
        agg.stop()
        assert not agg.running
    finally:
        exposition.stop_http()


def test_parser_rejects_garbage():
    with pytest.raises(ValueError):
        promparse.parse_text("mxnet_x{k=\"v\"} not_a_number")
