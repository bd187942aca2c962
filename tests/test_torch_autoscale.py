"""Port parity: the time-series plane, the SLO burn-rate alerts and the
replica autoscaler against the JAX package's, on the CPU, under a fake
clock.

* ``SeriesStore``: the same appended series give the same counter rates
  and increases (a counter reset included), gauge windows (a stale series
  included), histogram window deltas, quantiles and ``varz`` rows;
* ``TimeSeriesSampler`` snapshots the port's registry as the JAX sampler
  snapshots the JAX registry;
* the burn-rate alert's lifecycle (fire, hold inside the hysteresis band,
  clear) gives the same evaluation rows;
* ``AutoscalePolicy.decide`` and ``Autoscaler.step`` give the same
  decision sequences for the same fed series (queue high-water, whole-
  window scale-down, replica loss with an SLO firing, cooldown, clamps, a
  flapping queue inside the band);
* the closed loop on the port's two-CPU-replica ``InferenceServer``: a
  fault-killed replica and a blown TTFT objective scale it 2 -> 3, the
  recovery scales it back to 2, and the decisions equal the JAX loop's.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.observability import metrics as jmetrics
from mxnet_tpu.observability import slo_monitor as jslo
from mxnet_tpu.observability import timeseries as jts
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu.serving import control as jcontrol
from mxnet_tpu_torch.config import get_flag
from mxnet_tpu_torch.observability import metrics as tmetrics
from mxnet_tpu_torch.observability import slo_monitor as tslo
from mxnet_tpu_torch.observability import timeseries as tts
from mxnet_tpu_torch.resilience import faults as tfaults
from mxnet_tpu_torch.serving import control as tcontrol
from time_limit import time_limit  # noqa: F401

PKGS = {"jax": (jmx, jmetrics, jts, jslo, jcontrol, jfaults),
        "torch": (tmx, tmetrics, tts, tslo, tcontrol, tfaults)}


@pytest.fixture(autouse=True)
def telemetry():
    for pkg in PKGS.values():
        pkg[1].set_enabled(True)
        pkg[1].reset_metrics()
        pkg[5].reset()
    yield
    for pkg in PKGS.values():
        pkg[5].reset()
        pkg[1].reset_metrics()
        pkg[1].set_enabled(False)


def _hist(store, name, t, cum, total, s):
    """One histogram snapshot, buckets (50, 200)."""
    store.append(name, (), "histogram", (50.0, 200.0), (cum, s, total), t)


# ------------------------------------------------------------ the windows

def _fed_store(ts):
    store = ts.SeriesStore(8)
    # a counter that resets (a restarted worker) at t=40
    for t, v in ((0, 0.0), (10, 50.0), (20, 120.0), (30, 150.0),
                 (40, 5.0), (50, 45.0)):
        store.append("req", (), "counter", None, v, float(t))
    # a labelled gauge pair, one child going stale after t=20
    for t, a, b in ((0, 1.0, 4.0), (10, 3.0, 2.0), (20, 2.0, 8.0),
                    (30, 6.0, None), (50, 5.0, None)):
        store.append("depth", (("slo", "a"),), "gauge", None, a, float(t))
        if b is not None:
            store.append("depth", (("slo", "b"),), "gauge", None, b,
                         float(t))
    _hist(store, "ttft", 0.0, (0, 0, 0), 0, 0.0)
    _hist(store, "ttft", 20.0, (4, 6, 12), 12, 900.0)
    _hist(store, "ttft", 50.0, (10, 20, 30), 30, 4000.0)
    return store


def _queries(ts):
    store = _fed_store(ts)
    out = []
    for window in (5.0, 15.0, 25.0, 60.0):
        for now in (30.0, 50.0):
            out.append((
                store.rate("req", window, now=now),
                store.increase("req", window, now=now),
                store.gauge_window("depth", window, now=now),
                store.gauge_window("depth", window, labels={"slo": "b"},
                                   now=now),
                store.hist_window("ttft", window, now=now),
                store.quantile("ttft", 0.5, window, now=now),
                store.quantile("ttft", 0.99, window, now=now)))
    out.append(store.varz(30.0, 50.0))
    out.append(store.keys())
    return out


def test_series_store_windows_match_jax():
    got, want = _queries(tts), _queries(jts)
    assert got == want
    store = _fed_store(tts)
    # the reset reads as +5 then +40, never negative
    assert store.increase("req", 25.0, now=50.0) == 45.0 + 30.0
    assert store.gauge_window("depth", 25.0, labels={"slo": "b"},
                              now=50.0)["n"] == 0


def _sampled(pkg):
    mx, metrics, ts = pkg[:3]
    clk = [0.0]
    sampler = ts.TimeSeriesSampler(interval_ms=1000, retain=16,
                                   clock=lambda: clk[0])
    hits = []
    ts.register_pre_sample("probe", lambda: hits.append(clk[0]))
    try:
        c = metrics.counter("obs.requests")
        h = metrics.histogram("obs.lat_ms", buckets=(1, 10, 100))
        for i in range(5):
            c.inc(3)
            h.observe(float(4 ** i))
            metrics.gauge("obs.depth").set(i)
            clk[0] = 10.0 * i
            sampler.sample_once()
    finally:
        ts.unregister_pre_sample("probe")
    return (sampler.rate("obs.requests", 25.0),
            sampler.gauge_window("obs.depth", 25.0),
            sampler.hist_window("obs.lat_ms", 25.0),
            sampler.quantile("obs.lat_ms", 0.9, 60.0), sampler.samples,
            # this test's series (the registry may hold other tests')
            {k: v for k, v in sampler.varz(25.0)["series"].items()
             if k.startswith("obs.")}, hits)


def test_sampler_over_the_registry_matches_jax():
    got = _sampled(PKGS["torch"])
    assert got == _sampled(PKGS["jax"])
    assert got[0] == pytest.approx(0.3) and got[-1] == [0, 10, 20, 30, 40]


def test_sampler_singleton_and_flags():
    assert get_flag("MXNET_OBS_TS_INTERVAL_MS") == 1000
    assert get_flag("MXNET_OBS_TS_RETAIN") == 600
    assert (get_flag("MXNET_AUTOSCALE_MIN"), get_flag("MXNET_AUTOSCALE_MAX"),
            get_flag("MXNET_AUTOSCALE_COOLDOWN_MS")) == (1, 8, 30000)
    assert "error" in tts.varz()
    sampler = tts.start_sampler(interval_ms=50, retain=4)
    try:
        assert tts.start_sampler() is sampler and sampler.running
        assert tts.varz(1.0)["retain"] == 4
    finally:
        tts.stop_sampler()
    assert tts.get_sampler() is None and not sampler.running


# -------------------------------------------------------------- the alerts

def _alert_rows(ts, slo):
    store = ts.SeriesStore(2000)
    obj = slo.LatencyObjective("ttft", "ttft", threshold=50.0, q=0.95)
    alert = slo.BurnRateAlert(obj, short_s=60.0, long_s=600.0,
                              on_threshold=2.0, off_threshold=1.0)
    rows = []
    _hist(store, "ttft", 0.0, (0, 0, 0), 0, 0.0)
    rows.append(alert.evaluate(store, 0.0))
    _hist(store, "ttft", 60.0, (10, 10, 20), 20, 1000.0)
    rows.append(alert.evaluate(store, 60.0))         # fires
    _hist(store, "ttft", 600.0, (47, 13, 60), 60, 2000.0)
    rows.append(alert.evaluate(store, 600.0))        # held in the band
    _hist(store, "ttft", 700.0, (87, 13, 100), 100, 2400.0)
    rows.append(alert.evaluate(store, 700.0))        # clears
    for t, total, errs in ((0.0, 0.0, 0.0), (60.0, 1000.0, 5.0)):
        store.append("req", (), "counter", None, total, t)
        store.append("err", (), "counter", None, errs, t)
    avail = slo.AvailabilityObjective("avail", "err", "req", target=0.999)
    rows.append((avail.burn(store, 60.0, now=60.0),
                 avail.burn(store, 10.0, now=300.0), alert.transitions,
                 slo._fraction_within(store.hist_window(
                     "ttft", 700.0, now=700.0), 125.0)))
    return rows


def test_burn_rate_alert_lifecycle_matches_jax():
    got = _alert_rows(tts, tslo)
    assert got == _alert_rows(jts, jslo)
    assert [r["firing"] for r in got[:4]] == [False, True, True, False]
    assert got[1]["burn_short"] == pytest.approx(10.0)
    assert 1.0 < got[2]["burn_short"] < 2.0
    assert got[4][0] == pytest.approx(5.0) and got[4][2] == 2
    with pytest.raises(ValueError):
        tslo.BurnRateAlert(tslo.LatencyObjective("x", "m", 1.0),
                           on_threshold=1.0, off_threshold=2.0)


# -------------------------------------------------------------- the policy

class _StubMonitor:
    def __init__(self):
        self.firing = []

    def evaluate(self, now):
        return []

    def firing_names(self):
        return list(self.firing)


def _series(ts, queue=(), configured=(), available=()):
    s = ts.SeriesStore(100)
    for name, pts in (("serving.queue_depth", queue),
                      ("serving.replicas_configured", configured),
                      ("serving.replicas_available", available)):
        for t, v in pts:
            s.append(name, (), "gauge", None, v, t)
    return s


def _decisions(pkg):
    ts, _slo, control = pkg[2], pkg[3], pkg[4]
    mon = _StubMonitor()
    pol = control.AutoscalePolicy(queue_high=64, queue_low=4, window_s=30,
                                  min_replicas=1, max_replicas=4,
                                  slo_monitor=mon)
    quiet = [(35.0, 1.0), (45.0, 0.0), (55.0, 2.0)]
    cases = [
        ({}, None),                                       # no telemetry
        (dict(queue=[(40.0, 100.0), (50.0, 120.0)],
              configured=[(50.0, 2.0)], available=[(50.0, 2.0)]), None),
        (dict(queue=[(50.0, 120.0)], configured=[(50.0, 4.0)],
              available=[(50.0, 4.0)]), None),            # clamped
        (dict(queue=quiet, configured=[(55.0, 3.0)],
              available=[(55.0, 3.0)]), None),            # down
        (dict(queue=quiet + [(50.0, 9.0)], configured=[(55.0, 3.0)],
              available=[(55.0, 3.0)]), None),            # spike vetoes
        (dict(queue=quiet, configured=[(55.0, 3.0)],
              available=[(55.0, 3.0)]), 40.0),            # not settled
        (dict(queue=quiet, configured=[(55.0, 1.0)],
              available=[(55.0, 1.0)]), None),            # at the floor
        (dict(queue=[(55.0, 8.0)], configured=[(55.0, 3.0)],
              available=[(55.0, 1.0)]), None),            # loss, no SLO
    ]
    out = [tuple(pol.decide(_series(ts, **kw), now=60.0,
                            last_action_t=last))
           for kw, last in cases]
    mon.firing = ["ttft"]
    for avail in (1.0, 3.0):                              # rules 1 and 2
        out.append(tuple(pol.decide(_series(
            ts, queue=[(55.0, 8.0)], configured=[(55.0, 3.0)],
            available=[(55.0, avail)]), now=60.0)))
    # the Autoscaler's cooldown gate and a flapping queue in the band
    s = ts.SeriesStore(1000)
    resized = []
    scaler = control.Autoscaler(
        control.AutoscalePolicy(queue_high=10, queue_low=1, window_s=30,
                                min_replicas=1, max_replicas=8),
        s, resized.append, cooldown_ms=60_000, clock=lambda: 0.0)
    for t in (10.0, 20.0, 30.0, 40.0, 95.0):
        s.append("serving.queue_depth", (), "gauge", None, 50.0, t)
        s.append("serving.replicas_configured", (), "gauge", None,
                 2.0 + len(resized), t)
        if t in (30.0, 40.0, 95.0):
            out.append(tuple(scaler.step(now=t)))
    out.append(list(resized))
    flap = ts.SeriesStore(1000)
    flapper = control.Autoscaler(
        control.AutoscalePolicy(queue_high=64, queue_low=4, window_s=30,
                                min_replicas=1, max_replicas=8),
        flap, resized.append, cooldown_ms=1)
    for i in range(20):
        t = float(i * 10)
        for name, v in (("serving.queue_depth", 40.0 if i % 2 else 8.0),
                        ("serving.replicas_configured", 2.0),
                        ("serving.replicas_available", 2.0)):
            flap.append(name, (), "gauge", None, v, t)
        out.append(flapper.step(now=t).action)
    out.append(list(resized))
    return out


def test_policy_decision_sequences_match_jax():
    got = _decisions(PKGS["torch"])
    assert got == _decisions(PKGS["jax"])
    actions = [d[1] for d in got[:10]]
    assert actions == ["hold", "up", "up", "down", "hold", "hold", "hold",
                       "hold", "up", "up"]
    assert got[2][0] == 4                     # clamped at max_replicas
    assert [d[3] for d in got[10:13]] == [True, False, True]
    assert got[13] == [3, 4]
    assert set(got[14:34]) == {"hold"} and got[34] == [3, 4]
    with pytest.raises(ValueError):
        tcontrol.AutoscalePolicy(queue_high=4, queue_low=64)
    with pytest.raises(ValueError):
        tcontrol.AutoscalePolicy(min_replicas=3, max_replicas=2)


# ------------------------------------------------------- the closed loop

def _net(mx):
    data = mx.sym.Variable("data")
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(data, num_hidden=8, name="fc"),
        name="softmax")


def _closed_loop(name):
    mx, metrics, ts, slo, control, faults = PKGS[name]
    rng = np.random.RandomState(0)
    args = {"fc_weight": rng.randn(8, 6).astype(np.float32),
            "fc_bias": rng.randn(8).astype(np.float32)}
    if name == "jax":
        import jax

        devices = (jax.devices() * 2)[:2]
    else:
        devices = [mx.cpu(), mx.cpu()]
    # replica 1's first executions die: its breaker opens and, with a long
    # cooldown, stays open through the scale-up
    faults.configure("serving.replica_execute[1]:raise@calls=1-2", seed=0)
    srv = mx.serving.InferenceServer(
        _net(mx), args, data_shapes=[("data", (1, 6))], devices=devices,
        config=mx.serving.ServingConfig(buckets=(1, 2, 4), max_wait_ms=1,
                                        cooldown_ms=120_000))
    clk = [0.0]
    sampler = ts.TimeSeriesSampler(interval_ms=1000, retain=2000,
                                   clock=lambda: clk[0])
    ttft = metrics.histogram("slo.ttft_ms", buckets=(50, 200))
    mon = slo.SLOMonitor(sampler.store, [slo.BurnRateAlert(
        slo.LatencyObjective("ttft", "slo.ttft_ms", threshold=50.0, q=0.95),
        short_s=60.0, long_s=600.0, on_threshold=2.0, off_threshold=1.0)])
    pol = control.AutoscalePolicy(queue_high=64, queue_low=4, window_s=30,
                                  min_replicas=1, max_replicas=4,
                                  slo_monitor=mon)
    scaler = control.Autoscaler.for_server(pol, sampler.store, srv,
                                           cooldown_ms=10_000,
                                           clock=lambda: clk[0])
    trail = []
    try:
        sampler.sample_once()
        xs = [np.random.RandomState(i).rand(1 + i % 3, 6).astype(np.float32)
              for i in range(8)]
        outs = [srv.submit(x) for x in xs]
        outs = [np.asarray(f.result(timeout=60)) for f in outs]
        trail.append(len(srv.get_stats()["quarantined_replicas"]))
        for _ in range(20):
            ttft.observe(500.0)                # the users felt it
        clk[0] = 60.0
        sampler.sample_once()
        trail.append(sampler.gauge_window("serving.replicas_available", 30,
                                          now=60.0)["last"])
        trail.append(tuple(scaler.step(now=60.0)))
        trail.append(srv.get_stats()["capacity"]["replicas"])
        x = np.full((2, 6), 0.5, np.float32)
        outs.append(np.asarray(srv.submit(x).result(timeout=60)))
        faults.configure(None)
        for _ in range(200):
            ttft.observe(5.0)                  # recovered
        for t in (61.0, 700.0, 701.0):
            clk[0] = t
            sampler.sample_once()
            trail.append(tuple(scaler.step(now=t)))
            trail.append(srv.get_stats()["capacity"]["replicas"])
        trail.append(srv.get_stats()["bucket_programs"])
    finally:
        scaler.stop()
        sampler.stop()
        srv.stop()
    return trail, outs


def test_closed_loop_scales_the_port_server_as_jax():
    got, gouts = _closed_loop("torch")
    want, wouts = _closed_loop("jax")
    assert got[:-1] == want[:-1]
    for a, b in zip(gouts, wouts):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert got[0] == 1 and got[1] == 1.0
    assert got[2][:2] == (3, "up") and got[2][3] is True
    assert "replicas lost (1/2 available)" in got[2][2]
    assert got[3] == 3
    # 1 s later: inside the cooldown, nothing moves
    assert got[4][3] is False and got[5] == 3
    assert got[6][:2] == (2, "down") and got[6][3] is True and got[7] == 2
    assert got[8][1] == "hold" and got[9] == 2      # not settled
