"""The port's InferenceServer against the JAX package's, on the CPU: two
replicas, the program counts, the circuit breaker, deadlines, shutdown
and live resizing, with the same small MLP (out = softmax(x W^T + b))
and the same numpy inputs through both servers.

The JAX server's two replicas are two of the harness's virtual CPU
devices; the port's are ``[mx.cpu(), mx.cpu()]`` (repeats of one device
are replicas of their own). Outputs are held within 1e-5; counts,
breaker states and replica sets must be equal.
"""
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.resilience import faults as jfaults
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import faults as tfaults

TOL = 1e-5
PKGS = {"jax": (jmx, jfaults), "torch": (tmx, tfaults)}


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def _mlp(pkg, hidden=8):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=hidden, name="fc")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _params(seed=0, hidden=8, width=6):
    rng = np.random.RandomState(seed)
    return {"fc_weight": rng.randn(hidden, width).astype(np.float32),
            "fc_bias": rng.randn(hidden).astype(np.float32)}


def _ref(params, x):
    z = x @ params["fc_weight"].T + params["fc_bias"]
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _devices(name, n):
    if name == "jax":
        import jax

        return jax.devices()[:n]
    return [tmx.cpu()] * n


def _server(name, n_replicas=2, start=True, **cfg):
    pkg = PKGS[name][0]
    cfg.setdefault("buckets", (1, 2, 4))
    cfg.setdefault("max_wait_ms", 1)
    return pkg.serving.InferenceServer(
        _mlp(pkg), _params(), data_shapes=[("data", (1, 6))],
        devices=_devices(name, n_replicas), start=start,
        config=pkg.serving.ServingConfig(**cfg))


def _traffic(n, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.rand(1 + i % 3, 6).astype(np.float32) for i in range(n)]


def test_two_replicas_match_the_jax_server():
    params = _params()
    xs = _traffic(12) + [np.random.RandomState(9).rand(9, 6).astype(
        np.float32)]   # 9 rows: chunked at the largest bucket
    seen = {}
    for name in PKGS:
        srv = _server(name)
        try:
            warmed = srv.warmup()
            after_warmup = srv.get_stats()["bucket_programs"]
            outs = [f.result(timeout=60) for f in
                    [srv.submit(x) for x in xs]]
            stats = srv.get_stats()
        finally:
            srv.stop()
        seen[name] = (warmed, after_warmup, stats["bucket_programs"],
                      stats["replicas"], stats["chunked"])
        for x, out in zip(xs, outs):
            np.testing.assert_allclose(out, _ref(params, x), atol=TOL)
        if name == "jax":
            jax_outs = outs
        else:
            for a, b in zip(outs, jax_outs):
                np.testing.assert_allclose(a, b, atol=TOL)
    # warmup compiles (captures, walks) every (replica, bucket) pair and
    # the count stays flat under traffic
    assert seen["torch"] == seen["jax"] == (6, 6, 6, 2, 1)


@pytest.mark.parametrize("name", sorted(PKGS))
def test_quarantined_replica_preserves_fifo_and_parity(name):
    """tests/test_resilience.py's breaker test, through each package."""
    faults = PKGS[name][1]
    params = _params()
    faults.configure("serving.replica_execute[1]:raise@calls=1-2", seed=0)
    srv = _server(name, cooldown_ms=150)
    xs = _traffic(12)
    order, futs = [], []
    for i, x in enumerate(xs):
        f = srv.submit(x)
        f.add_done_callback(lambda _f, _i=i: order.append(_i))
        futs.append(f)
    for x, f in zip(xs, futs):
        np.testing.assert_allclose(f.result(timeout=60), _ref(params, x),
                                   atol=TOL)
    assert order == sorted(order)      # FIFO survived the failover
    stats = srv.get_stats()
    assert stats["quarantines"] >= 1
    assert stats.get("batch_retries", 0) >= 1
    # cooldown passes -> traffic-driven probe re-admits the replica
    time.sleep(0.25)
    for _ in range(4):
        srv.submit(xs[0]).result(timeout=60)
    time.sleep(0.25)
    for _ in range(4):
        srv.submit(xs[0]).result(timeout=60)
    stats = srv.get_stats()
    srv.stop()
    assert stats.get("readmitted", 0) >= 1
    assert stats["quarantined_replicas"] == []


def _breaker_drive(name):
    """closed -> degraded -> open -> closed, one step at a time."""
    faults = PKGS[name][1]
    params = _params()
    x = _traffic(1)[0]
    srv = _server(name, cooldown_ms=300, max_wait_ms=0)
    log = []

    def note(what):
        st = srv.get_stats()
        log.append((what, srv.breaker_states()["state"],
                    sorted(srv.breaker_states()["quarantined"]),
                    st.get("quarantines", 0), st.get("batch_retries", 0),
                    st.get("readmitted", 0), srv.active_replicas()))

    try:
        srv.warmup()
        note("start")
        faults.configure("serving.replica_execute[1]:raise@call=1", seed=0,
                         strict=False)
        for _ in range(2):      # round-robin: replica 0, then replica 1
            np.testing.assert_allclose(srv.predict(x, timeout=60),
                                       _ref(params, x), atol=TOL)
        note("replica 1 faulted, its batch retried")
        faults.configure("serving.replica_execute[0]:raise", seed=0,
                         strict=False)
        with pytest.raises(Exception, match="injected fault"):
            srv.predict(x, timeout=60)
        note("every replica faulted")
        faults.configure(None)
        time.sleep(0.45)
        np.testing.assert_allclose(srv.predict(x, timeout=60),
                                   _ref(params, x), atol=TOL)
        note("both probed back in")
    finally:
        srv.stop()
    return log


def test_breaker_states_match_the_jax_server():
    jlog, tlog = _breaker_drive("jax"), _breaker_drive("torch")
    assert tlog == jlog
    assert [row[1] for row in tlog] == ["closed", "degraded", "open",
                                        "closed"]
    assert tlog[-1][3:6] == (2, 1, 2)   # quarantines, retries, readmitted


@pytest.mark.parametrize("name", sorted(PKGS))
def test_serving_deadline_rejects_expired_before_dispatch(name):
    """tests/test_resilience.py's deadline test, through each package."""
    pkg = PKGS[name][0]
    params = _params()
    srv = _server(name, n_replicas=1, start=False, deadline_ms=40)
    stale = srv.submit(np.ones((1, 6), np.float32))
    time.sleep(0.12)                   # expires while the queue sits
    fresh_x = np.full((2, 6), 0.5, np.float32)
    fresh = srv.submit(fresh_x)
    srv.start()
    with pytest.raises(pkg.serving.DeadlineExceeded):
        stale.result(timeout=30)
    np.testing.assert_allclose(fresh.result(timeout=30),
                               _ref(params, fresh_x), atol=TOL)
    stats = srv.get_stats()
    srv.stop()
    assert stats["expired"] == 1


@pytest.mark.parametrize("name", sorted(PKGS))
def test_serving_stop_drain_timeout_unsticks(name):
    """tests/test_resilience.py's drain-timeout test, through each
    package."""
    pkg, faults = PKGS[name]
    faults.configure("serving.replica_execute:delay=3000", seed=0)
    srv = _server(name, n_replicas=1, buckets=(1, 2))
    futs = [srv.submit(np.ones((1, 6), np.float32)) for _ in range(3)]
    wedged = srv._thread
    t0 = time.monotonic()
    srv.stop(drain=True, timeout=0.4)
    assert time.monotonic() - t0 < 2.5  # did not wait out the 3 s wedge
    for f in futs:
        with pytest.raises((pkg.serving.ServerClosedError, Exception)):
            f.result(timeout=1)
    assert srv.get_stats()["drain_timeouts"] == 1
    # the dispatcher dies once the wedge passes; let it, so it counts
    # nothing into a later test's metrics
    wedged.join(10)
    assert not wedged.is_alive()


def _resize_drive(name):
    params = _params()
    srv = _server(name)
    xs = _traffic(18, seed=11)
    order, futs, log = [], [], []
    try:
        log.append(("warmup", srv.warmup()))

        def send(batch):
            for x in batch:
                i = len(futs)
                f = srv.submit(x)
                f.add_done_callback(lambda _f, _i=i: order.append(_i))
                futs.append(f)

        send(xs[:6])
        log.append(("to 1", srv.resize_replicas(1), srv.active_replicas()))
        send(xs[6:12])
        log.append(("to 3", srv.resize_replicas(3), srv.active_replicas()))
        send(xs[12:])
        for x, f in zip(xs, futs):
            np.testing.assert_allclose(f.result(timeout=60),
                                       _ref(params, x), atol=TOL)
        log.append(("warmup", srv.warmup()))
        st = srv.get_stats()
        log.append(("stats", st["bucket_programs"], st["replicas"],
                    st["capacity"]["replica_slots"], st["scale_downs"],
                    st["scale_ups"]))
        log.append(("to 3 again", srv.resize_replicas(3)))
    finally:
        srv.stop()
    assert order == sorted(order)      # FIFO across both resizes
    return log


def test_resize_matches_the_jax_server():
    jlog, tlog = _resize_drive("jax"), _resize_drive("torch")
    assert tlog == jlog
    assert tlog[1][2] == [0] and tlog[2][2] == [0, 1, 2]
    # on the CPU a reactivated slot keeps its programs, as in the JAX
    # package: 6 at warmup, +3 for the new slot
    assert tlog[4][1] == 9


def test_resize_rejects_zero_and_frees_the_slot():
    srv = _server("torch", start=False)
    with pytest.raises(ValueError):
        srv.resize_replicas(0)
    srv.resize_replicas(1)
    assert srv._replica_args[1] is None and srv._replica_aux[1] is None
    with pytest.raises(MXNetError, match="removed by resize_replicas"):
        srv._run_bucket(1, 1, srv._zero_batch(1))
    srv.stop()


def test_unported_options_name_their_roadmap_entry():
    # the int8 bind is ported: without a calibration table it raises
    # instead of serving fp32
    with pytest.raises(MXNetError, match="calibration table"):
        tmx.serving.InferenceServer(
            _mlp(tmx), _params(), data_shapes=[("data", (1, 6))],
            devices=[tmx.cpu()], quantize=True, start=False)
    with pytest.raises(MXNetError, match="ROADMAP A10"):
        tmx.serving.InferenceServer(
            _mlp(tmx), _params(), data_shapes=[("data", (1, 6))],
            devices=["cpu", "cuda:0"], start=False)


def test_mesh_replicas_and_replica_devices():
    import jax

    from mxnet_tpu.parallel.mesh import replica_devices as jrd
    from mxnet_tpu_torch.parallel.mesh import make_mesh, replica_devices

    mesh = make_mesh({"dp": 1}, devices=[tmx.cpu()])
    assert replica_devices(mesh) == [tmx.cpu().device]
    assert replica_devices(mesh, axis="dp") == [tmx.cpu().device]
    for fn in (replica_devices, jrd):
        with pytest.raises(ValueError):
            fn(axis="dp")
    with pytest.raises(ValueError):
        replica_devices(mesh, axis="nope")
    assert len(jrd()) == len(jax.devices())
    srv = tmx.serving.InferenceServer(
        _mlp(tmx), _params(), data_shapes=[("data", (1, 6))], mesh=mesh,
        config=tmx.serving.ServingConfig(buckets=(1, 2)))
    try:
        x = _traffic(1)[0]
        np.testing.assert_allclose(srv.predict(x, timeout=60),
                                   _ref(_params(), x), atol=TOL)
        assert srv.active_replicas() == [0]
    finally:
        srv.stop()


def test_from_module_and_from_checkpoint(tmp_path):
    params = _params()
    x = _traffic(3)[2]
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4, 6))],
             label_shapes=[("softmax_label", (4,))], for_training=False)
    mod.set_params({k: tmx.nd.array(v, ctx=tmx.cpu())
                    for k, v in params.items()}, {})
    mod.save_checkpoint(str(tmp_path / "mlp"), 3)
    for srv in (tmx.serving.InferenceServer.from_module(
                    mod, devices=[tmx.cpu()], start=False),
                tmx.serving.InferenceServer.from_checkpoint(
                    str(tmp_path / "mlp"), 3, devices=[tmx.cpu()],
                    data_shapes=[("data", (1, 6))], start=False)):
        srv.start()
        try:
            np.testing.assert_allclose(srv.predict(x, timeout=60),
                                       _ref(params, x), atol=TOL)
        finally:
            srv.stop()
