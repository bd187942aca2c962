"""Port parity: preemption-safe training (``resilience/retry.py``,
``checkpoint.py``, ``preemption.py``, ``fit(resume=)`` and the iterators'
position protocol) against mxnet_tpu.

The port's own contract is bit-exactness: a fit stopped by SIGTERM at step
k and resumed ends on the unbroken fit's parameters bit for bit (the same
program in one package). Across packages the checkpoint files hold:
``params.ndarray``, ``optimizer.states`` and ``iterator.json`` are the
same bytes after the same fit (the fit's values are dyadic with few bits,
so neither package rounds and both compute the same numbers), and a
checkpoint the JAX package wrote resumes in the port, ending within 1e-5
of the JAX package's unbroken run, with one warning that the random
stream does not cross packages.
"""
import json
import logging
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.resilience import checkpoint as jckpt
from mxnet_tpu_torch.resilience import (InjectedFault, PreemptedError,
                                        PreemptionGuard, RetryExhaustedError,
                                        RetryPolicy, checkpoint as ckpt,
                                        faults, retry)
from time_limit import time_limit  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


# ---------------------------------------------------------------- retry

def test_retry_policy_defaults_match_the_jax_package(monkeypatch):
    from mxnet_tpu.resilience import RetryPolicy as JPolicy

    for k in ("MXNET_RETRY_MAX", "MXNET_RETRY_BASE_MS",
              "MXNET_RETRY_MAX_MS", "MXNET_RETRY_DEADLINE_MS"):
        monkeypatch.delenv(k, raising=False)
    for pol in (RetryPolicy(), JPolicy()):
        assert (pol.max_attempts, pol.base_delay_s, pol.max_delay_s,
                pol.deadline_s, pol.jitter) == (3, 0.01, 2.0, 30.0, 0.25)
    monkeypatch.setenv("MXNET_RETRY_MAX", "7")
    monkeypatch.setenv("MXNET_RETRY_BASE_MS", "5")
    assert (RetryPolicy().max_attempts, RetryPolicy().base_delay_s) == \
        (JPolicy().max_attempts, JPolicy().base_delay_s) == (7, 0.005)
    exact = RetryPolicy(base_delay_ms=10, max_delay_ms=50, jitter=0.0)
    assert [exact.delay_s(i) for i in (1, 2, 3, 4)] == \
        [JPolicy(base_delay_ms=10, max_delay_ms=50, jitter=0.0).delay_s(i)
         for i in (1, 2, 3, 4)] == [0.01, 0.02, 0.04, 0.05]


def test_retry_heals_transient_then_exhausts():
    from mxnet_tpu_torch.observability import metrics

    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise ConnectionError("transient")
        return "ok"

    pol = RetryPolicy(max_attempts=4, base_delay_ms=1, jitter=0.0)
    assert retry.call(flaky, policy=pol, name="t") == "ok"
    assert calls["n"] == 3

    def always():
        raise ConnectionError("down")

    reconnects = []
    was = metrics.enabled()
    metrics.set_enabled(True)
    try:
        before = [metrics.counter("retry.t2.%s" % k).value
                  for k in ("retries", "exhausted")]
        with pytest.raises(RetryExhaustedError) as ei:
            retry.call(always, policy=RetryPolicy(max_attempts=3,
                                                  base_delay_ms=1,
                                                  jitter=0.0),
                       name="t2", on_retry=lambda e, a: reconnects.append(a))
        after = [metrics.counter("retry.t2.%s" % k).value
                 for k in ("retries", "exhausted")]
    finally:
        metrics.set_enabled(was)
    assert [a - b for a, b in zip(after, before)] == [2, 1]
    assert ei.value.attempts == 3
    assert isinstance(ei.value.last_error, ConnectionError)
    assert isinstance(ei.value.__cause__, ConnectionError)
    assert reconnects == [1, 2]        # on_retry between attempts only

    # non-retryable errors pass through untouched
    with pytest.raises(ValueError):
        retry.call(lambda: (_ for _ in ()).throw(ValueError("semantic")),
                   policy=pol, name="t3")
    # a failing reconnect is swallowed: the next attempt is the loud path
    calls["n"] = 0

    def bad_reconnect(err, attempt):
        raise OSError("reconnect failed")

    assert retry.call(flaky, policy=pol, name="t4",
                      on_retry=bad_reconnect) == "ok"


def test_retry_deadline_caps_attempts():
    t0 = time.monotonic()
    with pytest.raises(RetryExhaustedError) as ei:
        retry.call(lambda: (_ for _ in ()).throw(ConnectionError("x")),
                   policy=RetryPolicy(max_attempts=100, base_delay_ms=30,
                                      deadline_ms=80, jitter=0.0),
                   name="deadline")
    assert ei.value.attempts < 100
    assert time.monotonic() - t0 < 5.0


# ----------------------------------------------------- the position protocol

def test_ndarray_iter_state_restores_a_foreign_shuffle_across_packages():
    """The JAX package's snapshot, taken after one batch, restored onto
    the port's iterator built with another construction-time shuffle:
    the next batches are the JAX iterator's."""
    X = np.arange(40, dtype=np.float32).reshape(10, 4)
    y = np.arange(10, dtype=np.float32)
    np.random.seed(1)
    a = jmx.io.NDArrayIter(X, y, batch_size=3, shuffle=True)
    a.next()
    state = a.get_state()
    ref = [a.next().label[0].asnumpy().copy() for _ in range(2)]
    np.random.seed(2)
    b = tmx.io.NDArrayIter(X, y, batch_size=3, shuffle=True)
    assert b.get_state()["idx"] != state["idx"]
    b.set_state(json.loads(json.dumps(state)))
    assert b.get_state() == state
    for want in ref:
        np.testing.assert_array_equal(b.next().label[0].asnumpy(), want)
    # skip_batches is cursor math in both packages
    np.random.seed(1)
    c = tmx.io.NDArrayIter(X, y, batch_size=3, shuffle=True)
    np.random.seed(1)
    d = jmx.io.NDArrayIter(X, y, batch_size=3, shuffle=True)
    c.skip_batches(2)
    d.skip_batches(2)
    assert c.get_state() == d.get_state()
    np.testing.assert_array_equal(c.next().data[0].asnumpy(),
                                  d.next().data[0].asnumpy())


def test_ndarray_iter_state_refuses_another_dataset():
    X = np.zeros((10, 2), np.float32)
    it = tmx.io.NDArrayIter(X, batch_size=2, shuffle=False)
    with pytest.raises(tmx.MXNetError, match="does not match"):
        it.set_state({"cursor": 0, "idx": list(range(8))})
    np.random.seed(0)
    cut = tmx.io.NDArrayIter(np.zeros((9, 2), np.float32), batch_size=2,
                             shuffle=True, last_batch_handle="discard")
    with pytest.raises(tmx.MXNetError, match="truncated"):
        cut.set_state({"cursor": 0, "idx": list(range(8))})
    it.set_state(None)   # None is always a no-op


# ------------------------------------------------------- resumable fits

def _mlp(mx):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax")


def _fit_params(mx, resume=None, batch_end_callback=None, num_epoch=3,
                shuffle=False):
    """tests/test_resilience.py _fit_params: 4 batches of 8 a epoch."""
    np.random.seed(11)
    mx.random.seed(11)
    rng = np.random.RandomState(3)
    X = rng.rand(32, 6).astype(np.float32)
    y = (rng.rand(32) * 4).astype(np.float32)
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=8, shuffle=shuffle,
                              label_name="softmax_label"),
            num_epoch=num_epoch, optimizer="sgd",
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)),
            initializer=mx.init.Uniform(0.3),
            batch_end_callback=batch_end_callback, resume=resume)
    args, _ = mod.get_params()
    return {k: v.asnumpy().copy() for k, v in args.items()}


def _preempt_at(n):
    count = [0]

    def preempt(param):
        count[0] += 1
        if count[0] == n:
            os.kill(os.getpid(), signal.SIGTERM)

    return preempt


@pytest.mark.parametrize("shuffle", [False, True])
def test_sigterm_mid_fit_resumes_bit_exact(tmp_path, shuffle):
    """The 5th batch-end callback of 4-batch epochs (epoch 1, its first
    batch) sends SIGTERM: the checkpoint sits at (epoch, batch, step) =
    (1, 1, 5), and the resumed fit, under another numpy seed, ends on the
    unbroken fit's parameters bit for bit. The unbroken fit is the JAX
    package's within 1e-5."""
    full = _fit_params(tmx, shuffle=shuffle)
    jfull = _fit_params(jmx, shuffle=shuffle)
    for k in full:
        np.testing.assert_allclose(full[k], jfull[k], **_FIT_TOL)
    previous = signal.getsignal(signal.SIGTERM)
    with pytest.raises(PreemptedError) as ei:
        _fit_params(tmx, resume=str(tmp_path), shuffle=shuffle,
                    batch_end_callback=_preempt_at(5))
    assert signal.getsignal(signal.SIGTERM) is previous   # disarmed
    assert "ckpt-" in ei.value.checkpoint_path
    state = ckpt.load_latest(str(tmp_path))
    assert (state.epoch, state.batch, state.step) == (1, 1, 5)
    assert sorted(state.meta["files"]) == sorted(
        ["params.ndarray", "optimizer.states", ckpt.RNG_FILE,
         "iterator.json", "ring.json"])
    np.random.seed(12345)
    resumed = _fit_params(tmx, resume=str(tmp_path), shuffle=shuffle)
    for k in full:
        np.testing.assert_array_equal(full[k], resumed[k], err_msg=k)
        assert np.isfinite(resumed[k]).all()


def test_preemption_at_the_epoch_turnover_resumes_at_the_next_epoch(
        tmp_path):
    """SIGTERM from an epoch-end callback: the checkpoint is the top of
    the next epoch, and the resumed fit is bit-exact."""
    full = _fit_params(tmx, num_epoch=3)
    np.random.seed(11)
    tmx.random.seed(11)
    rng = np.random.RandomState(3)
    X = rng.rand(32, 6).astype(np.float32)
    y = (rng.rand(32) * 4).astype(np.float32)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())

    def at_epoch_end(epoch, *_):
        if epoch == 0:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(PreemptedError):
        mod.fit(tmx.io.NDArrayIter(X, y, batch_size=8),
                num_epoch=3, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.1),
                                  ("momentum", 0.9)),
                initializer=tmx.init.Uniform(0.3),
                epoch_end_callback=at_epoch_end, resume=str(tmp_path))
    state = ckpt.load_latest(str(tmp_path))
    assert (state.epoch, state.batch, state.step) == (1, 0, 4)
    resumed = _fit_params(tmx, resume=str(tmp_path), num_epoch=3)
    for k in full:
        np.testing.assert_array_equal(full[k], resumed[k], err_msg=k)


def test_corrupt_manifest_falls_back_to_previous(tmp_path):
    np.random.seed(0)
    rng = np.random.RandomState(3)
    X = rng.rand(16, 6).astype(np.float32)
    y = (rng.rand(16) * 4).astype(np.float32)
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=8), num_epoch=1,
            optimizer="sgd", initializer=tmx.init.Uniform(0.3))

    # corrupt latest manifest -> previous wins
    d1 = str(tmp_path / "manifest")
    good = mod.save_resumable(d1, epoch=0, batch=2, step=2)
    bad = mod.save_resumable(d1, epoch=1, batch=0, step=4)
    with open(os.path.join(bad, "MANIFEST.json"), "w") as f:
        f.write("{not json")
    state = ckpt.load_latest(d1)
    assert state.step == 2 and state.path == good
    with pytest.raises(tmx.MXNetError, match="unreadable manifest"):
        ckpt.validate(bad)

    # checksum mismatch (tampered params) is also rejected
    d2 = str(tmp_path / "checksum")
    mod.save_resumable(d2, epoch=0, batch=2, step=2)
    bad2 = mod.save_resumable(d2, epoch=1, batch=0, step=6)
    with open(os.path.join(bad2, "params.ndarray"), "ab") as f:
        f.write(b"garbage")
    with pytest.raises(tmx.MXNetError, match="checksum mismatch"):
        ckpt.validate(bad2)
    assert ckpt.load_latest(d2).step == 2

    # a fault during write (before the manifest) leaves an invisible dir
    d3 = str(tmp_path / "faulted")
    mod.save_resumable(d3, epoch=0, batch=2, step=2)
    faults.configure("checkpoint.write:raise@call=1")
    with pytest.raises(InjectedFault):
        mod.save_resumable(d3, epoch=2, batch=0, step=8)
    faults.reset()
    assert ckpt.load_latest(d3).step == 2

    # nothing valid at all -> None (fresh start, not a crash)
    assert ckpt.load_latest(str(tmp_path / "empty")) is None

    # prune never counts invalid (crashed-write) dirs toward its quota
    d4 = str(tmp_path / "prune")
    mod.save_resumable(d4, epoch=0, batch=1, step=1)
    os.makedirs(os.path.join(d4, "ckpt-00000025"))
    os.makedirs(os.path.join(d4, "ckpt-00000030"))
    mod.save_resumable(d4, epoch=0, batch=2, step=2)  # prune runs here
    assert ckpt.load_latest(d4).step == 2
    assert sorted(os.listdir(d4)) == ["ckpt-00000001", "ckpt-00000002"]
    assert [s for s, _ in ckpt.list_checkpoints(d4)] == [2, 1]


def test_guard_is_inert_off_the_main_thread_and_restores_the_handler(
        tmp_path):
    seen = {}

    def arm():
        g = PreemptionGuard(str(tmp_path))
        seen["armed"] = g.armed
        g.disarm()

    t = threading.Thread(target=arm)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and seen["armed"] is False

    marker = []

    def previous(signum, frame):
        marker.append(signum)

    old = signal.signal(signal.SIGTERM, previous)
    try:
        g = PreemptionGuard(str(tmp_path))
        assert g.armed and not g.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.triggered and marker == []   # flag only, no chaining
        g.disarm()
        g.disarm()                            # idempotent
        assert signal.getsignal(signal.SIGTERM) is previous
    finally:
        signal.signal(signal.SIGTERM, old)


def test_save_resumable_data_iter_position_no_double_skip(tmp_path):
    """``save_resumable(data_iter=)`` tags the iterator's current position:
    the resumed fit trains exactly the batches after it."""
    X = np.arange(96, dtype=np.float32).reshape(24, 4)
    y = np.arange(24, dtype=np.float32) % 3

    def mlp():
        x = tmx.sym.Variable("data")
        x = tmx.sym.FullyConnected(x, num_hidden=3, name="fc")
        return tmx.sym.SoftmaxOutput(x, name="softmax")

    fit_kw = dict(num_epoch=1, optimizer="sgd",
                  optimizer_params=(("learning_rate", 0.1),),
                  initializer=tmx.init.Uniform(0.3))
    it = tmx.io.NDArrayIter(X, y, batch_size=4)
    np.random.seed(0)
    mod = tmx.mod.Module(mlp(), context=tmx.cpu())
    mod.fit(it, **fit_kw)
    it.reset()
    it.next()
    it.next()
    mod.save_resumable(str(tmp_path), epoch=0, batch=2, step=2,
                       data_iter=it)
    seen = []
    mod2 = tmx.mod.Module(mlp(), context=tmx.cpu())
    it2 = tmx.io.NDArrayIter(X, y, batch_size=4)
    mod2.fit(it2, resume=str(tmp_path),
             batch_end_callback=lambda p: seen.append(
                 p.locals["data_batch"].data[0].asnumpy()[0, 0]),
             **fit_kw)
    assert seen == [32.0, 48.0, 64.0, 80.0]   # batches 2..5, once each


def test_kill_term_subprocess_then_resume_reaches_step_count(tmp_path):
    """kill -TERM a real training process mid-fit (the port, a small MLP
    on the CPU); a second process resumes and trains exactly the steps
    the first did not, to the unbroken run's parameters bit for bit."""
    script = textwrap.dedent("""
        import json, sys, time
        import numpy as np
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.resilience import PreemptedError

        ckpt_dir, out_path, slow = sys.argv[1], sys.argv[2], sys.argv[3]
        np.random.seed(5)
        rng = np.random.RandomState(3)
        X = rng.rand(64, 6).astype(np.float32)
        y = (rng.rand(64) * 4).astype(np.float32)
        it = mx.io.NDArrayIter(X, y, batch_size=8, shuffle=True,
                               label_name="softmax_label")
        data = mx.sym.Variable("data")
        net = mx.sym.SoftmaxOutput(
            mx.sym.FullyConnected(data, num_hidden=4, name="fc"),
            name="softmax")
        mod = mx.mod.Module(net, context=mx.cpu())
        steps = [0]
        def cb(param):
            steps[0] += 1
            print("STEP %d" % steps[0], flush=True)
            if slow == "1":
                time.sleep(0.15)
        try:
            mod.fit(it, num_epoch=4, optimizer="sgd",
                    optimizer_params=(("learning_rate", 0.1),
                                      ("momentum", 0.9)),
                    initializer=mx.init.Uniform(0.3),
                    batch_end_callback=cb,
                    resume=None if ckpt_dir == "-" else ckpt_dir)
        except PreemptedError:
            sys.exit(43)
        args, _ = mod.get_params()
        with open(out_path, "w") as f:
            json.dump({"steps": steps[0],
                       "params": {k: v.asnumpy().tolist()
                                  for k, v in args.items()}}, f)
    """)
    script_path = tmp_path / "train.py"
    script_path.write_text(script)
    ckpt_dir = str(tmp_path / "ckpts")
    env = dict(os.environ, PYTHONPATH=_REPO)
    full_path, out_path = str(tmp_path / "full.json"), \
        str(tmp_path / "out.json")
    subprocess.run([sys.executable, str(script_path), "-", full_path, "0"],
                   timeout=100, env=env, check=True,
                   stdout=subprocess.DEVNULL)

    proc = subprocess.Popen(
        [sys.executable, str(script_path), ckpt_dir, out_path, "1"],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        seen = 0
        for line in proc.stdout:
            if line.startswith("STEP"):
                seen += 1
                if seen == 3:
                    proc.send_signal(signal.SIGTERM)
                    break
        proc.stdout.read()
        assert proc.wait(timeout=60) == 43   # PreemptedError exit
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    state = ckpt.load_latest(ckpt_dir)
    assert state is not None and state.step >= 3

    subprocess.run([sys.executable, str(script_path), ckpt_dir, out_path,
                    "0"], timeout=100, env=env, check=True,
                   stdout=subprocess.DEVNULL)
    with open(out_path) as f:
        result = json.load(f)
    with open(full_path) as f:
        full = json.load(f)
    assert result["steps"] == 32 - state.step
    assert full["steps"] == 32
    for k, v in full["params"].items():
        np.testing.assert_array_equal(np.asarray(result["params"][k]),
                                      np.asarray(v), err_msg=k)


def test_fit_resume_replays_shuffled_data_order(tmp_path):
    """tests/test_runtime_io.py's case on the port's StreamingIter: the
    resumed run replays the exact remaining batch sequence (shuffle order
    included, the JAX package's sequence) and lands on identical
    parameters."""
    from mxnet_tpu_torch.runtime import StreamingIter

    rng = np.random.RandomState(0)
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = tmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(24):
        img = rng.randint(0, 255, (8, 8, 3)).astype(np.uint8)
        w.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i), i, 0), img, img_fmt=".png"))
    w.close()

    def mlp(mx):
        x = mx.sym.Variable("data")
        x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=3,
                                  name="fc")
        return mx.sym.SoftmaxOutput(x, name="softmax")

    def fit(mx, make_iter, resume=None, interrupt_at=None, trace=None):
        np.random.seed(7)
        it = make_iter()
        count = [0]

        def cb(p):
            count[0] += 1
            lab = p.locals["data_batch"].label[0].asnumpy()
            trace.append(tuple(lab.astype(int).tolist()))
            if interrupt_at is not None and count[0] == interrupt_at:
                os.kill(os.getpid(), signal.SIGTERM)

        mod = mx.mod.Module(mlp(mx), context=mx.cpu())
        try:
            mod.fit(it, num_epoch=3, optimizer="sgd",
                    optimizer_params=(("learning_rate", 0.1),),
                    initializer=mx.init.Uniform(0.3),
                    batch_end_callback=cb, resume=resume)
        finally:
            it.close()
        return {k: v.asnumpy().copy()
                for k, v in mod.get_params()[0].items()}

    def port_iter():
        return StreamingIter(path_imgrec=rec, path_imgidx=idx,
                             data_shape=(3, 8, 8), batch_size=4,
                             shuffle=True, seed=5, decode_workers=2,
                             decode_backend="thread", device=tmx.cpu())

    def jax_iter():
        from mxnet_tpu.runtime import StreamingIter as JIter

        return JIter(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 8, 8),
                     batch_size=4, shuffle=True, seed=5, decode_workers=2,
                     decode_backend="thread")

    t_full, t_jax = [], []
    full = fit(tmx, port_iter, trace=t_full)
    jfull = fit(jmx, jax_iter, trace=t_jax)
    assert t_full == t_jax
    for k in full:
        np.testing.assert_allclose(full[k], jfull[k], **_FIT_TOL)
    ckpt_dir = str(tmp_path / "ckpts")
    t_int, t_res = [], []
    with pytest.raises(PreemptedError):
        fit(tmx, port_iter, resume=ckpt_dir, interrupt_at=9, trace=t_int)
    np.random.seed(999)
    resumed = fit(tmx, port_iter, resume=ckpt_dir, trace=t_res)
    assert t_int + t_res == t_full
    for k in full:
        np.testing.assert_array_equal(full[k], resumed[k])


# -------------------------------------------------- checkpoints across packages

def _dyadic_fit(mx, directory):
    """A fit whose every value is a dyadic rational of a few bits, so no
    operation of either package rounds: a linear regression on inputs in
    {-1, 0, 1} from weights in halves, SGD 0.25 with momentum 0.5 and
    rescale 1/4. SIGTERM after the 3rd of 4 steps writes the
    checkpoint."""
    rng = np.random.RandomState(0)
    X = rng.randint(-1, 2, (8, 4)).astype(np.float32)
    y = rng.randint(-2, 3, (8, 2)).astype(np.float32)
    w = (rng.randint(-2, 3, (2, 4)) / 2.0).astype(np.float32)
    b = (rng.randint(-2, 3, (2,)) / 2.0).astype(np.float32)
    data = mx.sym.Variable("data")
    net = mx.sym.LinearRegressionOutput(
        mx.sym.FullyConnected(data, num_hidden=2, name="fc"), name="lro")
    np.random.seed(4)
    it = mx.io.NDArrayIter(X, y, batch_size=4, shuffle=True,
                           label_name="lro_label")
    mod = mx.mod.Module(net, context=mx.cpu(), label_names=["lro_label"])
    with pytest.raises(mx.resilience.PreemptedError):
        mod.fit(it, num_epoch=2, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.25),
                                  ("momentum", 0.5)),
                arg_params={"fc_weight": mx.nd.array(w, ctx=mx.cpu()),
                            "fc_bias": mx.nd.array(b, ctx=mx.cpu())},
                eval_metric="mse", batch_end_callback=_preempt_at(3),
                resume=directory)
    return jckpt.load_latest(directory) if mx is jmx \
        else ckpt.load_latest(directory)


def test_checkpoint_files_equal_the_jax_packages_byte_for_byte(tmp_path):
    jstate = _dyadic_fit(jmx, str(tmp_path / "jax"))
    tstate = _dyadic_fit(tmx, str(tmp_path / "port"))
    assert (tstate.epoch, tstate.batch, tstate.step) == \
        (jstate.epoch, jstate.batch, jstate.step) == (1, 1, 3)
    rng = np.random.RandomState(0)
    rng.randint(-1, 2, (8, 4)), rng.randint(-2, 3, (8, 2))
    w0 = rng.randint(-2, 3, (2, 4)) / 2.0
    assert not np.array_equal(tstate.arg_params["fc_weight"].asnumpy(),
                              w0)   # the three steps moved the weights
    jfiles, tfiles = jstate.meta["files"], tstate.meta["files"]
    for name in ("params.ndarray", "optimizer.states", "iterator.json"):
        with open(os.path.join(jstate.path, name), "rb") as a, \
                open(os.path.join(tstate.path, name), "rb") as b:
            assert a.read() == b.read(), name
        assert jfiles[name] == tfiles[name], name
    # the random state is each package's own, and so is its file name
    assert "rng.npy" in jfiles and ckpt.RNG_FILE not in jfiles
    assert ckpt.RNG_FILE in tfiles and "rng.npy" not in tfiles
    # the manifest schema is the JAX package's
    assert sorted(jstate.meta) == sorted(tstate.meta)
    # each package loads the other's checkpoint
    for loader, state in ((jckpt.load_latest, tstate),
                          (ckpt.load_latest, jstate)):
        other = loader(os.path.dirname(state.path))
        assert (other.epoch, other.batch, other.step) == (1, 1, 3)
        assert other.iterator_state == state.iterator_state
        assert sorted(other.arg_params) == ["fc_bias", "fc_weight"]


def test_port_resumes_from_a_jax_checkpoint(tmp_path, caplog):
    """The JAX package is preempted at its 5th step; the port resumes
    from its checkpoint to the end, within 1e-5 of the JAX package's
    unbroken run, with one warning that the random stream does not
    carry across packages."""
    jfull = _fit_params(jmx, shuffle=True)
    with pytest.raises(jmx.resilience.PreemptedError):
        _fit_params(jmx, resume=str(tmp_path), shuffle=True,
                    batch_end_callback=_preempt_at(5))
    assert "rng.npy" in jckpt.load_latest(str(tmp_path)).meta["files"]
    np.random.seed(321)
    with caplog.at_level(logging.WARNING):
        resumed = _fit_params(tmx, resume=str(tmp_path), shuffle=True)
    warned = [r for r in caplog.records
              if "random stream does not carry across packages"
              in r.getMessage()]
    assert len(warned) == 1
    for k in jfull:
        np.testing.assert_allclose(resumed[k], jfull[k], **_FIT_TOL)


def test_restore_rng_round_trip():
    tmx.random.seed(3)
    state = tmx.random.get_state()
    a = tmx.nd.random.uniform(shape=(4,), ctx=tmx.cpu()).asnumpy()
    ckpt.restore_rng([s.clone() for s in state])
    b = tmx.nd.random.uniform(shape=(4,), ctx=tmx.cpu()).asnumpy()
    np.testing.assert_array_equal(a, b)
    ckpt.restore_rng(None)   # no random state: nothing to do
