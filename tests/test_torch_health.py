"""The port's training-health layer (observability/health.py) against the
JAX package's, on the CPU.

* the segmented reduction: per tensor the non-finite count (exact, an
  integer), the finite-masked sum of squares and sum (1e-5 relative) equal
  to the JAX package's fused ``_stats_impl`` on the same numpy tensors,
  fp32 and bf16, at several sizes and with NaN / Inf planted (the card
  kernel against this plain version: ``tests/test_torch_cuda.py``);
* the policies: off is a no-op, warn fetches one step late and keeps the
  step's attribution, raise raises on the step, skip_step withholds the
  update in ``Module.fit``, ``Trainer.step`` and ``compile_step`` (every
  parameter bit-identical), and degrades to warn under dist_sync;
* the flight recorder's step records, the executor's ``health_check``,
  the gauges, and the compile count (captures + kernel builds).
"""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.observability import health as jhealth
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd
from mxnet_tpu_torch.observability import (TrainingHealthError,
                                           flight_recorder, health,
                                           instruments)
from mxnet_tpu_torch.observability import metrics as tmetrics


@pytest.fixture
def health_mode(tmp_path):
    """Arm a policy with an isolated dump dir; restore off afterwards."""
    def arm(policy):
        health.set_policy(policy)
        flight_recorder.reset()
        flight_recorder.configure(ring=64, dump_dir=str(tmp_path))
        return tmp_path

    yield arm
    health.flush(allow_dump=False)
    health.set_policy(None)
    flight_recorder.reset()


# ------------------------------------------------ the reduction, both packages

def _planted(rng, shape, n_nan=0, n_inf=0):
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.permutation(flat.size)
    flat[idx[:n_nan]] = np.nan
    flat[idx[n_nan:n_nan + n_inf]] = np.inf * rng.choice([-1, 1], n_inf)
    return x


def _tensors(seed):
    rng = np.random.RandomState(seed)
    return [
        _planted(rng, (3,)),                       # tiny
        _planted(rng, (2048,), n_nan=1),
        _planted(rng, (2049,), n_inf=2),
        _planted(rng, (64, 513), n_nan=3, n_inf=4),
        _planted(rng, (7, 3, 5)),
        _planted(rng, (100000,), n_nan=17),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_stats_equal_to_jax(dtype, seed):
    arrs = _tensors(seed)
    jstats = np.asarray(jhealth._stats_impl(
        [jnp.asarray(a).astype(dtype) for a in arrs]), np.float64)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tstats = health._fused_stats(
        [torch.from_numpy(a).to(tdt) for a in arrs])
    assert tstats.shape == (len(arrs), 3)
    # the bad count is an integer sum: exact
    assert np.array_equal(tstats[:, 0], jstats[:, 0])
    assert list(tstats[:, 0]) == [0, 1, 2, 7, 0, 17]
    np.testing.assert_allclose(tstats[:, 1], jstats[:, 1], rtol=1e-5)
    # a sum of signed terms: its rounding is relative to the terms' scale
    np.testing.assert_allclose(tstats[:, 2], jstats[:, 2], rtol=1e-5,
                               atol=1e-5 * float(np.sqrt(jstats[:, 1]).max()))


def test_stats_mixed_dtypes_keep_input_order():
    arrs = _tensors(2)
    mixed = [torch.from_numpy(a).to(torch.bfloat16 if i % 2 else
                                    torch.float32)
             for i, a in enumerate(arrs)]
    got = health._fused_stats(mixed)
    for i, t in enumerate(mixed):
        alone = health._fused_stats([t])[0]
        assert np.array_equal(got[i], alone)


def test_stats_plan_reused_across_steps():
    arrs = [torch.from_numpy(a) for a in _tensors(3)]
    health._plans.clear()
    health._fused_stats(arrs)
    got = health._fused_stats([a * 2 for a in arrs])
    assert len(health._plans) == 1
    # a second step's stats are its own
    health._plans.clear()
    assert np.array_equal(got, health._fused_stats([a * 2 for a in arrs]))
    # new shapes under the same names: a new plan
    health._fused_stats([a[:1] for a in arrs])
    assert len(health._plans) == 1


# ------------------------------------------------------------------ policy
def _toy_fit(nan_batch=None, num_batches=3, bs=4):
    """Module fit over the first ``num_batches`` of 3 fixed batches;
    ``nan_batch`` poisons that batch's data."""
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=4, name="fc")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    x = rng.rand(bs * 3, 6).astype(np.float32)
    if nan_batch is not None:
        x[nan_batch * bs:(nan_batch + 1) * bs] = np.nan
    y = rng.randint(0, 4, bs * 3).astype(np.float32)
    x, y = x[:bs * num_batches], y[:bs * num_batches]
    np.random.seed(0)   # Xavier draws from numpy's global generator
    with mx.cpu():
        it = mx.io.NDArrayIter(x, y, batch_size=bs,
                               label_name="softmax_label")
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.fit(it, num_epoch=1, optimizer="sgd",
                initializer=mx.init.Xavier(),
                optimizer_params=(("learning_rate", 0.1),))
    return mod


def test_policy_resolution_and_validation(health_mode):
    health_mode("warn")
    assert health.policy() == "warn" and health.active()
    health.set_policy("off")
    assert not health.active()
    with pytest.raises(ValueError):
        health.set_policy("panic")


def test_off_policy_is_noop(health_mode):
    health_mode("off")
    with mx.cpu():
        v = health.guard_step("test", losses=[("l", mx.nd.array([np.nan]))])
    assert v is None
    assert flight_recorder.snapshot() == []


def test_check_stats_and_first_bad_order(health_mode):
    health_mode("warn")
    with mx.cpu():
        loss = mx.nd.array(np.array([1.0, 3.0], np.float32))
        g_ok = mx.nd.array(np.array([3.0, 4.0], np.float32))
        g_bad = mx.nd.array(np.array([np.inf, 1.0], np.float32))
        w = mx.nd.array(np.array([0.0, 2.0], np.float32))
        ints = mx.nd.array(np.array([1, 2]), dtype=np.int32)
    v = health.check(losses=[("loss", loss)],
                     grads=[("g_ok", g_ok), ("g_bad", g_bad), ("i", ints)],
                     params=[("w", w)], lr=0.5, step=7)
    assert not v.ok
    assert v.first_bad == "grad:g_bad"
    assert dict(v.bad) == {"grad:g_bad": 1}
    assert v.loss == pytest.approx(2.0)
    assert v.grad_norm == pytest.approx(np.sqrt(25.0 + 1.0))
    assert v.param_norm == pytest.approx(2.0)
    assert v.update_ratio == pytest.approx(0.5 * v.grad_norm / 2.0, rel=1e-5)


def test_warn_mode_lag1_fetch_keeps_attribution(health_mode):
    health_mode("warn")
    with mx.cpu():
        good = mx.nd.array(np.ones(3, np.float32))
        bad = mx.nd.array(np.array([np.nan, 1.0, 1.0], np.float32))
    assert health.guard_step("t", losses=[("l", good)], step=1) is None
    v1 = health.guard_step("t", losses=[("l", bad)], step=2)
    assert v1 is not None and v1.ok and v1.step == 1
    v2 = health.flush()
    assert not v2.ok and v2.step == 2 and v2.first_bad == "loss:l"
    assert v2.dump_path
    assert [r["step"] for r in flight_recorder.snapshot()] == [1, 2]


def test_module_fit_nan_detected_on_the_step(health_mode):
    tmp = health_mode("warn")
    _toy_fit(nan_batch=1)
    recs = flight_recorder.snapshot()
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert recs[0]["ok"] and not recs[1]["ok"]
    assert recs[1]["first_bad"] == "loss:softmax_output"
    assert any(name == "grad:fc_weight" for name, _c in recs[1]["bad"])
    assert recs[0]["grad_norm"] > 0 and recs[0]["wall_ms"] > 0
    assert recs[0]["hbm_bytes"] > 0        # VmHWM on the CPU
    dump = flight_recorder.last_dump_path()
    assert dump and dump.startswith(str(tmp))
    payload = json.load(open(dump))
    assert payload["fingerprint"]["torch"]["version"]
    assert payload["reason"].startswith("anomaly:module.fit")


def test_module_fit_raise_policy(health_mode):
    health_mode("raise")
    with pytest.raises(TrainingHealthError) as err:
        _toy_fit(nan_batch=1)
    assert err.value.verdict.step == 2
    from mxnet_tpu_torch.observability import perf

    assert not perf.step_active()   # the scope did not dangle


def test_module_fit_skip_step_keeps_params_bit_identical(health_mode):
    health_mode("skip_step")
    mod = _toy_fit(nan_batch=2)   # the last step is the bad one
    recs = flight_recorder.snapshot()
    assert [r["skipped"] for r in recs] == [False, False, True]
    health_mode("off")
    ref = _toy_fit(nan_batch=None, num_batches=2)
    got, _ = mod.get_params()
    want, _ = ref.get_params()
    for k in want:
        assert np.array_equal(got[k].asnumpy(), want[k].asnumpy()), k


# -------------------------------------------------- gluon trainer paths
def _gluon_pair():
    net = mx.gluon.nn.Dense(3)
    net.initialize(ctx=mx.cpu())
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore=None)
    x = mx.nd.array(np.random.RandomState(0).rand(2, 5).astype(np.float32),
                    ctx=mx.cpu())
    y = mx.nd.array(np.array([0, 2], np.float32), ctx=mx.cpu())
    return net, loss_fn, trainer, x, y


def _snapshot(net):
    return {k: p.data().asnumpy().copy()
            for k, p in net.collect_params().items()}


def test_gluon_eager_skip_step(health_mode):
    health_mode("skip_step")
    with mx.cpu():
        net, loss_fn, trainer, x, y = _gluon_pair()
        with autograd.record():
            loss_fn(net(x), y).backward()
        trainer.step(2)
        before = _snapshot(net)
        bad = mx.nd.array(np.full((2, 5), np.nan, np.float32))
        with autograd.record():
            loss_fn(net(bad), y).backward()
        trainer.step(2)
    for k, now in _snapshot(net).items():
        assert np.array_equal(now, before[k])
    wheres = {r["where"] for r in flight_recorder.snapshot()}
    assert "autograd.backward" in wheres and "gluon.trainer" in wheres


def test_gluon_raise_policy_fires_in_backward(health_mode):
    health_mode("raise")
    with mx.cpu():
        net, loss_fn, _trainer, _x, y = _gluon_pair()
        bad = mx.nd.array(np.full((2, 5), np.nan, np.float32))
        with autograd.record():
            loss = loss_fn(net(bad), y)
        with pytest.raises(TrainingHealthError) as err:
            loss.backward()
    assert err.value.verdict.first_bad.startswith("loss:")
    assert flight_recorder.last_dump_path()


@pytest.mark.parametrize("policy", ["skip_step", "raise"])
def test_compile_step_bad_step_keeps_state_bit_identical(health_mode,
                                                         policy):
    health_mode(policy)
    with mx.cpu():
        net = mx.gluon.nn.Dense(3)
        net.initialize(ctx=mx.cpu())
        net.hybridize()
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9},
                                   kvstore=None)
        step = trainer.compile_step(net, loss_fn)
        x = mx.nd.array(np.random.RandomState(1).rand(2, 5)
                        .astype(np.float32))
        y = mx.nd.array(np.array([0, 2], np.float32))
        step(x, y).asnumpy()
        before = _snapshot(net)
        states = {i: [a.asnumpy().copy() for a in mx.optimizer.flat_state(s)]
                  for i, s in trainer._updaters[0].states.items()}
        bad = mx.nd.array(np.full((2, 5), np.nan, np.float32))
        if policy == "raise":
            with pytest.raises(TrainingHealthError):
                step(bad, y)
        else:
            step(bad, y).asnumpy()
        for k, now in _snapshot(net).items():
            assert np.array_equal(now, before[k]), k
        for i, s in trainer._updaters[0].states.items():
            for a, b in zip(mx.optimizer.flat_state(s), states[i]):
                assert np.array_equal(a.asnumpy(), b)
        if policy == "skip_step":
            assert np.isfinite(step(x, y).asnumpy()).all()
            assert step.compile_count == 1
            skipped = [r for r in flight_recorder.snapshot()
                       if r.get("skipped")]
            assert len(skipped) == 1
            assert skipped[0]["first_bad"] == "loss:loss"


def test_skip_step_degrades_to_warn_under_dist_sync(health_mode):
    import types

    health_mode("skip_step")
    with mx.cpu():
        net, loss_fn, trainer, _x, y = _gluon_pair()
        bad = mx.nd.array(np.full((2, 5), np.nan, np.float32))
        with autograd.record():
            loss_fn(net(bad), y).backward()
    trainer._kv_initialized = True
    trainer._kvstore = types.SimpleNamespace(type="dist_sync")
    v = trainer._health_check(0.0)
    assert v is not None and not v.ok and not v.skip
    trainer._kvstore = types.SimpleNamespace(type="dist_async")
    assert trainer._health_check(0.0).skip
    trainer._kvstore = None
    assert trainer._health_check(0.0).skip


def test_executor_health_check_names_tensor(health_mode):
    health_mode("warn")
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    ex = net.simple_bind(mx.cpu(), data=(2, 4))
    rng = np.random.RandomState(0)
    for v in ex.arg_dict.values():
        v[:] = rng.rand(*v.shape).astype(np.float32)
    ex.arg_dict["data"][:] = np.full((2, 4), np.nan, np.float32)
    ex.forward(is_train=True)
    ex.backward()
    v = ex.health_check()
    assert v is not None and not v.ok
    assert v.first_bad == "loss:fc_output"
    assert any(name.startswith("grad:fc_") for name, _c in v.bad)


def test_health_gauges_under_telemetry(health_mode):
    health_mode("warn")
    tmetrics.set_enabled(True)
    tmetrics.reset_metrics()
    try:
        with mx.cpu():
            g = mx.nd.array(np.array([3.0, 4.0], np.float32))
            w = mx.nd.array(np.array([1.0, 0.0], np.float32))
        assert health.guard_step("test", grads=[("g", g)],
                                 params=[("w", w)], lr=0.1, step=1) is None
        v = health.flush()
        assert v is not None and v.step == 1 and v.ok
        assert tmetrics.get_value("health.checks") == 1
        assert tmetrics.get_value("health.grad_norm") == pytest.approx(5.0)
        assert tmetrics.get_value("health.update_ratio") == \
            pytest.approx(0.5, rel=1e-5)
    finally:
        tmetrics.reset_metrics()
        tmetrics.set_enabled(False)


def test_compiles_count_captures_and_kernel_builds(health_mode):
    health_mode("warn")
    before = health.compiles()
    instruments.note_capture(("step", (2, 5)), 0.01)
    instruments.note_kernel_build("fused_matmul", 1.5, True)
    assert health.compiles() == before + 2
    assert instruments.retrace_causes()[-1] == str(("step", (2, 5)))
    with mx.cpu():
        health.guard_step("t", losses=[("l", mx.nd.array([1.0]))], step=1)
    health.flush()
    assert flight_recorder.snapshot()[-1]["compiles"] == before + 2
