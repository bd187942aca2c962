"""Port parity for the optimizers ported last: ccSGD, DCASGD, SGLD, Adamax,
Nadam and Test, against the JAX package's on the CPU, on the eager update
path (``Updater``, ``Module.update`` and ``gluon.Trainer.step``):

- 3 ``Trainer.step`` updates of a Dense net (through the updaters: these
  are not in ``Trainer._FUSABLE``), and 3 ``Module`` steps of an MLP:
  losses, weights and optimizer states within 1e-5;
- SGLD draws its noise from its own stream, which differs between the
  packages: its drift against the JAX package's, its noise by the mean
  and variance over 2**16 values (within 5 standard errors of 0 and lr);
- Nadam's ``m_schedule`` is one float shared by all parameters, advanced
  on each parameter's update: after 4 steps of 4 parameters it and every
  weight equal the JAX package's, so the update order is the same;
- an ``Updater``'s pickled states (``mxtpu_v2``, with Nadam's
  ``m_schedule`` and SGLD's draw counter) load across the packages;
- ``compile_step`` refuses all of them, as the JAX package's does.
"""
import pickle

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_gluon_trainer import _close, _ctx, _eager_steps

CPU = tmx.cpu()

OPTIMIZERS = [
    ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("dcasgd", {"learning_rate": 0.1, "lamda": 0.5}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
                "clip_gradient": 0.05}),
    ("adamax", {"learning_rate": 0.01, "wd": 1e-3}),
    ("adamax", {"learning_rate": 0.01, "clip_gradient": 0.05}),
    ("nadam", {"learning_rate": 0.01, "wd": 1e-3}),
    ("nadam", {"learning_rate": 0.01, "clip_gradient": 0.05,
               "schedule_decay": 0.01}),
    ("test", {}),
]
_IDS = ["%s-%s" % (o, "-".join(sorted(k))) for o, k in OPTIMIZERS]


@pytest.mark.parametrize("opt,kw", OPTIMIZERS, ids=_IDS)
def test_trainer_step_matches_the_jax_trainer(opt, kw):
    want = _eager_steps(jmx, opt, kw)
    with tmx.cpu():
        got = _eager_steps(tmx, opt, kw)
    _close(got, want)


def _module_steps(mx, opt, kw, n=3):
    d = mx.sym.var("data")
    net = mx.sym.FullyConnected(d, num_hidden=6, name="fc1")
    net = mx.sym.Activation(net, act_type="tanh")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(0)
    args = {"fc1_weight": rng.randn(6, 5) * 0.3, "fc1_bias": rng.randn(6),
            "fc2_weight": rng.randn(3, 6) * 0.3, "fc2_bias": rng.randn(3)}
    ctx = CPU if mx is tmx else mx.cpu()
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", (4, 5))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(arg_params={k: mx.nd.array(v.astype(np.float32),
                                               **_ctx(mx))
                                for k, v in args.items()})
    mod.init_optimizer(optimizer=opt, optimizer_params=dict(kw))
    outs = []
    for i in range(n):
        r = np.random.RandomState(10 + i)
        batch = mx.io.DataBatch(
            [mx.nd.array(r.randn(4, 5).astype(np.float32), **_ctx(mx))],
            [mx.nd.array(r.randint(0, 3, 4).astype(np.float32),
                         **_ctx(mx))])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    arg, _aux = mod.get_params()
    return outs, {k: v.asnumpy() for k, v in arg.items()}


@pytest.mark.parametrize("opt,kw", [OPTIMIZERS[i] for i in (0, 2, 3, 5, 7)],
                         ids=[_IDS[i] for i in (0, 2, 3, 5, 7)])
def test_module_update_matches_the_jax_module(opt, kw):
    want = _module_steps(jmx, opt, kw)
    with tmx.cpu():
        got = _module_steps(tmx, opt, kw)
    _close(got, want)


def _updater_run(mx, opt, kw, n_params=4, n_steps=4, seed=1):
    """``n_steps`` rounds of an Updater over ``n_params`` weights in index
    order: (weights, states, the optimizer)."""
    o = mx.optimizer.create(opt, **kw)
    upd = mx.optimizer.get_updater(o)
    rng = np.random.RandomState(seed)
    ws = [mx.nd.array(rng.randn(3, 4).astype(np.float32), **_ctx(mx))
          for _ in range(n_params)]
    for step in range(n_steps):
        for i, w in enumerate(ws):
            g = np.random.RandomState(100 * step + i).randn(3, 4)
            upd(i, mx.nd.array(g.astype(np.float32), **_ctx(mx)), w)
    return [w.asnumpy() for w in ws], upd, o


def test_nadam_shared_schedule_follows_the_update_order():
    kw = {"learning_rate": 0.05, "schedule_decay": 0.05}
    jw, _ju, jo = _updater_run(jmx, "nadam", kw)
    with tmx.cpu():
        tw, _tu, to = _updater_run(tmx, "nadam", kw)
    # one float multiplied on each of the 16 updates
    assert to.m_schedule == jo.m_schedule
    assert to.m_schedule < 0.9 ** 4
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # another order gives another schedule per parameter: the result
    # depends on the order
    with tmx.cpu():
        o = tmx.optimizer.create("nadam", **kw)
        upd = tmx.optimizer.get_updater(o)
        w = [tmx.nd.array(np.ones((2,), np.float32)) for _ in range(2)]
        for i in (0, 0, 1, 1):
            upd(i, tmx.nd.array(np.ones((2,), np.float32)), w[i])
    assert not np.array_equal(w[0].asnumpy(), w[1].asnumpy())


def test_sgld_drift_matches_and_noise_has_the_right_moments():
    lr, n = 0.01, 1 << 16
    for mx in (jmx, tmx):
        o = mx.optimizer.create("sgld", learning_rate=lr, seed=3)
        upd = mx.optimizer.get_updater(o)
        w0 = np.zeros(n, np.float32)
        w = mx.nd.array(w0, **_ctx(mx))
        upd(0, mx.nd.array(np.zeros(n, np.float32), **_ctx(mx)), w)
        noise = w.asnumpy().astype(np.float64)
        se_mean, se_var = np.sqrt(lr / n), lr * np.sqrt(2.0 / n)
        assert abs(noise.mean()) <= 5 * se_mean
        assert abs(noise.var() - lr) <= 5 * se_var
        assert o._noise_draws == 1
    # the drift, -lr/2 * (grad + wd * w) = -0.5 here, against noise of
    # std sqrt(lr) = 1e-4: equal within 10 of its standard deviations
    outs = []
    for mx in (jmx, tmx):
        o = mx.optimizer.create("sgld", learning_rate=1e-8, wd=0.1)
        w = mx.nd.array(np.ones(64, np.float32), **_ctx(mx))
        mx.optimizer.get_updater(o)(
            0, mx.nd.array(np.full(64, 1e8, np.float32), **_ctx(mx)), w)
        outs.append(w.asnumpy())
    np.testing.assert_allclose(outs[1], 0.5, atol=1e-3)
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-3)


def test_sgld_stream_is_seeded_and_resumes():
    def draws(seed, skip=0):
        o = tmx.optimizer.create("sgld", learning_rate=1.0, seed=seed)
        o._noise_draws = skip
        w = tmx.nd.array(np.zeros(16, np.float32), ctx=CPU)
        tmx.optimizer.get_updater(o)(
            0, tmx.nd.array(np.zeros(16, np.float32), ctx=CPU), w)
        return w.asnumpy()
    np.testing.assert_array_equal(draws(5), draws(5))
    assert not np.array_equal(draws(5), draws(6))
    assert not np.array_equal(draws(5), draws(5, skip=1))


@pytest.mark.parametrize("src,dst", [(jmx, tmx), (tmx, jmx)],
                         ids=["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("opt", ["nadam", "adamax", "dcasgd", "sgld"])
def test_updater_states_load_across_packages(src, dst, opt):
    kw = {"learning_rate": 0.05}
    if opt == "dcasgd":
        kw["momentum"] = 0.9
    with tmx.cpu():
        _w, upd, o = _updater_run(src, opt, kw, n_params=2, n_steps=2)
        blob = upd.get_states()
        o2 = dst.optimizer.create(opt, **kw)
        upd2 = dst.optimizer.get_updater(o2)
        upd2.set_states(blob)
    obj = pickle.loads(blob)
    assert obj["__format__"] == "mxtpu_v2"
    assert o2._index_update_count == o._index_update_count
    if opt == "nadam":
        assert o2.m_schedule == o.m_schedule
    if opt == "sgld":
        assert o2._noise_draws == o._noise_draws == 4
    for i, st in upd.states.items():
        flat = [s for s in (st if isinstance(st, (tuple, list)) else (st,))
                if s is not None]
        got = [s for s in (upd2.states[i] if isinstance(
            upd2.states[i], (tuple, list)) else (upd2.states[i],))
            if s is not None]
        for a, b in zip(got, flat):
            np.testing.assert_array_equal(np.asarray(a), b.asnumpy())
    # and the loaded updater steps on
    with tmx.cpu():
        w = dst.nd.array(np.ones((3, 4), np.float32), **_ctx(dst))
        upd2(0, dst.nd.array(np.ones((3, 4), np.float32), **_ctx(dst)), w)
    assert np.isfinite(w.asnumpy()).all()


@pytest.mark.parametrize("opt", ["dcasgd", "sgld", "adamax", "nadam",
                                 "test"])
def test_compile_step_refuses_them_as_the_reference(opt):
    for mx in (jmx, tmx):
        nn = mx.gluon.nn
        net = nn.Dense(2, in_units=3)
        net.initialize(**_ctx(mx))
        tr = mx.gluon.Trainer(net.collect_params(), opt, {},
                              kvstore=None)
        step = tr.compile_step(net, mx.gluon.loss.L2Loss())
        x = mx.nd.ones((4, 3), **_ctx(mx))
        with pytest.raises(ValueError):
            step(x, mx.nd.ones((4, 2), **_ctx(mx)))
    assert opt not in {n.lower() for n in tmx.gluon.Trainer._FUSABLE}


def test_exports_match_the_reference():
    for name in ("ccSGD", "DCASGD", "SGLD", "Adamax", "Nadam", "Test"):
        assert getattr(tmx.optimizer, name).__name__ == name
        assert name.lower() in tmx.optimizer.Optimizer.opt_registry
    assert set(tmx.optimizer.__all__) == set(jmx.optimizer.__all__)
