"""Port parity for ``gluon.Trainer`` and ``Trainer.compile_step``
(mxnet_tpu_torch/gluon/trainer.py) against the JAX package's, on the CPU.

- ``Trainer.step`` with each of the seven optimizers the JAX trainer fuses
  (``Trainer._FUSABLE``), fused and through the updaters, 3 steps of a
  Dense net: loss, weights and optimizer states within 1e-5.
- ``compile_step`` against the eager tape (``record`` / ``backward`` /
  ``step``) and against the JAX package's ``compile_step``, within 1e-5;
  a learning-rate change (and a schedule) captures nothing new.
- ``resnet18_v1(classes=10)`` at 32x32, batch 4: the first forward (in
  predict mode, as chip_smoke.py holds it on the card) within 1e-5, and
  two training steps, eager and compiled, each from the JAX trainer's
  state, within 1e-2 of each tensor's max |value| (the
  BatchNorm-behind-ReLU bar of test_torch_resnet_train.py: XLA and torch
  sum a channel in another order, and a ReLU input near 0 opens in one
  package only). At 32x32 the last stage's BatchNorms normalise 4 values
  a channel: the first step's gradients agree within ~3e-4 of their max,
  but a second step taken from the two packages' own first steps moves
  some parameters by several percent, so each step starts from the same
  state.
- ``compile_step`` refuses kvstore training, leaves frozen parameters
  alone and draws a new Dropout mask each step.

On the CPU the compiled step is its body run eagerly; its CUDA graph is
held to that body on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = tmx.cpu()

OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
    ("nag", {"learning_rate": 0.05}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3, "clip_gradient": 0.05}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("adagrad", {"learning_rate": 0.1, "wd": 1e-3}),
    ("adadelta", {"rho": 0.8, "clip_gradient": 0.1}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.001, "wd": 1e-3}),
]
_IDS = ["%s-%s" % (o, "-".join(sorted(k))) for o, k in OPTIMIZERS]


def _ctx(mx):
    return {"ctx": CPU} if mx is tmx else {}


def _mlp(mx, dropout=0.0):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(nn.Dense(16, activation="tanh", in_units=8))
        if dropout:
            net.add(nn.Dropout(dropout))
        net.add(nn.Dense(4, in_units=16))
    return net


def _batch(seed=0, n=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 8).astype(np.float32),
            rng.randint(0, 4, n).astype(np.float32))


def _init(mx, net, seed=0):
    np.random.seed(seed)
    net.initialize(mx.init.Xavier(), **_ctx(mx))


def _state(net, trainer):
    cut = len(net.prefix)
    out = {"w:" + k[cut:]: p.data().asnumpy()
           for k, p in net.collect_params().items()}
    for i, st in trainer._updaters[0].states.items():
        flat = st if isinstance(st, (tuple, list)) else (st,)
        for j, s in enumerate(flat):
            if s is not None:
                out["s:%d:%d" % (i, j)] = s.asnumpy()
    return out


def _eager_steps(mx, opt, kw, n_steps=3, fuse=True, net=None, dropout=0.0):
    net = net or _mlp(mx, dropout)
    _init(mx, net)
    tr = mx.gluon.Trainer(net.collect_params(), opt, dict(kw),
                          kvstore=None, fuse_step=fuse)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for i in range(n_steps):
        x, y = (mx.nd.array(a, **_ctx(mx)) for a in _batch(i))
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(x.shape[0])
        losses.append(loss.asnumpy())
    return losses, _state(net, tr)


def _compiled_steps(mx, opt, kw, n_steps=3, net=None, hybrid=True):
    net = net or _mlp(mx)
    _init(mx, net)
    if hybrid:
        net.hybridize()
    tr = mx.gluon.Trainer(net.collect_params(), opt, dict(kw),
                          kvstore=None)
    step = tr.compile_step(net, mx.gluon.loss.SoftmaxCrossEntropyLoss())
    losses = []
    for i in range(n_steps):
        x, y = (mx.nd.array(a, **_ctx(mx)) for a in _batch(i))
        losses.append(step(x, y).asnumpy())
    return losses, _state(net, tr), step


def _close(got, want, **tol):
    g_losses, g_state = got[:2]
    w_losses, w_state = want[:2]
    for a, b in zip(g_losses, w_losses):
        np.testing.assert_allclose(a, b, **(tol or TOL))
    assert g_state.keys() == w_state.keys()
    for k in w_state:
        np.testing.assert_allclose(g_state[k], w_state[k], err_msg=k,
                                   **(tol or TOL))


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "updaters"])
@pytest.mark.parametrize("opt,kw", OPTIMIZERS, ids=_IDS)
def test_trainer_step_matches_the_jax_trainer(opt, kw, fuse):
    want = _eager_steps(jmx, opt, kw, fuse=fuse)
    with tmx.cpu():
        got = _eager_steps(tmx, opt, kw, fuse=fuse)
    _close(got, want)


@pytest.mark.parametrize("opt,kw", OPTIMIZERS, ids=_IDS)
def test_compile_step_matches_the_eager_tape_and_the_jax_step(opt, kw):
    with tmx.cpu():
        compiled = _compiled_steps(tmx, opt, kw)
        eager = _eager_steps(tmx, opt, kw)
    _close(compiled, eager)
    _close(compiled, _compiled_steps(jmx, opt, kw))
    assert compiled[2].compile_count == 1


def test_learning_rate_change_and_schedule_capture_nothing_new():
    sched = tmx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    jsched = jmx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    runs = []
    for mx, s in ((jmx, jsched), (tmx, sched)):
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            net = _mlp(mx)
            _init(mx, net)
            net.hybridize()
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1, "momentum": 0.9,
                                   "lr_scheduler": s}, kvstore=None)
            step = tr.compile_step(net,
                                   mx.gluon.loss.SoftmaxCrossEntropyLoss())
            losses = []
            for i, lr in enumerate((None, 0.05, None, 0.01)):
                if lr is not None:
                    tr.set_learning_rate(lr)
                x, y = (mx.nd.array(a, **_ctx(mx)) for a in _batch(i))
                losses.append(step(x, y).asnumpy())
            runs.append((losses, _state(net, tr)))
            if mx is tmx:
                assert step.compile_count == 1
    _close(runs[1], runs[0])


def _sync(jnet, jtr, net, tr):
    """The JAX net's parameters, aux states and optimizer states into the
    port's net and trainer."""
    tmx.gluon_params_from_jax(jnet, net)
    for i, st in jtr._updaters[0].states.items():
        tr._updaters[0].states[i]._set_data(
            tmx.nd.array(st.asnumpy(), ctx=CPU)._data)


def test_resnet18_first_forward_and_two_steps():
    rng = np.random.RandomState(0)
    x = rng.rand(4, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.float32)

    def make(mx):
        ctx = _ctx(mx)
        net = mx.gluon.model_zoo.vision.resnet18_v1(classes=10,
                                                    prefix="rn_")
        _init(mx, net)
        net.hybridize()
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9},
                              kvstore="local")
        return (net, tr, mx.nd.array(x, **ctx), mx.nd.array(y, **ctx),
                mx.gluon.loss.SoftmaxCrossEntropyLoss())

    def eager_step(mx, net, tr, data, label, loss_fn):
        with mx.autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        tr.step(4)
        return loss.asnumpy()

    jax = make(jmx)
    with tmx.cpu():
        eager, compiled = make(tmx), make(tmx)
        step = compiled[1].compile_step(compiled[0], compiled[4])
    # the first forward (predict mode) from the same initial weights
    first = jax[0](jax[2]).asnumpy()
    for port in (eager, compiled):
        tmx.gluon_params_from_jax(jax[0], port[0])
        with tmx.cpu():
            np.testing.assert_allclose(port[0](port[2]).asnumpy(), first,
                                       **TOL)
    for k in range(2):
        if k:
            # each step from the same state: at 32x32 the last stage's
            # BatchNorms see 4 values a channel, and the trajectory
            # amplifies the first step's rounding differences
            for port in (eager, compiled):
                _sync(jax[0], jax[1], port[0], port[1])
        want = (eager_step(jmx, *jax), _state(jax[0], jax[1]))
        with tmx.cpu():
            got = [(eager_step(tmx, *eager), _state(eager[0], eager[1])),
                   (step(compiled[2], compiled[3]).asnumpy(),
                    _state(compiled[0], compiled[1]))]
        for loss, state in got:
            assert np.abs(loss - want[0]).max() <= \
                1e-2 * np.abs(want[0]).max()
            assert state.keys() == want[1].keys()
            for name, b in want[1].items():
                err = np.abs(state[name] - b).max()
                assert err <= 1e-2 * np.abs(b).max(), (k, name, err)
    assert step.compile_count == 1


def test_compile_step_rejects_kvstore():
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(4, in_units=8)
        net.initialize()
        net.hybridize()
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore="device")
        tr._init_kvstore()
        assert tr._kvstore is None    # one local device needs no store
        tr._kvstore = tmx.kv.create("local")
        step = tr.compile_step(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss())
        with pytest.raises(ValueError, match="kvstore"):
            step(tmx.nd.ones((4, 8)), tmx.nd.zeros((4,)))


def test_compile_step_leaves_frozen_parameters_alone():
    with tmx.cpu():
        net = _mlp(tmx)
        _init(tmx, net)
        net.hybridize()
        frozen = list(net.collect_params().values())[0]
        frozen.grad_req = "null"
        before = frozen.data().asnumpy().copy()
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=None)
        step = tr.compile_step(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss())
        x, y = (tmx.nd.array(a) for a in _batch())
        step(x, y)
        step(x, y)
        np.testing.assert_array_equal(frozen.data().asnumpy(), before)
        assert net(x).shape == (8, 4)


def test_compile_step_draws_a_new_dropout_mask_each_step():
    with tmx.cpu():
        net = _mlp(tmx, dropout=0.5)
        _init(tmx, net)
        net.hybridize()
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.0}, kvstore=None)
        step = tr.compile_step(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss())
        x, y = (tmx.nd.array(a) for a in _batch())
        tmx.random.seed(0)
        losses = [step(x, y).asnumpy() for _ in range(3)]
        assert not np.array_equal(losses[0], losses[1])
        tmx.random.seed(0)
        np.testing.assert_array_equal(step(x, y).asnumpy(), losses[0])


def test_allreduce_grads_then_update_equals_step():
    runs = []
    with tmx.cpu():
        for split in (False, True):
            net = _mlp(tmx)
            _init(tmx, net)
            tr = tmx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.01})
            loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
            for i in range(2):
                x, y = (tmx.nd.array(a) for a in _batch(i))
                with tmx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                if split:
                    tr.allreduce_grads()
                    tr.update(8)
                else:
                    tr.step(8)
            runs.append(([loss.asnumpy()], _state(net, tr)))
    _close(runs[1], runs[0])


def test_save_and_load_states_across_packages(tmp_path):
    f = str(tmp_path / "adam.states")
    net = _mlp(jmx)
    _init(jmx, net)
    tr = jmx.gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 0.01}, kvstore=None)
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    x, y = (jmx.nd.array(a) for a in _batch())
    for _ in range(2):
        with jmx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(8)
    tr.save_states(f)
    params = str(tmp_path / "mlp.params")
    net.save_params(params)
    with jmx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    tr.step(8)
    want = _state(net, tr)
    with tmx.cpu():
        tnet = _mlp(tmx)
        tnet.load_params(params, ctx=CPU)
        ttr = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                                {"learning_rate": 0.01}, kvstore=None)
        ttr.load_states(f)
        step = ttr.compile_step(tnet,
                                tmx.gluon.loss.SoftmaxCrossEntropyLoss())
        step(*(tmx.nd.array(a) for a in _batch()))
        got = _state(tnet, ttr)
        # and the port's own blob reloads into a new trainer
        g = str(tmp_path / "port.states")
        ttr.save_states(g)
        again = tmx.gluon.Trainer(tnet.collect_params(), "adam",
                                  {"learning_rate": 0.01}, kvstore=None)
        again.load_states(g)
        assert again._optimizer._index_update_count == \
            ttr._optimizer._index_update_count
    _close(([], got), ([], want))
