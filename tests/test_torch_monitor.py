"""Port parity: the executor's monitor hook and ``mx.mon.Monitor`` against
the JAX package's, on the CPU.

* ``Executor.set_monitor_callback`` hands every node output to the
  callback under the JAX package's ``<node>_output`` names and in its
  order, with values within 1e-5 relative (inference and training
  forwards; ``use_jit`` is accepted and changes nothing here), keeps
  firing across a reshape, and stops when removed;
* ``fit(monitor=Monitor(...))`` over a few steps of a small MLP from the
  same numpy parameters gives the JAX package's stat names, in its order,
  with values within 1e-5 relative (the default mean-|x| stat, a pattern
  with ``sort=True``, and an interval of 2);
* ``Module.install_monitor`` watches the bound executors.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

REL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mlp(mx):
    data = mx.sym.var("data")
    x = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    x = mx.sym.Activation(x, act_type="relu", name="relu1")
    x = mx.sym.FullyConnected(x, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def _conv(mx):
    data = mx.sym.var("data")
    x = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                           name="c0")
    x = mx.sym.BatchNorm(x, name="bn0")
    x = mx.sym.Activation(x, act_type="relu", name="act0")
    x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="pool0")
    x = mx.sym.Flatten(x, name="flat")
    x = mx.sym.FullyConnected(x, num_hidden=5, name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


def _params(sym, shape, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n != "data" and not n.endswith("label")}
    auxs = {n: rng.uniform(0.5, 1.5, s).astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _nd(mx, arrays):
    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in arrays.items()}


def _assert_entries_match(got, want):
    """[(name, value)] lists: names equal in order, values within REL."""
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=REL, atol=REL * 1e-2,
                                   err_msg=name)


# ------------------------------------------------------- the callback hook

def _spied_forward(mx, sym, shape, is_train, use_jit=False, reshape=None):
    args, auxs = _params(sym, shape)
    x = np.random.RandomState(1).uniform(-1, 1, shape).astype(np.float32)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[("data", shape)],
             label_shapes=[("softmax_label", (shape[0],))],
             for_training=is_train)
    mod.init_params(mx.init.Uniform(0.1), arg_params=_nd(mx, args),
                    aux_params=_nd(mx, auxs), force_init=True)
    seen = []
    for exe in mod._exec_group.execs:
        exe.set_monitor_callback(
            lambda name, arr: seen.append((name, arr.asnumpy())),
            use_jit=use_jit)
    label = np.arange(shape[0]) % 3
    batch = mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                            [mx.nd.array(label, ctx=mx.cpu())])
    mod.forward(batch, is_train=is_train)
    if reshape is not None:
        seen.clear()
        n = reshape
        mod.reshape([("data", (n,) + shape[1:])],
                    [("softmax_label", (n,))])
        mod.forward(mx.io.DataBatch([mx.nd.array(x[:n], ctx=mx.cpu())],
                                    [mx.nd.array(label[:n],
                                                 ctx=mx.cpu())]),
                    is_train=is_train)
    out = mod.get_outputs()[0].asnumpy()
    return seen, out, mod


@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("make", [_mlp, _conv])
def test_monitor_callback_names_order_values_match_jax(make, is_train):
    shape = (4, 3, 6, 6) if make is _conv else (4, 5)
    jseen, jout, _ = _spied_forward(jmx, make(jmx), shape, is_train)
    tseen, tout, _ = _spied_forward(tmx, make(tmx), shape, is_train)
    assert tseen, "the callback never fired"
    _assert_entries_match(tseen, jseen)
    np.testing.assert_allclose(tout, jout, rtol=REL, atol=1e-7)


def test_monitor_callback_use_jit_and_reshape():
    shape = (4, 3, 6, 6)
    base, _, _ = _spied_forward(tmx, _conv(tmx), shape, False)
    jit, _, _ = _spied_forward(tmx, _conv(tmx), shape, False, use_jit=True)
    _assert_entries_match(jit, base)
    # a reshape keeps the callback armed, and it sees the new batch size
    jseen, _, _ = _spied_forward(jmx, _conv(jmx), shape, False, reshape=2)
    tseen, _, mod = _spied_forward(tmx, _conv(tmx), shape, False,
                                   reshape=2)
    _assert_entries_match(tseen, jseen)
    assert tseen[0][1].shape[0] == 2
    # removing it stops the spy pass
    n = len(tseen)
    mod._exec_group.execs[0].set_monitor_callback(None)
    mod.forward(tmx.io.DataBatch([tmx.nd.zeros((2,) + shape[1:],
                                               ctx=tmx.cpu())], []),
                is_train=False)
    assert len(tseen) == n


def test_monitor_callback_respects_the_output_selection():
    """A monitored forward walks the whole graph but returns only the
    selected heads."""
    data = tmx.sym.var("data")
    a = tmx.sym.FullyConnected(data, num_hidden=3, name="a")
    b = tmx.sym.FullyConnected(data, num_hidden=2, name="b")
    sym = tmx.sym.Group([a, b])
    args, _ = _params(sym, (2, 4))
    exe = sym.simple_bind(ctx=tmx.cpu(), data=(2, 4), grad_req="null")
    for k, v in args.items():
        exe.arg_dict[k][:] = v
    names = []
    exe.set_monitor_callback(lambda n, v: names.append(n))
    exe.select_outputs(["b"])
    outs = exe.forward(is_train=False)
    assert names == ["a_output", "b_output"]
    assert len(outs) == 1 and outs[0].shape == (2, 2)


# ------------------------------------------------------------ the Monitor

def _fit_with_monitor(mx, monitor_kw, steps=4):
    sym = _mlp(mx)
    shape = (8, 5)
    args, auxs = _params(sym, shape, seed=3)
    rng = np.random.RandomState(4)
    X = rng.uniform(-1, 1, (steps * 8, 5)).astype(np.float32)
    Y = rng.randint(0, 3, steps * 8).astype(np.float32)
    it = mx.io.NDArrayIter(X, Y, batch_size=8)
    mon = mx.mon.Monitor(**monitor_kw)
    got = []
    toc = mon.toc

    def recording_toc():
        out = toc()
        got.extend(out)
        return out

    mon.toc = recording_toc
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.fit(it, num_epoch=1, monitor=mon, arg_params=_nd(mx, args),
            aux_params=_nd(mx, auxs), optimizer="sgd",
            optimizer_params=(("learning_rate", 0.1),))
    return got


@pytest.mark.parametrize("kw", [
    {"interval": 1},
    {"interval": 2},
    {"interval": 1, "pattern": "fc.*", "sort": True},
])
def test_fit_monitor_stats_match_jax(kw):
    want = _fit_with_monitor(jmx, kw)
    got = _fit_with_monitor(tmx, kw)
    assert got, "the monitor recorded nothing"
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
    for (s, n, g), (_, _, w) in zip(got, want):
        g = np.array(g.split(), np.float64)
        w = np.array(w.split(), np.float64)
        np.testing.assert_allclose(g, w, rtol=REL, err_msg="%d %s" % (s, n))
    if kw.get("pattern"):
        assert all(n.startswith("fc") for _, n, _ in got)


def test_install_monitor_watches_the_bound_executors():
    sym = _mlp(tmx)
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (2, 5))],
             label_shapes=[("softmax_label", (2,))], for_training=False)
    mod.init_params(tmx.init.Uniform(0.1))
    mon = tmx.Monitor(1, pattern="softmax.*")
    mod.install_monitor(mon)
    assert mon.exes == mod._exec_group.execs
    mon.tic()
    mod.forward(tmx.io.DataBatch([tmx.nd.ones((2, 5), ctx=tmx.cpu())],
                                 [tmx.nd.zeros((2,), ctx=tmx.cpu())]),
                is_train=False)
    rows = mon.toc()
    assert [n for _, n, _ in rows] == ["softmax_output", "softmax_label"]
    # the mean |p| of a softmax over 3 classes
    assert abs(float(rows[0][2]) - 1.0 / 3) < 1e-6
