"""Port parity: the Module family beside ``Module`` — ``SequentialModule``
(``take_labels``, ``auto_wiring``), ``PythonModule`` /
``PythonLossModule``, the legacy ``FeedForward`` estimator,
``executor_manager`` and ``fit(resume=)`` through ``BucketingModule`` and
``FeedForward`` — against mxnet_tpu on the same numpy inputs.

Parameters after ``fit`` are held at rtol 1e-5 / atol 1e-6 (the same fp32
ops in another summation order, as in test_torch_module.py); both
packages' initializers fill from numpy's global generator, so one
``np.random.seed`` gives both the same start. A resumed fit is held to
its unbroken fit bit for bit.
"""
import os
import signal

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from time_limit import time_limit  # noqa: F401

_FIT_TOL = dict(rtol=1e-5, atol=1e-6)
_OPT = (("learning_rate", 0.1), ("momentum", 0.9))


def _data(n=24, d=6, classes=4, seed=3):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.randint(0, classes, n).astype(np.float32)
    return x, y


def _host(params):
    return {k: v.asnumpy().copy() for k, v in params.items()}


def _assert_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **_FIT_TOL)


def _preempt_at(n):
    count = [0]

    def preempt(_param):
        count[0] += 1
        if count[0] == n:
            os.kill(os.getpid(), signal.SIGTERM)

    return preempt


# ------------------------------------------------------- SequentialModule

def _sequential(mx, python_head=False):
    """A feature Module (fc1 + relu, no labels) followed by an FC head
    with its loss (wired by auto_wiring, fed labels by take_labels), or
    by an FC with a PythonLossModule whose numpy gradient is the softmax
    cross entropy's."""
    feat = mx.mod.Module(
        mx.sym.Activation(mx.sym.FullyConnected(
            mx.sym.var("data"), num_hidden=8, name="fc1"), act_type="relu"),
        data_names=["data"], label_names=None, context=mx.cpu())
    seq = mx.mod.SequentialModule()
    seq.add(feat)
    if not python_head:
        head = mx.mod.Module(
            mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
                mx.sym.var("hidden"), num_hidden=4, name="fc2"),
                name="softmax"),
            data_names=["hidden"], label_names=["softmax_label"],
            context=mx.cpu())
        seq.add(head, take_labels=True, auto_wiring=True)
        return seq
    scores = mx.mod.Module(
        mx.sym.FullyConnected(mx.sym.var("hidden"), num_hidden=4,
                              name="fc2"),
        data_names=["hidden"], label_names=None, context=mx.cpu())

    def softmax_ce_grad(scores, labels):
        s = scores.asnumpy().astype(np.float64)
        p = np.exp(s - s.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1.0
        return p.astype(np.float32)

    seq.add(scores, auto_wiring=True)
    seq.add(mx.mod.PythonLossModule(grad_func=softmax_ce_grad),
            take_labels=True, auto_wiring=True)
    return seq


@pytest.mark.parametrize("python_head", [False, True],
                         ids=["module_head", "python_loss_head"])
def test_sequential_fit_matches_jax(python_head):
    x, y = _data()
    out = []
    for mx in (jmx, tmx):
        np.random.seed(0)
        seq = _sequential(mx, python_head)
        seq.fit(mx.io.NDArrayIter(x, y, batch_size=8), num_epoch=2,
                optimizer="sgd", optimizer_params=_OPT,
                initializer=mx.init.Xavier())
        out.append((_host(seq.get_params()[0]), seq))
    _assert_close(out[1][0], out[0][0])
    jseq, tseq = out[0][1], out[1][1]
    assert tseq.output_shapes == jseq.output_shapes
    assert tseq.data_names == jseq.data_names
    assert tseq.label_shapes is not None
    batch = tmx.io.DataBatch(data=[tmx.nd.array(x[:8], ctx=tmx.cpu())],
                             label=[tmx.nd.array(y[:8], ctx=tmx.cpu())])
    jbatch = jmx.io.DataBatch(data=[jmx.nd.array(x[:8])],
                              label=[jmx.nd.array(y[:8])])
    tseq.forward(batch, is_train=False)
    jseq.forward(jbatch, is_train=False)
    np.testing.assert_allclose(tseq.get_outputs()[0].asnumpy(),
                               jseq.get_outputs()[0].asnumpy(), **_FIT_TOL)


def test_sequential_checks_as_the_jax_package():
    seq = tmx.mod.SequentialModule()
    with pytest.raises(AssertionError, match="typo"):
        seq.add(tmx.mod.PythonLossModule(grad_func=lambda s, l: s),
                take_label=True)
    with pytest.raises(AssertionError, match="empty"):
        seq.bind([("data", (2, 3))])
    # a parameter name in two stages is refused
    seq = tmx.mod.SequentialModule()
    for _ in range(2):
        seq.add(tmx.mod.Module(
            tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=3,
                                   name="fc"),
            label_names=None, context=tmx.cpu()), auto_wiring=True)
    seq.bind([("data", (2, 3))], for_training=False)
    with pytest.raises(AssertionError, match="Duplicated parameter"):
        seq.init_params()


def test_python_loss_module_as_the_jax_package():
    rng = np.random.RandomState(1)
    s = rng.standard_normal((4, 3)).astype(np.float32)
    lab = np.array([0, 2, 1, 2], np.float32)
    grads = []
    for mx in (jmx, tmx):
        m = mx.mod.PythonLossModule(grad_func=lambda sc, lb: sc * 2.0)
        m.bind([("data", (4, 3))], [("softmax_label", (4,))])
        m.init_params()
        m.init_optimizer()
        assert m.output_shapes == [("pyloss_output", (4, 3))]
        assert m.get_params() == ({}, {})
        batch = mx.io.DataBatch(data=[mx.nd.array(s, ctx=mx.cpu())],
                                label=[mx.nd.array(lab, ctx=mx.cpu())])
        m.forward(batch, is_train=True)
        np.testing.assert_array_equal(m.get_outputs()[0].asnumpy(), s)
        m.backward()
        grads.append(m.get_input_grads()[0].asnumpy())
        with pytest.raises(ValueError):
            m.backward(out_grads=[batch.data[0]])
        with pytest.raises(RuntimeError, match="grad_func"):
            bare = mx.mod.PythonLossModule()
            bare.bind([("data", (4, 3))])
            bare.forward(batch)
            bare.backward()
    np.testing.assert_array_equal(grads[1], grads[0])
    # a numpy gradient lands where the scores live
    m = tmx.mod.PythonLossModule(
        grad_func=lambda sc, lb: np.ones(sc.shape, np.float32))
    m.bind([("data", (4, 3))])
    m.forward(tmx.io.DataBatch(data=[tmx.nd.array(s, ctx=tmx.cpu())]),
              is_train=True)
    m.backward()
    assert m.get_input_grads()[0].context.device_type == "cpu"


# ------------------------------------------------------------ FeedForward

def _ff_symbol(mx):
    h = mx.sym.Activation(mx.sym.FullyConnected(
        mx.sym.var("data"), num_hidden=8, name="fc1"), act_type="tanh")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        h, num_hidden=4, name="fc2"), name="softmax")


def _feedforward_fit(mx, x, y, **kw):
    np.random.seed(0)
    model = mx.model.FeedForward(
        _ff_symbol(mx), ctx=mx.cpu(), num_epoch=3, numpy_batch_size=8,
        optimizer="sgd", initializer=mx.init.Xavier(), learning_rate=0.1,
        momentum=0.9)
    return model.fit(x, y, **kw)


def test_feedforward_fit_predict_score_save_load_match_jax(tmp_path):
    x, y = _data(n=20)   # 3 batches of 8, the last padded
    jm, tm = (_feedforward_fit(mx, x, y) for mx in (jmx, tmx))
    _assert_close(_host(tm.arg_params), _host(jm.arg_params))
    tp, jp = tm.predict(x), jm.predict(x)
    assert tp.shape == jp.shape == (20, 4)
    np.testing.assert_allclose(tp, jp, **_FIT_TOL)
    preds, data, label = tm.predict(tmx.io.NDArrayIter(x, y, batch_size=8),
                                    return_data=True)
    np.testing.assert_array_equal(data, x)
    np.testing.assert_array_equal(label, y)
    np.testing.assert_allclose(preds, tp, **_FIT_TOL)
    it = lambda mx: mx.io.NDArrayIter(x, y, batch_size=8)  # noqa: E731
    assert tm.score(it(tmx)) == pytest.approx(jm.score(it(jmx)), abs=1e-9)
    seen = []
    tm.score(it(tmx), eval_metric="mse",
             batch_end_callback=lambda p: seen.append(p.nbatch))
    assert seen == [0, 1, 2]
    # the checkpoint pair loads across packages
    tm.save(str(tmp_path / "port"))
    jm.save(str(tmp_path / "jax"))
    for loader, prefix, other in (
            (jmx.model.FeedForward.load, "port", tm),
            (tmx.model.FeedForward.load, "jax", jm)):
        back = loader(str(tmp_path / prefix), 3, ctx=(
            jmx.cpu() if loader.__module__.startswith("mxnet_tpu.")
            else tmx.cpu()))
        assert back.begin_epoch == 3
        np.testing.assert_allclose(back.predict(x), other.predict(x),
                                   **_FIT_TOL)


def test_feedforward_context_defaults_to_the_scope_or_the_card():
    import torch

    sym = _ff_symbol(tmx)
    with tmx.cpu():
        assert [str(c) for c in tmx.model.FeedForward(sym).ctx] == ["cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="CUDA"):
            tmx.model.FeedForward(sym)
    with pytest.raises(ValueError, match="num_epoch"):
        tmx.model.FeedForward(sym, ctx=tmx.cpu()).fit(*_data())


def test_feedforward_fit_resume_is_bit_exact(tmp_path):
    x, y = _data()
    unbroken = _host(_feedforward_fit(tmx, x, y).arg_params)
    with pytest.raises(tmx.resilience.PreemptedError):
        _feedforward_fit(tmx, x, y, resume=str(tmp_path),
                         batch_end_callback=_preempt_at(4))
    state = tmx.resilience.load_latest(str(tmp_path))
    assert (state.epoch, state.batch, state.step) == (1, 1, 4)
    np.random.seed(77)
    resumed = _host(_feedforward_fit(tmx, x, y,
                                     resume=str(tmp_path)).arg_params)
    for k in unbroken:
        np.testing.assert_array_equal(resumed[k], unbroken[k], err_msg=k)


def test_convert_conv_weight_layout_matches_jax():
    w = np.random.RandomState(0).standard_normal((8, 3, 3, 4)) \
        .astype(np.float32)
    for direction in ("ref_to_tpu", "tpu_to_ref"):
        want = jmx.model.convert_conv_weight_layout(w, direction)
        got = tmx.model.convert_conv_weight_layout(w, direction)
        np.testing.assert_array_equal(got, want)
        nd = tmx.model.convert_conv_weight_layout(
            tmx.nd.array(w, ctx=tmx.cpu()), direction)
        np.testing.assert_array_equal(nd.asnumpy(), want)
    round_trip = tmx.model.convert_conv_weight_layout(
        tmx.model.convert_conv_weight_layout(w), "tpu_to_ref")
    np.testing.assert_array_equal(round_trip, w)
    with pytest.raises(ValueError):
        tmx.model.convert_conv_weight_layout(w, "sideways")
    with pytest.raises(ValueError):
        tmx.model.convert_conv_weight_layout(w[0, 0])


# -------------------------------------------------- BucketingModule resume

class _KeyedIter(tmx.io.NDArrayIter):
    """NDArrayIter whose batches name the default bucket."""

    def next(self):
        batch = super().next()
        batch.bucket_key = 6
        batch.provide_data = self.provide_data
        batch.provide_label = self.provide_label
        return batch


def _bucketing_fit(resume=None, callback=None):
    x, y = _data()

    def sym_gen(key):
        return _ff_symbol(tmx), ("data",), ("softmax_label",)

    np.random.seed(2)
    mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=6,
                                  context=tmx.cpu())
    mod.fit(_KeyedIter(x, y, batch_size=8, shuffle=True), num_epoch=2,
            optimizer="sgd", optimizer_params=_OPT,
            initializer=tmx.init.Xavier(), resume=resume,
            batch_end_callback=callback)
    return _host(mod.get_params()[0])


def test_bucketing_fit_resume_is_bit_exact(tmp_path):
    unbroken = _bucketing_fit()
    with pytest.raises(tmx.resilience.PreemptedError):
        _bucketing_fit(str(tmp_path), _preempt_at(2))
    assert tmx.resilience.load_latest(str(tmp_path)).step == 2
    resumed = _bucketing_fit(str(tmp_path))
    for k in unbroken:
        np.testing.assert_array_equal(resumed[k], unbroken[k], err_msg=k)


# ------------------------------------------------------- executor_manager

@pytest.mark.parametrize("batch,loads", [(10, [1, 1]), (9, [1, 2, 3]),
                                         (7, [0.3, 0.7]), (4, [1, 1, 1, 1])])
def test_split_input_slice_matches_jax(batch, loads):
    from mxnet_tpu.executor_manager import _split_input_slice as jsplit
    from mxnet_tpu_torch.executor_manager import _split_input_slice

    assert _split_input_slice(batch, loads) == jsplit(batch, loads)
    with pytest.raises(ValueError, match="Too many slices"):
        _split_input_slice(2, [1, 1, 1])


def test_data_parallel_executor_manager_matches_jax():
    x, y = _data(n=8)
    rng = np.random.RandomState(4)
    args = {"fc1_weight": rng.standard_normal((8, 6)),
            "fc1_bias": rng.standard_normal(8),
            "fc2_weight": rng.standard_normal((4, 8)),
            "fc2_bias": rng.standard_normal(4)}
    outs = []
    for mx in (jmx, tmx):
        it = mx.io.NDArrayIter(x, y, batch_size=8)
        mgr = mx.executor_manager.DataParallelExecutorManager(
            _ff_symbol(mx), mx.cpu(), it)
        mgr.set_params({k: mx.nd.array(v.astype(np.float32), ctx=mx.cpu())
                        for k, v in args.items()}, {})
        mgr.load_data_batch(next(iter(it)))
        mgr.forward(is_train=True)
        mgr.backward()
        metric = mx.metric.create("acc")
        mgr.update_metric(metric, [mx.nd.array(y, ctx=mx.cpu())])
        outs.append((metric.get()[1],
                     [g[0].asnumpy() for g in mgr.grad_arrays],
                     len(mgr.param_arrays)))
    assert outs[1][0] == outs[0][0] and outs[1][2] == outs[0][2] == 4
    for got, want in zip(outs[1][1], outs[0][1]):
        np.testing.assert_allclose(got, want, **_FIT_TOL)
    with pytest.raises(NotImplementedError, match="BucketingModule"):
        tmx.executor_manager.DataParallelExecutorManager(
            _ff_symbol(tmx), tmx.cpu(), tmx.io.NDArrayIter(x, y),
            sym_gen=lambda k: None)
    assert tmx.mod.DataParallelExecutorGroup is \
        tmx.executor_manager.DataParallelExecutorGroup
