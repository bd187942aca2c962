"""Port parity: custom operators (``mx.operator``, ``nd.Custom``,
``sym.Custom``, the legacy ``NumpyOp`` / ``NDArrayOp``) against mxnet_tpu
on the same numpy inputs: the cases of tests/test_custom_op.py and
tests/test_module_parity.py's legacy head, within 1e-6, and the
custom-softmax example (examples/numpy_ops/custom_softmax.py) trained with
``Module.fit`` in both packages with its numpy ``CustomOp`` head: the
port's parameters within 1e-5 of max |param| of the JAX package's (both
packages compute the same fp32 ops in another order), and within 1e-5 of
the port's own fit with the built-in SoftmaxOutput (the same softmax and
``p - onehot``).
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import chip_smoke  # noqa: E402  (the custom softmax head, as user code)

_TOL = dict(rtol=1e-6, atol=1e-6)
_FIT_TOL = 1e-5
_PKGS = (jmx, tmx)


def _register(mx):
    """tests/test_custom_op.py's ops, under names of this file."""

    class Sqr(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @mx.operator.register("port_parity_sqr")
    class SqrProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    @mx.operator.register("port_parity_scaled_add")
    class ScaledAddProp(mx.operator.CustomOpProp):
        def __init__(self, scale=1.0):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_arguments(self):
            return ["a", "b"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            prop = self

            class ScaledAdd(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] + prop.scale * in_data[1])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0])
                    self.assign(in_grad[1], req[1],
                                prop.scale * out_grad[0])

            return ScaledAdd()

    chip_smoke.register_softmax_ops(mx)


for _mx in _PKGS:
    _register(_mx)

_X = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)


def _compare(got):
    for j, t in zip(*got):
        np.testing.assert_allclose(t, j, **_TOL)


def test_custom_op_forward_backward_nd():
    got = []
    for mx in _PKGS:
        x = mx.nd.array(_X, ctx=mx.cpu())
        plain = mx.nd.Custom(x, op_type="port_parity_sqr").asnumpy()
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(x, op_type="port_parity_sqr")
        y.backward()
        got.append([plain, y.asnumpy(), x.grad.asnumpy()])
    _compare(got)
    np.testing.assert_allclose(got[1][0], [[1, 4], [9, 16]])
    np.testing.assert_allclose(got[1][2], [[2, 4], [6, 8]])


def test_custom_op_symbolic():
    got = []
    for mx in _PKGS:
        data = mx.sym.Variable("data")
        s = mx.sym.Custom(data, op_type="port_parity_sqr", name="sqr")
        exe = s.bind(mx.cpu(), args={"data": mx.nd.array(_X, ctx=mx.cpu())},
                     args_grad={"data": mx.nd.zeros((2, 2), ctx=mx.cpu())})
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(mx.nd.array(np.full((2, 2), 0.5, np.float32),
                                 ctx=mx.cpu()))
        got.append([out, exe.grad_dict["data"].asnumpy()])
        ex2 = s.simple_bind(mx.cpu(), data=(2, 2))
        ex2.arg_dict["data"][:] = _X
        ex2.forward(is_train=True)
        ex2.backward(mx.nd.ones((2, 2), ctx=mx.cpu()))
        got[-1].append(ex2.grad_dict["data"].asnumpy())
        assert s.list_outputs() == ["sqr_output"]
    _compare(got)
    np.testing.assert_allclose(got[1][1], [[1, 2], [3, 4]])


def test_custom_op_kwargs_and_two_inputs():
    got = []
    for mx in _PKGS:
        a = mx.nd.array(np.ones((2, 3), np.float32), ctx=mx.cpu())
        b = mx.nd.array(np.full((2, 3), 2.0, np.float32), ctx=mx.cpu())
        out = mx.nd.Custom(a, b, op_type="port_parity_scaled_add",
                           scale=3.0).asnumpy()
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            y = mx.nd.Custom(a, b, op_type="port_parity_scaled_add",
                             scale=3.0)
        y.backward()
        got.append([out, a.grad.asnumpy(), b.grad.asnumpy()])
    _compare(got)
    np.testing.assert_allclose(got[1][0], 7.0)
    np.testing.assert_allclose(got[1][2], 3.0)


def _legacy_heads(mx):
    class NumpyHead(mx.operator.NumpyOp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]]

        def forward(self, in_data, out_data):
            x = in_data[0]
            e = np.exp(x - x.max(axis=1, keepdims=True))
            out_data[0][:] = e / e.sum(axis=1, keepdims=True)

        def backward(self, out_grad, in_data, out_data, in_grad):
            lab = in_data[1].astype(int)
            dx = out_data[0].copy()
            dx[np.arange(len(lab)), lab] -= 1.0
            in_grad[0][:] = dx

    class NDArrayHead(mx.operator.NDArrayOp):
        """y = 2x; dx = 2 dy, in place on NDArrays."""

        def forward(self, in_data, out_data):
            out_data[0][:] = in_data[0] * 2.0

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = out_grad[0] * 2.0

    return NumpyHead, NDArrayHead


@pytest.mark.parametrize("kind", ["numpy", "ndarray"])
def test_legacy_op_heads(kind):
    rng = np.random.RandomState(0)
    x = rng.rand(4, 6).astype(np.float32)
    w = rng.randn(3, 6).astype(np.float32)
    y = np.array([0, 2, 1, 2], np.float32)
    head_grad = rng.randn(4, 3).astype(np.float32)
    got = []
    for mx in _PKGS:
        numpy_head, ndarray_head = _legacy_heads(mx)
        fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                   no_bias=True, name="fc")
        if kind == "numpy":
            net = numpy_head()(fc, mx.sym.Variable("softmax_label"),
                               name="softmax")
            shapes = dict(data=x.shape, softmax_label=y.shape)
        else:
            net = ndarray_head()(fc, name="double")
            shapes = dict(data=x.shape)
        ex = net.simple_bind(mx.cpu(), grad_req={"fc_weight": "write"},
                             **shapes)
        ex.arg_dict["data"][:] = x
        ex.arg_dict["fc_weight"][:] = w
        if kind == "numpy":
            ex.arg_dict["softmax_label"][:] = y
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(mx.nd.array(head_grad, ctx=mx.cpu()))
        got.append([out, ex.grad_dict["fc_weight"].asnumpy()])
    _compare(got)
    if kind == "ndarray":
        np.testing.assert_allclose(got[1][0], 2 * x @ w.T, rtol=1e-5)


def test_custom_softmax_graph_carves_only_fc1_relu():
    """The fuse pass leaves the Custom head alone in both packages."""
    regions = []
    for mx in _PKGS:
        mod = mx.mod.Module(chip_smoke.custom_softmax_net(mx,
                                                          "numpy_softmax"),
                            context=mx.cpu())
        mod.bind(data_shapes=[("data", (4, 1, 28, 28))],
                 label_shapes=[("softmax_label", (4,))], for_training=True)
        regions.append([(r["base_op"], r["members"][0], len(r["members"]))
                        for r in mod._exec_group.execs[0].fused_regions()])
    assert regions[0] == regions[1] == [("FullyConnected", "fc1", 2)]


def _softmax_fit(mx, head, n=300, epochs=2):
    mnist = mx.test_utils.get_mnist()
    np.random.seed(0)
    it = mx.io.NDArrayIter(mnist["train_data"][:n],
                           mnist["train_label"][:n], batch_size=100,
                           shuffle=True)
    mod = mx.mod.Module(chip_smoke.custom_softmax_net(mx, head),
                        context=mx.cpu())
    np.random.seed(1)
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mx.init.Xavier(), eval_metric=mx.metric.Accuracy())
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _assert_params_close(got, want):
    assert sorted(got) == sorted(want) == ["fc1_bias", "fc1_weight",
                                           "fc2_bias", "fc2_weight"]
    for k in want:
        scale = np.abs(want[k]).max()
        err = np.abs(got[k] - want[k]).max()
        assert err <= _FIT_TOL * scale, (k, err, scale)


def test_custom_softmax_fit_matches_jax_and_the_builtin_head():
    p_jax = _softmax_fit(jmx, "numpy_softmax")
    p_port = _softmax_fit(tmx, "numpy_softmax")
    p_builtin = _softmax_fit(tmx, None)
    _assert_params_close(p_port, p_jax)
    _assert_params_close(p_builtin, p_port)
