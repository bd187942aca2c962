"""Port parity: ``mx.test_utils`` against mxnet_tpu's.

The generators draw the same numbers for the same seeds (the module
generator ``_rng`` reseeded in both packages, numpy's global one seeded);
the checkers pass and fail alike, with the same messages; the symbolic
checks and ``check_consistency`` run on the CPU here (a card test runs
``check_consistency`` over ``mx.cpu()`` and ``mx.gpu(0)``).
"""
import inspect
import os
import types

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import test_utils as jtu
from mxnet_tpu_torch import test_utils as ttu
from time_limit import time_limit  # noqa: F401

PACKAGES = ((jmx, jtu), (tmx, ttu))


def _seed(seed):
    for tu in (jtu, ttu):
        tu._rng = np.random.RandomState(seed)


def test_every_function_is_ported():
    def names(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and callable(v) and not isinstance(v, types.ModuleType)
                and getattr(v, "__module__", None) == mod.__name__}

    assert names(jtu) <= names(ttu), sorted(names(jtu) - names(ttu))


def test_random_generators_draw_alike():
    outs = []
    for mx, tu in PACKAGES:
        _seed(5)
        with mx.cpu():
            outs.append([tu.rand_shape_2d(), tu.rand_shape_3d(4, 5, 6),
                         tu.rand_shape_nd(3, 7), tu.random_arrays((2, 3)),
                         tu.random_arrays((2,), ()),
                         tu.rand_ndarray((3, 4), "row_sparse").asnumpy()])
    j, t = outs
    assert j[:3] == t[:3]
    for a, b in zip(j[3:], t[3:]):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            np.testing.assert_array_equal(x, y)
    np.random.seed(3)
    sample = ttu.random_sample(list(range(10)), 4)
    np.random.seed(3)
    assert sample == jtu.random_sample(list(range(10)), 4)


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_sparse_generators_draw_alike(stype):
    outs = []
    for mx, tu in PACKAGES:
        with mx.cpu():
            np.random.seed(7)
            arr, dense = tu.rand_sparse_ndarray((6, 5), stype, density=0.4)
            np.random.seed(7)
            arr2, _ = tu.rand_sparse_ndarray((4, 3), stype)
            np.random.seed(8)
            made = tu.create_sparse_array((6, 4), stype, rsp_indices=[1, 4])
            zd = tu.create_sparse_array_zd((3, 4), stype, 0.0)
            init = tu.create_sparse_array((2, 3), stype, data_init=2.0,
                                          modifier_func=lambda x: x + 1)
            outs.append([(a.stype, a.asnumpy(), a.indices.asnumpy())
                         for a in (arr, arr2, made, zd, init)] + [dense])
            assert tu.shuffle_csr_column_indices(arr) is arr
    for a, b in zip(*outs):
        for x, y in zip(a if isinstance(a, tuple) else [a],
                        b if isinstance(b, tuple) else [b]):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        ttu.rand_sparse_ndarray((2, 2), "csr", distribution="powerlaw")


def test_tolerances_and_comparisons_match():
    a = np.array([1.0, 2.0, 3.0], np.float32)
    b = a + np.array([0, 1e-3, 0.5], np.float32)
    for name in ("default_rtols", "default_atols"):
        assert getattr(ttu, name)() == getattr(jtu, name)()
    assert ttu.get_rtol() == jtu.get_rtol() and \
        ttu.get_atol(2) == jtu.get_atol(2)
    assert ttu.find_max_violation(a, b) == jtu.find_max_violation(a, b)
    assert ttu.almost_equal(a, b) == jtu.almost_equal(a, b) is False
    assert ttu.almost_equal(a, b, rtol=1.0, atol=1.0)
    msgs = []
    for tu in (jtu, ttu):
        with pytest.raises(AssertionError) as e:
            tu.assert_almost_equal(a, b, names=("x", "y"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with tmx.cpu():
        ttu.assert_almost_equal(tmx.nd.array(a), a)
    n1, n2 = a.copy(), b.copy()
    n1[2], n2[0] = np.nan, np.nan
    assert ttu.almost_equal_ignore_nan(n1, n2, rtol=1e-2) == \
        jtu.almost_equal_ignore_nan(n1, n2, rtol=1e-2)
    ttu.assert_almost_equal_ignore_nan(n1, n1)
    x = np.arange(24.0).reshape(2, 3, 4)
    for axis, keep in ((1, True), ((0, 2), False), (None, False)):
        np.testing.assert_array_equal(
            ttu.np_reduce(x, axis, keep, np.sum),
            jtu.np_reduce(x, axis, keep, np.sum))
    assert ttu.same(a, a.copy()) and not ttu.same(a, b)
    ttu.assert_exception(lambda: 1 / 0, ZeroDivisionError)
    np.testing.assert_array_equal(ttu.assign_each(a, lambda v: v * 2),
                                  jtu.assign_each(a, lambda v: v * 2))
    np.testing.assert_array_equal(
        ttu.assign_each2(a, b, lambda u, v: u - v),
        jtu.assign_each2(a, b, lambda u, v: u - v))


def test_same_array():
    with tmx.cpu():
        a = tmx.nd.array(np.ones(3, np.float32))
        assert ttu.same_array(a, a)
        assert ttu.same_array(a, a[0:3])
        assert not ttu.same_array(a, a.copy())
        np.testing.assert_array_equal(a.asnumpy(), np.ones(3))


def _fc(mx):
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    return mx.sym.Activation(fc, act_type="tanh")


def test_numeric_grad_matches():
    rng = np.random.RandomState(2)
    loc = {"data": rng.randn(2, 4), "fc_weight": rng.randn(3, 4) * 0.5,
           "fc_bias": rng.randn(3) * 0.1}
    grads = []
    for mx, tu in PACKAGES:
        with mx.cpu():
            s = _fc(mx)
            exe = s.bind(mx.cpu(), {k: mx.nd.array(v, dtype="float64")
                                    for k, v in loc.items()})
            grads.append(tu.numeric_grad(exe, loc, eps=1e-6,
                                         dtype=np.float64))
    for k in loc:
        np.testing.assert_allclose(grads[1][k], grads[0][k], rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("grad_nodes", [None, ["data", "fc_weight"],
                                        {"data": "write", "fc_bias": "add",
                                         "fc_weight": "null"}])
def test_check_numeric_gradient(grad_nodes):
    rng = np.random.RandomState(3)
    loc = [rng.randn(2, 4), rng.randn(3, 4) * 0.5, rng.randn(3) * 0.1]
    with tmx.cpu():
        _seed(9)
        ttu.check_numeric_gradient(_fc(tmx), loc, grad_nodes=grad_nodes,
                                   dtype=np.float64, rtol=1e-4)
    _seed(9)
    jtu.check_numeric_gradient(_fc(jmx), loc, grad_nodes=grad_nodes,
                               dtype=np.float64, rtol=1e-4)


def test_check_numeric_gradient_catches_a_wrong_gradient():
    with tmx.cpu():
        data = tmx.sym.var("data")
        # BlockGrad's gradient is 0, its numeric one is not
        s = tmx.sym.BlockGrad(data) * 2
        with pytest.raises(AssertionError, match="NUMERICAL_data"):
            ttu.check_numeric_gradient(s, [np.ones((2, 2))])


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_check_symbolic_forward_and_backward(req):
    rng = np.random.RandomState(4)
    x, w, b = rng.randn(2, 4), rng.randn(3, 4), rng.randn(3)
    y = np.tanh(x @ w.T + b)
    og = rng.randn(2, 3)
    dz = og * (1 - y ** 2)
    expected = {"data": dz @ w, "fc_weight": dz.T @ x,
                "fc_bias": dz.sum(axis=0)}
    outs = []
    for mx, tu in PACKAGES:
        with mx.cpu():
            _seed(1)
            fwd = tu.check_symbolic_forward(_fc(mx), [x, w, b], [y],
                                            dtype=np.float64)
            bufs = tu.check_symbolic_backward(_fc(mx), [x, w, b], [og],
                                              expected, grad_req=req,
                                              dtype=np.float64)
            outs.append([fwd[0].asnumpy()] +
                        [bufs[k].asnumpy() for k in sorted(bufs)])
            with pytest.raises(AssertionError):
                tu.check_symbolic_forward(_fc(mx), [x, w, b], [y + 1],
                                          dtype=np.float64)
    for a, b_ in zip(*outs):
        np.testing.assert_allclose(a, b_, rtol=1e-12, atol=1e-12)


def test_simple_forward():
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    outs = []
    for mx, tu in PACKAGES:
        with mx.cpu():
            s = mx.sym.var("a") * 2 + mx.sym.var("b")
            outs.append(tu.simple_forward(s, a=x, b=x))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_check_consistency_over_dtypes():
    outs = []
    for mx, tu in PACKAGES:
        with mx.cpu():
            ctx_list = [{"ctx": mx.cpu(), "data": (2, 4),
                         "type_dict": {"data": np.float32}},
                        {"ctx": mx.cpu(), "data": (2, 4),
                         "type_dict": {"data": np.float64}}]
            np.random.seed(12)
            res = tu.check_consistency(_fc(mx), ctx_list)
            outs.append([o.asnumpy() for r in res for o in r])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_check_speed_and_environment():
    with tmx.cpu():
        s = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=4)
        assert ttu.check_speed(s, ctx=tmx.cpu(), N=2, data=(2, 3)) > 0
        shapes = dict(zip(s.list_arguments(),
                          s.infer_shape(data=(2, 3))[0]))
        assert ttu.check_speed(s, ctx=tmx.cpu(), N=2, typ="forward",
                               location={k: np.ones(v)
                                         for k, v in shapes.items()}) > 0
        assert ttu.default_context() == tmx.cpu()
    assert ttu.list_gpus() == list(range(__import__("torch").cuda
                                         .device_count()))
    calls = []

    @ttu.retry(3)
    def flaky():
        calls.append(1)
        assert len(calls) == 2

    flaky()
    assert len(calls) == 2
    prev = ttu.set_env_var("MXNET_TEST_UTILS_PROBE", "1", "none")
    assert prev == "none" and os.environ["MXNET_TEST_UTILS_PROBE"] == "1"
    del os.environ["MXNET_TEST_UTILS_PROBE"]
    with ttu.discard_stderr():
        os.write(2, b"silenced\n")
    for tu in (jtu, ttu):
        with pytest.raises(IOError):
            tu.download("http://example.invalid/f.bin", dirname="/nonexistent")
    with pytest.raises(tmx.MXNetError):
        ttu.get_bz2_data("/nonexistent", "x", "http://example.invalid", "y")
    jm, tm = jtu.get_mnist(), ttu.get_mnist()
    for k in jm:
        np.testing.assert_array_equal(jm[k], tm[k])


def test_default_context_is_the_scope_else_the_card():
    import torch

    with tmx.cpu():
        assert ttu.default_context().device_type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="CUDA is not available"):
            ttu.default_context()
    assert inspect.signature(ttu.check_consistency).parameters.keys() == \
        inspect.signature(jtu.check_consistency).parameters.keys()
