"""Port parity: the NDArray (mxnet_tpu_torch/ndarray) against mxnet_tpu's
on the same numpy inputs: creation, arithmetic, in-place updates, the
generated ``nd.*`` functions for ``dot`` / ``batch_dot`` with their
transpose flags, and the SGD update ops.

Tolerance rtol = atol = 1e-6 in fp32: the same elementwise arithmetic, and
products summed in another order.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

_TOL = dict(rtol=1e-6, atol=1e-6)


def _rng(seed=0):
    return np.random.RandomState(seed)


HOST = dict(ctx=tmx.cpu())


def test_creation_and_properties():
    a = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), **HOST)
    assert a.dtype == np.float32
    for src in ([1, 2], [1.5], np.arange(3.0)):
        assert tmx.nd.array(src, **HOST).dtype == jmx.nd.array(src).dtype
    assert a.shape == (2, 3) and a.size == 6 and a.ndim == 2
    assert a.context == tmx.cpu()
    assert tmx.nd.zeros((2, 2), dtype="float16", **HOST).dtype == np.float16
    np.testing.assert_array_equal(tmx.nd.ones(3, **HOST).asnumpy(),
                                  np.ones(3))
    np.testing.assert_array_equal(tmx.nd.full((2,), 7, **HOST).asnumpy(),
                                  [7, 7])
    assert float(tmx.nd.array([2.5], **HOST)) == 2.5
    # asnumpy is a copy, not a view of the array's storage
    host = a.asnumpy()
    a[:] = 0
    assert host.sum() == 15


def test_arithmetic_matches_jax():
    rng = _rng(1)
    x, y = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4) \
        .astype(np.float32)
    out = []
    for mx in (jmx, tmx):
        a, b = mx.nd.array(x, ctx=mx.cpu()), mx.nd.array(y, ctx=mx.cpu())
        res = [a + b, a - b, a * b, a / (b + 10), a + 1, 2 - a, a * 3,
               a / 4, 1 / (a + 10), -a, (a * b).sum(), a.sum(axis=1),
               a.mean(), a.max(axis=0), a.reshape((4, 3)), a.T,
               a.transpose((1, 0)), a[1], a[1:3], a.astype("float16")]
        c = a.copy()
        c += b
        c *= 2
        c -= 1
        c /= 3
        res.append(c)
        out.append([r.asnumpy() for r in res])
    for i, (t, j) in enumerate(zip(out[1], out[0])):
        assert t.shape == j.shape and t.dtype == j.dtype, i
        np.testing.assert_allclose(t, j, err_msg=str(i), **_TOL)


def test_copyto_and_setitem_write_in_place():
    a = tmx.nd.zeros((2, 3), **HOST)
    storage = a._data
    tmx.nd.array(np.ones((2, 3)), **HOST).copyto(a)
    a[0] = 5
    a[:, 1] = tmx.nd.array([7, 8], **HOST)
    assert a._data is storage
    np.testing.assert_array_equal(a.asnumpy(), [[5, 7, 5], [1, 8, 1]])
    b = a.copyto(tmx.cpu())
    assert b is not a and b._data.data_ptr() != a._data.data_ptr()
    assert a.as_in_context(tmx.cpu()) is a


@pytest.mark.parametrize("ta", [False, True])
@pytest.mark.parametrize("tb", [False, True])
def test_dot_and_batch_dot(ta, tb):
    rng = _rng(2)
    a2 = rng.randn(*((5, 4) if ta else (4, 5))).astype(np.float32)
    b2 = rng.randn(*((3, 5) if tb else (5, 3))).astype(np.float32)
    a3 = rng.randn(*((2, 5, 4) if ta else (2, 4, 5))).astype(np.float32)
    b3 = rng.randn(*((2, 3, 5) if tb else (2, 5, 3))).astype(np.float32)
    outs = []
    for mx in (jmx, tmx):
        host = dict(ctx=mx.cpu())
        d = mx.nd.dot(mx.nd.array(a2, **host), mx.nd.array(b2, **host),
                      transpose_a=ta, transpose_b=tb)
        bd = mx.nd.batch_dot(mx.nd.array(a3, **host), mx.nd.array(b3, **host),
                             transpose_a=ta, transpose_b=tb)
        outs.append((d.asnumpy(), bd.asnumpy()))
    for t, j in zip(outs[1], outs[0]):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, **_TOL)


def test_dot_nd_by_2d():
    rng = _rng(3)
    a = rng.randn(2, 3, 4).astype(np.float32)
    b = rng.randn(4, 5).astype(np.float32)
    j = jmx.nd.dot(jmx.nd.array(a), jmx.nd.array(b)).asnumpy()
    t = tmx.nd.dot(tmx.nd.array(a, **HOST), tmx.nd.array(b, **HOST)).asnumpy()
    np.testing.assert_allclose(t, j, **_TOL)


@pytest.mark.parametrize("kw", [
    {"lr": 0.1},
    {"lr": 0.05, "wd": 0.01, "rescale_grad": 0.5},
    {"lr": 0.2, "clip_gradient": 0.3, "rescale_grad": 2.0},
])
def test_sgd_update(kw):
    rng = _rng(4)
    w, g = rng.randn(6, 3).astype(np.float32), rng.randn(6, 3) \
        .astype(np.float32)
    res = []
    for mx in (jmx, tmx):
        weight = mx.nd.array(w, ctx=mx.cpu())
        mx.nd.sgd_update(weight, mx.nd.array(g, ctx=mx.cpu()), out=weight,
                         **kw)
        res.append(weight.asnumpy())
    np.testing.assert_allclose(res[1], res[0], **_TOL)


@pytest.mark.parametrize("kw", [
    {"lr": 0.1, "momentum": 0.9},
    {"lr": 0.05, "momentum": 0.5, "wd": 0.01, "clip_gradient": 0.5,
     "rescale_grad": 0.25},
])
def test_sgd_mom_update(kw):
    rng = _rng(5)
    w, g, m = (rng.randn(4, 5).astype(np.float32) for _ in range(3))
    res = []
    for mx in (jmx, tmx):
        host = dict(ctx=mx.cpu())
        weight, mom = mx.nd.array(w, **host), mx.nd.array(m, **host)
        for _ in range(3):
            mx.nd.sgd_mom_update(weight, mx.nd.array(g, **host), mom,
                                 out=weight, **kw)
        res.append((weight.asnumpy(), mom.asnumpy()))
    for t, j in zip(res[1], res[0]):
        np.testing.assert_allclose(t, j, **_TOL)


def test_sgd_update_writes_in_place():
    weight = tmx.nd.array(np.ones((2, 2), np.float32), **HOST)
    storage = weight._data
    mom = tmx.nd.zeros((2, 2), **HOST)
    tmx.nd.sgd_mom_update(weight, tmx.nd.ones((2, 2), **HOST), mom,
                          out=weight, lr=0.5, momentum=0.9)
    assert weight._data is storage
    np.testing.assert_allclose(weight.asnumpy(), 0.5)
    np.testing.assert_allclose(mom.asnumpy(), -0.5)


def test_optimizer_sgd_multi_precision():
    rng = _rng(6)
    w = rng.randn(3, 3).astype(np.float16)
    g = rng.randn(3, 3).astype(np.float16)
    res = []
    for mx in (jmx, tmx):
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                  multi_precision=True)
        upd = mx.optimizer.get_updater(opt)
        weight = mx.nd.array(w, ctx=mx.cpu(), dtype="float16")
        for _ in range(2):
            upd(0, mx.nd.array(g, ctx=mx.cpu(), dtype="float16"), weight)
        res.append(weight.asnumpy())
    assert res[1].dtype == np.float16
    np.testing.assert_allclose(res[1].astype(np.float32),
                               res[0].astype(np.float32), rtol=1e-3)


def test_updater_states_round_trip():
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    upd = tmx.optimizer.get_updater(opt)
    weight = tmx.nd.ones((2,), **HOST)
    upd(0, tmx.nd.ones((2,), **HOST), weight)
    blob = upd.get_states()
    fresh = tmx.optimizer.get_updater(
        tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9))
    fresh.set_states(blob)
    fresh(0, tmx.nd.ones((2,), **HOST), weight)
    # mom: -0.1, then 0.9 * -0.1 - 0.1
    np.testing.assert_allclose(fresh.states[0].asnumpy(), -0.19, rtol=1e-6)


def test_nd_functions_come_from_the_registry():
    from mxnet_tpu_torch.ops.registry import OP_REGISTRY

    for name in ("dot", "batch_dot", "sgd_update", "sgd_mom_update",
                 "FullyConnected", "softmax"):
        assert name in OP_REGISTRY and callable(getattr(tmx.nd, name))
    x = tmx.nd.array(_rng(7).randn(2, 5).astype(np.float32), **HOST)
    np.testing.assert_allclose(tmx.nd.softmax(x).asnumpy(),
                               torch.softmax(x._data, -1).numpy(), **_TOL)


@pytest.mark.parametrize("create", [
    lambda: tmx.nd.array([1.0]), lambda: tmx.nd.zeros((2,)),
    lambda: tmx.nd.ones((2,)), lambda: tmx.nd.full((2,), 3.0),
    lambda: tmx.nd.empty((2,)),
], ids=["array", "zeros", "ones", "full", "empty"])
def test_creation_defaults_to_the_card(create, monkeypatch):
    """No ``ctx`` means the card: without one, creation raises and does
    not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmx.MXNetError, match="CUDA"):
        create()
