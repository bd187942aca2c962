"""Port parity: device contexts (mxnet_tpu_torch/context.py) against
mxnet_tpu's: ``Context`` and its attributes, the ``with`` scope on a
thread-local stack, ``current_context`` across nesting and exceptions, the
same scoped program through both packages, and the init ops behind
``mx.sym.zeros`` / ``mx.sym.ones``.

Tolerance: exact (creation and one elementwise add in fp32).
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError


def _scoped_program(mx):
    """nd.zeros / ones / array and arithmetic inside ``with mx.cpu():``."""
    with mx.cpu():
        a = mx.nd.zeros((2, 3))
        b = mx.nd.ones((2, 3))
        c = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        d = (a + b) * c - 1.5
    return [(x.asnumpy(), x.context.device_type, x.context.device_id)
            for x in (a, b, c, d)]


def test_scoped_program_matches_the_reference():
    for (jv, jt, ji), (tv, tt, ti) in zip(_scoped_program(jmx),
                                          _scoped_program(tmx)):
        np.testing.assert_array_equal(tv, jv)
        assert (tt, ti) == (jt, ji) == ("cpu", 0)


@pytest.mark.parametrize("make", ["cpu", "gpu", "tpu", "cpu_pinned"])
def test_context_attributes_match_the_reference(make):
    for dev_id in (0, 1):
        j, t = getattr(jmx, make)(dev_id), getattr(tmx, make)(dev_id)
        assert isinstance(t, tmx.Context)
        assert (t.device_type, t.device_id, t.device_typeid) == \
            (j.device_type, j.device_id, j.device_typeid)
        assert str(t) == str(j)
        assert t == tmx.Context(make, dev_id)
        assert hash(t) == hash(tmx.Context(t))
    assert tmx.cpu() == tmx.Context("cpu", 0)
    assert tmx.cpu() != tmx.gpu() and tmx.cpu(0) != tmx.cpu(1)
    assert len({tmx.cpu(), tmx.Context("cpu"), tmx.gpu()}) == 2


def test_context_devices():
    assert tmx.cpu().device == torch.device("cpu")
    assert tmx.cpu_pinned().device == torch.device("cpu")
    assert tmx.gpu(1).device == torch.device("cuda", 1)
    with pytest.raises(MXNetError, match="no TPU device"):
        tmx.tpu().device
    with pytest.raises(MXNetError, match="no TPU device"):
        tmx.nd.zeros((2,), ctx=tmx.tpu())
    assert tmx.context.as_device("cpu(0)") == torch.device("cpu")
    assert tmx.context.as_device(torch.device("cpu")) == torch.device("cpu")
    assert tmx.num_gpus() == torch.cuda.device_count()


def test_current_context_nests_and_unwinds_on_an_exception():
    for mx in (jmx, tmx):
        assert mx.current_context() == mx.cpu(0)
        with mx.gpu(1) as outer:
            assert mx.current_context() == outer == mx.gpu(1)
            with pytest.raises(ZeroDivisionError):
                with mx.cpu(2):
                    assert mx.current_context() == mx.cpu(2)
                    1 / 0
            assert mx.current_context() == mx.gpu(1)
        assert mx.current_context() == mx.cpu(0)


def test_scope_is_per_thread():
    seen = []
    with tmx.cpu(3):
        t = threading.Thread(target=lambda: seen.append(
            tmx.current_context()))
        t.start()
        t.join()
        assert tmx.current_context() == tmx.cpu(3)
    assert seen == [tmx.cpu(0)]


def test_outside_a_scope_creation_goes_to_the_card():
    """No silent CPU fallback: without ``ctx`` or a scope, creation asks
    for the card and raises where there is none."""
    if torch.cuda.is_available():
        assert tmx.nd.zeros((2,)).context == tmx.gpu(
            torch.cuda.current_device())
        return
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.nd.zeros((2,))
    with pytest.raises(MXNetError, match="CUDA is not available"):
        tmx.nd.array([1.0])
    with tmx.cpu():
        assert tmx.nd.array([1.0]).context == tmx.cpu()


def test_ndarray_context_is_a_context():
    a = tmx.nd.ones((2,), ctx=tmx.cpu())
    assert isinstance(a.context, tmx.Context) and a.ctx == tmx.cpu()
    assert a.as_in_context(tmx.cpu()) is a
    assert a.copyto(tmx.cpu()).context == tmx.cpu()
    # a context's own string names it too
    assert tmx.nd.zeros((1,), ctx="cpu(0)").context == tmx.cpu()


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("which", ["zeros", "ones"])
def test_sym_init_ops_match_the_reference(which, dtype):
    x = np.random.RandomState(0).randn(2, 3).astype(dtype)
    outs = []
    for mx in (jmx, tmx):
        s = getattr(mx.sym, which)((2, 3), dtype=dtype) * mx.sym.var("x")
        ex = s.bind(mx.cpu(), {"x": mx.nd.array(x, ctx=mx.cpu(),
                                                dtype=dtype)})
        out = ex.forward()[0]
        assert out.context.device_type == "cpu"
        outs.append(out.asnumpy())
        assert s.infer_shape(x=(2, 3))[1] == [(2, 3)]
        assert s.infer_type(x=np.dtype(dtype))[1] == [np.dtype(dtype)]
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[0].dtype == np.dtype(dtype)
