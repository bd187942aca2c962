"""Port parity: imperative autograd (``mx.autograd`` on torch's graph)
against mxnet_tpu's tape, on the same numpy inputs: the nine cases of
tests/test_autograd.py and the three autograd cases of
tests/test_custom_op.py (``autograd.Function``, a second derivative, the
Hessian-vector product). Each case runs in both packages and the arrays
it returns must agree within 1e-5 (both compute the same ops in float32
or float64, in another order)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

_TOL = dict(rtol=1e-5, atol=1e-6)


def _both(case):
    """Run ``case(mx, ctx)`` in each package; compare what it returns."""
    got = [case(jmx, jmx.cpu()), case(tmx, tmx.cpu())]
    assert len(got[0]) == len(got[1])
    for j, t in zip(*got):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), **_TOL)
    return got[1]


def test_simple_grad():
    def case(mx, cpu):
        x = mx.nd.array([1.0, 2.0, 3.0], ctx=cpu)
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
        y.backward()
        return [x.grad.asnumpy()]

    (g,) = _both(case)
    np.testing.assert_allclose(g, [2.0, 4.0, 6.0])


def test_chain_grad():
    def case(mx, cpu):
        x = mx.nd.array([[1.0, 2.0], [3.0, 4.0]], ctx=cpu)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.exp(x) * 2
            z = y.sum()
        z.backward()
        return [x.grad.asnumpy(), z.asnumpy()]

    g, _ = _both(case)
    np.testing.assert_allclose(g, 2 * np.exp([[1.0, 2.0], [3.0, 4.0]]),
                               rtol=1e-6)


def test_multiple_inputs():
    def case(mx, cpu):
        a = mx.nd.array([2.0], ctx=cpu)
        b = mx.nd.array([3.0], ctx=cpu)
        a.attach_grad()
        b.attach_grad()
        with mx.autograd.record():
            c = a * b + a
        c.backward()
        return [a.grad.asnumpy(), b.grad.asnumpy()]

    ga, gb = _both(case)
    np.testing.assert_allclose(ga, [4.0])
    np.testing.assert_allclose(gb, [2.0])


def test_training_modes():
    for mx in (jmx, tmx):
        ag = mx.autograd
        assert not ag.is_recording()
        with ag.record():
            assert ag.is_recording()
            assert ag.is_training()
        with ag.record(train_mode=False):
            assert not ag.is_training()
        with ag.pause():
            assert not ag.is_recording()
        with ag.train_mode():
            assert ag.is_training() and not ag.is_recording()
        with ag.predict_mode():
            assert not ag.is_training()
        assert ag.set_recording(True) is False
        assert ag.set_recording(False) is True
        assert ag.set_training(True) is False
        assert ag.set_training(False) is True


def test_training_flags_are_thread_local():
    import threading

    seen = []
    with tmx.autograd.record():
        t = threading.Thread(target=lambda: seen.append(
            (tmx.autograd.is_recording(), tmx.autograd.is_training())))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [(False, False)]


def test_detach():
    def case(mx, cpu):
        x = mx.nd.array([1.0, 2.0], ctx=cpu)
        x.attach_grad()
        with mx.autograd.record():
            y = x * 2
            z = y.detach() * x
        z.backward()
        return [x.grad.asnumpy()]

    (g,) = _both(case)
    np.testing.assert_allclose(g, [2.0, 4.0])


def test_retain_graph():
    """grad_req "write" overwrites: a second backward gives the same
    gradient, where torch alone would have accumulated it."""
    def case(mx, cpu):
        x = mx.nd.array([1.0, 2.0], ctx=cpu)
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
        y.backward(retain_graph=True)
        g1 = x.grad.asnumpy().copy()
        y.backward()
        return [g1, x.grad.asnumpy()]

    g1, g2 = _both(case)
    np.testing.assert_allclose(g2, g1)


def test_grad_req_add_accumulates():
    def case(mx, cpu):
        x = mx.nd.array([1.0, 2.0], ctx=cpu)
        x.attach_grad(grad_req="add")
        for _ in range(3):
            with mx.autograd.record():
                y = x * x
            y.backward()
        return [x.grad.asnumpy()]

    (g,) = _both(case)
    np.testing.assert_allclose(g, [6.0, 12.0])


def test_grad_with_head_gradient():
    def case(mx, cpu):
        x = mx.nd.array([1.0, 2.0, 3.0], ctx=cpu)
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
        y.backward(mx.nd.array([1.0, 2.0, 3.0], ctx=cpu))
        return [x.grad.asnumpy()]

    (g,) = _both(case)
    np.testing.assert_allclose(g, [2.0, 8.0, 18.0])


def test_mark_variables():
    def case(mx, cpu):
        x = mx.nd.array([1.0, 2.0], ctx=cpu)
        grad_x = mx.nd.zeros((2,), ctx=cpu)
        mx.autograd.mark_variables([x], [grad_x])
        with mx.autograd.record():
            y = (x * 2).sum()
        mx.autograd.backward([y])
        return [grad_x.asnumpy()]

    (g,) = _both(case)
    np.testing.assert_allclose(g, [2.0, 2.0])


def test_autograd_pause_inside_record():
    def case(mx, cpu):
        x = mx.nd.array([3.0], ctx=cpu)
        x.attach_grad()
        with mx.autograd.record():
            y = x * x
            with mx.autograd.pause():
                z = y * 2  # not recorded
            w = y + 1
        w.backward()
        return [x.grad.asnumpy(), z.asnumpy()]

    g, _ = _both(case)
    np.testing.assert_allclose(g, [6.0])


def test_grad_leaves_the_buffers_alone():
    def case(mx, cpu):
        x = mx.nd.array([1.0, 2.0], ctx=cpu)
        x.attach_grad()
        with mx.autograd.record():
            y = x * x * 3
        (g,) = mx.autograd.grad(y, [x])
        return [g.asnumpy(), x.grad.asnumpy()]

    g, buf = _both(case)
    np.testing.assert_allclose(g, [6.0, 12.0])
    np.testing.assert_allclose(buf, 0.0)


def test_backward_without_a_recording_raises():
    x = tmx.nd.array([1.0], ctx=tmx.cpu())
    x.attach_grad()
    y = x * 2                       # not recorded
    assert not y._data.requires_grad
    with pytest.raises(tmx.MXNetError):
        y.backward()


def test_autograd_function():
    def case(mx, cpu):
        class Sigmoid(mx.autograd.Function):
            def forward(self, x):
                y = 1.0 / (1.0 + mx.nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y)

        x = mx.nd.array(np.random.RandomState(0).uniform(-2, 2, (5,)),
                        ctx=cpu)
        x.attach_grad()
        with mx.autograd.record():
            y = Sigmoid()(x)
        y.backward()
        return [y.asnumpy(), x.grad.asnumpy()]

    y, g = _both(case)
    np.testing.assert_allclose(g, y * (1 - y), rtol=1e-6)


def test_higher_order_grad():
    """d2/dx2 of x^3 = 6x via create_graph."""
    def case(mx, cpu):
        x = mx.nd.array(np.array([1.0, 2.0, 3.0], np.float32), ctx=cpu)
        x.attach_grad()
        with mx.autograd.record():
            y = x * x * x
            (dy_dx,) = mx.autograd.grad(y, [x], create_graph=True)
        first = dy_dx.asnumpy()
        dy_dx.backward()
        return [first, x.grad.asnumpy()]

    first, second = _both(case)
    np.testing.assert_allclose(first, [3.0, 12.0, 27.0])
    np.testing.assert_allclose(second, [6.0, 12.0, 18.0])


def test_higher_order_grad_chain():
    """grad of (grad(f) . v): the Hessian-vector product."""
    def case(mx, cpu):
        x = mx.nd.array(np.array([0.5, -1.5], np.float32), ctx=cpu)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.nd.exp(x) * x
            (g,) = mx.autograd.grad(y, [x], create_graph=True)
            s = g * mx.nd.array(np.array([1.0, 2.0], np.float32), ctx=cpu)
        s.backward()
        return [x.grad.asnumpy()]

    (hv,) = _both(case)
    xs = np.array([0.5, -1.5])
    np.testing.assert_allclose(hv, [1.0, 2.0] * (2 + xs) * np.exp(xs),
                               rtol=1e-5)


def test_get_symbol_raises():
    with pytest.raises(NotImplementedError):
        tmx.autograd.get_symbol(tmx.nd.zeros((1,), ctx=tmx.cpu()))
