"""Port parity for the fork's research ops (``ops/fork_ops.py``): LSoftmax,
MultiLogistic, WeightedL1, nAvg, SPN, SCN, Correlation1D and Correlation,
against the JAX package's on the same seeded numpy inputs on the CPU.

Each case runs the op in both packages under ``autograd.record()`` (train
mode: LSoftmax applies its margin there only), then backward with the
same seeded head gradients: outputs and input gradients within 1e-5 of
each tensor's max. The heads' gradients are their stated formulas; the
rest are autograd against the JAX package's autodiff. SPN and SCN run in
all four scan directions; the correlations at several strides, kernel
sizes, pads and displacement sides.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= TOL * (scale if scale > 0 else 1.0), \
        "%s: %.3g against max %.3g" % (what, err, scale)


def _run(mx, op, arrays, grad, attrs, seed=7, train=True):
    ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
    ins = [mx.nd.array(a, **ctx) for a in arrays]
    for i in grad:
        ins[i].attach_grad()
    with mx.autograd.record(train_mode=train):
        out = getattr(mx.nd, op)(*ins, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    values = [o.asnumpy() for o in outs]
    rng = np.random.RandomState(seed)
    mx.autograd.backward(outs, [
        mx.nd.array(rng.randn(*v.shape).astype(np.float32), **ctx)
        for v in values])
    return values, [ins[i].grad.asnumpy() for i in grad]


def _rs(seed):
    return np.random.RandomState(seed)


def _randn(seed, *shape):
    return _rs(seed).randn(*shape).astype(np.float32)


def _lsoftmax_inputs(seed, n=6, d=5, m=4):
    r = _rs(seed)
    return [r.randn(n, d).astype(np.float32), r.randn(m, d).astype(np.float32),
            r.randint(0, m, n).astype(np.float32)]


def _lsoftmax_boundary():
    """Rows at the segment boundaries of margin 2 (cos t = 0) and margin
    4 (cos t = cos(pi/4), sqrt(2)/2): each resolves to the smaller
    segment through the 1e-5 eps."""
    x = np.array([[1.0, 0.0], [0.0, 2.0], [1.0, 1.0], [2.0, 0.0]],
                 np.float32)
    w = np.array([[0.0, 3.0], [1.0, 0.0], [0.0, 1.0]], np.float32)
    return [x, w, np.array([0, 1, 2, 1], np.float32)]


def _gates(seed, n, c, h, w, k=3):
    r = _rs(seed)
    g = r.uniform(-0.4, 0.4, (k, n, c, h, w)).astype(np.float32)
    return [r.randn(n, c, h, w).astype(np.float32)] + list(g)


def _scan_cases():
    out = []
    for op in ("SPN", "SCN"):
        for horizontal in (False, True):
            for reverse in (False, True):
                def make(op=op):
                    arrs = _gates(11, 2, 3, 5, 6)
                    if op == "SCN":
                        arrs.append(_rs(12).rand(2, 3, 5, 6)
                                    .astype(np.float32))
                    return arrs
                out.append(pytest.param(
                    op, make, (0, 1, 2, 3, 4) if op == "SCN" else
                    (0, 1, 2, 3), dict(horizontal=horizontal,
                                       reverse=reverse),
                    id="%s-h%d-r%d" % (op.lower(), horizontal, reverse)))
    return out


CASES = [
    pytest.param("LSoftmax", lambda: _lsoftmax_inputs(1), (0, 1),
                 dict(num_hidden=4, margin=2, beta=1.0), id="lsoftmax-m2"),
    pytest.param("LSoftmax", lambda: _lsoftmax_inputs(2), (0, 1),
                 dict(num_hidden=4, margin=3, beta=0.5), id="lsoftmax-m3"),
    pytest.param("LSoftmax", lambda: _lsoftmax_inputs(3, n=8, m=5), (0, 1),
                 dict(num_hidden=5, margin=4, beta=0.0), id="lsoftmax-m4"),
    pytest.param("LSoftmax", _lsoftmax_boundary, (0, 1),
                 dict(num_hidden=3, margin=2, beta=0.0),
                 id="lsoftmax-boundary-m2"),
    pytest.param("LSoftmax", _lsoftmax_boundary, (0, 1),
                 dict(num_hidden=3, margin=4, beta=0.0),
                 id="lsoftmax-boundary-m4"),
    pytest.param("MultiLogistic",
                 lambda: [_randn(4, 5, 3),
                          _rs(5).randint(0, 2, (5, 3)).astype(np.float32)],
                 (0, 1), dict(grad_scale=0.5, weight=3.0),
                 id="multi-logistic"),
    pytest.param("WeightedL1",
                 lambda: [_randn(6, 4, 6),
                          np.maximum(_randn(7, 4, 6), 0)], (0, 1),
                 dict(grad_scale=2.0), id="weighted-l1"),
    pytest.param("nAvg", lambda: [_randn(8, 2, 5, 3, 4) + 0.8], (0,),
                 dict(threshold=1.0), id="navg"),
    pytest.param("nAvg", lambda: [_randn(9, 2, 4, 3, 3)], (0,),
                 dict(threshold=5.0), id="navg-none-above"),
    *_scan_cases(),
    pytest.param("Correlation1D",
                 lambda: [_randn(13, 2, 3, 4, 9), _randn(14, 2, 3, 4, 9)],
                 (0, 1), dict(max_displacement=2, pad_size=2),
                 id="corr1d"),
    pytest.param("Correlation1D",
                 lambda: [_randn(15, 2, 3, 5, 10), _randn(16, 2, 3, 5, 10)],
                 (0, 1), dict(kernel_size=3, max_displacement=2,
                              stride2=2, pad_size=3), id="corr1d-k3-s2"),
    pytest.param("Correlation1D",
                 lambda: [_randn(17, 1, 2, 3, 8), _randn(18, 1, 2, 3, 8)],
                 (0, 1), dict(max_displacement=3, pad_size=3,
                              single_side=1), id="corr1d-right"),
    pytest.param("Correlation1D",
                 lambda: [_randn(19, 1, 2, 3, 8), _randn(20, 1, 2, 3, 8)],
                 (0, 1), dict(max_displacement=3, pad_size=3,
                              single_side=-1), id="corr1d-left"),
    pytest.param("Correlation",
                 lambda: [_randn(21, 2, 3, 6, 7), _randn(22, 2, 3, 6, 7)],
                 (0, 1), dict(max_displacement=2, pad_size=2),
                 id="corr2d"),
    pytest.param("Correlation",
                 lambda: [_randn(23, 1, 4, 9, 9), _randn(24, 1, 4, 9, 9)],
                 (0, 1), dict(kernel_size=3, max_displacement=2, stride1=2,
                              stride2=2, pad_size=3), id="corr2d-k3-strided"),
    pytest.param("Correlation",
                 lambda: [_randn(25, 2, 2, 5, 6), _randn(26, 2, 2, 5, 6)],
                 (0, 1), dict(max_displacement=1, pad_size=1,
                              is_multiply=False), id="corr2d-abs"),
]


@pytest.mark.parametrize("op,make,grad,attrs", CASES)
def test_fork_op_matches_the_reference(op, make, grad, attrs):
    arrays = make()
    want, want_g = _run(jmx, op, arrays, grad, attrs)
    got, got_g = _run(tmx, op, arrays, grad, attrs)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, "%s out %d" % (op, i))
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        _close(g, w, "%s grad %d" % (op, i))


def test_lsoftmax_predict_mode_is_the_plain_product():
    x, w, lab = _lsoftmax_inputs(30)
    outs = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": tmx.cpu()})):
        out = mx.nd.LSoftmax(*[mx.nd.array(a, **kw) for a in (x, w, lab)],
                             num_hidden=4, margin=3)
        outs.append([o.asnumpy() for o in out])
    for g, want in zip(outs[1], outs[0]):
        _close(g, want)
    _close(outs[1][0], x @ w.T, "plain product")


def test_lsoftmax_margin_two_matches_the_closed_form():
    """At margin 2 the target logit is ((-1)^k cos 2t - 2k) |x||w| with
    k = [cos t < 0] (beta 0)."""
    x, w, lab = _lsoftmax_inputs(31)
    with tmx.autograd.record():
        out = tmx.nd.LSoftmax(*[tmx.nd.array(a, ctx=tmx.cpu())
                                for a in (x, w, lab)], num_hidden=4,
                              margin=2, beta=0.0)[0].asnumpy()
    for n, y in enumerate(lab.astype(int)):
        xn, wn = np.linalg.norm(x[n]), np.linalg.norm(w[y])
        cos = float(x[n] @ w[y]) / (xn * wn)
        k = 1 if cos < math.cos(math.pi / 2) - 1e-5 else 0
        want = ((-1) ** k * math.cos(2 * math.acos(cos)) - 2 * k) * xn * wn
        assert abs(out[n, y] - want) <= 1e-4 * max(1.0, abs(want))


def test_correlation_output_channels_follow_the_displacement_grid():
    """Channel tc of a kernel-1 correlation is the channel mean of data1
    times data2 shifted by ((tc // 3) - 1, (tc % 3) - 1)."""
    a, b = _randn(32, 1, 2, 5, 6), _randn(33, 1, 2, 5, 6)
    out = tmx.nd.Correlation(tmx.nd.array(a, ctx=tmx.cpu()),
                             tmx.nd.array(b, ctx=tmx.cpu()),
                             max_displacement=1, pad_size=1).asnumpy()
    bp = np.pad(b, ((0, 0), (0, 0), (1, 1), (1, 1)))
    for tc in range(9):
        dy, dx = tc // 3 - 1, tc % 3 - 1
        want = (a * bp[:, :, 1 + dy:6 + dy, 1 + dx:7 + dx]).mean(axis=1)
        np.testing.assert_allclose(out[:, tc], want, rtol=1e-5, atol=1e-6)
