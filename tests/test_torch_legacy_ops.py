"""Port parity for the rest of the op registry on the CPU: the regression
heads, L2Normalization, LRN, InstanceNorm and the Sequence ops of
``ops/nn.py``; ``_full`` / ``_arange`` and ``nd.arange``; the legacy ops
(``Crop``, ``IdentityAttachKLSparseReg``, the ``_scatter_*`` nodes,
``_grad_add``, ``_identity_with_attr_like_rhs``, the ``*_v1`` and
``_linalg_*`` aliases); ``_contrib_fft`` / ``_contrib_ifft`` /
``_contrib_count_sketch``; ``nd.moveaxis``.

Each case runs the op in both packages under ``autograd.record()`` on the
same seeded numpy inputs, then backward with the same seeded head
gradients: outputs and input gradients within 1e-5 of each tensor's max
(NaNs and infinities in the same places).
"""
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
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), what
    inf = np.isinf(want)
    assert np.array_equal(got[inf], want[inf]), what
    got, want = got[~nan & ~inf], want[~nan & ~inf]
    if want.size == 0:
        return
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= TOL * (scale if scale > 0 else 1.0), \
        "%s: %.3g against max %.3g" % (what, err, scale)


def _run(mx, op, arrays, grad, attrs, seed=7, train=True):
    """(outputs, input gradients, inputs after the call) of ``op``."""
    ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
    ins = [mx.nd.array(a, **ctx) for a in arrays]
    for i in grad:
        ins[i].attach_grad()
    with mx.autograd.record(train_mode=train):
        out = _op(mx, op)(*ins, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    values = [o.asnumpy() for o in outs]
    if grad:
        rng = np.random.RandomState(seed)
        heads = [mx.nd.array(rng.randn(*v.shape).astype(np.float32), **ctx)
                 for v in values]
        mx.autograd.backward(outs, heads)
    return (values, [ins[i].grad.asnumpy() for i in grad],
            [a.asnumpy() for a in ins])


def _op(mx, name):
    """``mx.nd``'s function for a registry name: ``_contrib_X`` is
    ``nd.contrib.X``, other ``_``-names live in ``nd._internal``."""
    if name.startswith("_contrib_"):
        return getattr(mx.nd.contrib, name[len("_contrib_"):])
    if name.startswith("_"):
        return getattr(mx.nd._internal, name)
    return getattr(mx.nd, name)


def _rs(seed):
    return np.random.RandomState(seed)


def _randn(seed, *shape):
    return _rs(seed).randn(*shape).astype(np.float32)


def _lengths(seed, n, hi):
    return _rs(seed).randint(1, hi + 1, n).astype(np.float32)


CASES = [
    pytest.param("LinearRegressionOutput",
                 lambda: [_randn(1, 4, 3), _randn(2, 4, 3)], (0, 1),
                 dict(grad_scale=2.0), id="linear-regression"),
    pytest.param("LogisticRegressionOutput",
                 lambda: [_randn(3, 5, 2),
                          _rs(4).rand(5, 2).astype(np.float32)], (0, 1), {},
                 id="logistic-regression"),
    pytest.param("MAERegressionOutput",
                 lambda: [_randn(5, 6, 4), _randn(6, 6, 4)], (0, 1),
                 dict(grad_scale=0.5), id="mae-regression"),
    pytest.param("LinearRegressionOutput",
                 lambda: [_randn(7, 6, 1), _randn(8, 6)], (0,), {},
                 id="linear-regression-flat-label"),
    pytest.param("L2Normalization", lambda: [_randn(9, 3, 4, 5, 2)], (0,),
                 dict(mode="instance"), id="l2norm-instance"),
    pytest.param("L2Normalization", lambda: [_randn(10, 3, 4, 5)], (0,),
                 dict(mode="channel", eps=1e-4), id="l2norm-channel"),
    pytest.param("L2Normalization", lambda: [_randn(11, 2, 3, 4, 5)], (0,),
                 dict(mode="spatial"), id="l2norm-spatial"),
    pytest.param("LRN", lambda: [_randn(12, 2, 7, 4, 5)], (0,),
                 dict(nsize=3), id="lrn-3"),
    pytest.param("LRN", lambda: [_randn(13, 2, 6, 3, 3)], (0,),
                 dict(nsize=5, alpha=1e-3, beta=0.5, knorm=1.0), id="lrn-5"),
    pytest.param("InstanceNorm",
                 lambda: [_randn(14, 3, 4, 5, 6), _randn(15, 4),
                          _randn(16, 4)], (0, 1, 2), {}, id="instance-norm"),
    pytest.param("InstanceNorm",
                 lambda: [_randn(17, 2, 3, 7), _randn(18, 3), _randn(19, 3)],
                 (0, 1, 2), dict(eps=1e-5), id="instance-norm-1d"),
    pytest.param("SequenceMask", lambda: [_randn(20, 6, 4, 3)], (0,), {},
                 id="seqmask-nolen"),
    pytest.param("SequenceMask",
                 lambda: [_randn(21, 6, 4, 3), _lengths(22, 4, 6)], (0,),
                 dict(use_sequence_length=True, value=-1.5),
                 id="seqmask-len"),
    pytest.param("SequenceMask",
                 lambda: [_randn(23, 5, 3, 2), _lengths(24, 3, 5)], (),
                 dict(use_sequence_length=True, value=float("-inf")),
                 id="seqmask-neg-inf-nan"),
    pytest.param("SequenceLast", lambda: [_randn(25, 5, 3, 2)], (0,), {},
                 id="seqlast-nolen"),
    pytest.param("SequenceLast",
                 lambda: [_randn(26, 6, 4, 3), _lengths(27, 4, 6)], (0,),
                 dict(use_sequence_length=True), id="seqlast-len"),
    pytest.param("SequenceReverse", lambda: [_randn(28, 5, 3, 2)], (0,), {},
                 id="seqrev-nolen"),
    pytest.param("SequenceReverse",
                 lambda: [_randn(29, 6, 4, 3), _lengths(30, 4, 6)], (0,),
                 dict(use_sequence_length=True, axis=0), id="seqrev-len"),
    pytest.param("Crop", lambda: [_randn(31, 2, 3, 8, 9)], (0,),
                 dict(h_w=(4, 5), offset=(1, 2)), id="crop-hw"),
    pytest.param("Crop", lambda: [_randn(32, 2, 3, 8, 9)], (0,),
                 dict(h_w=(5, 4), center_crop=True), id="crop-center"),
    pytest.param("Crop",
                 lambda: [_randn(33, 2, 3, 8, 9), _randn(34, 2, 1, 6, 3)],
                 (0, 1), dict(num_args=2, offset=(2, 3)), id="crop-like"),
    pytest.param("IdentityAttachKLSparseReg",
                 lambda: [_rs(35).rand(4, 3, 2).astype(np.float32),
                          np.full(6, 0.2, np.float32)], (0,),
                 dict(sparseness_target=0.05, penalty=0.01, momentum=0.8),
                 id="kl-sparse-reg"),
    pytest.param("_grad_add", lambda: [_randn(36, 3, 4), _randn(37, 3, 4)],
                 (0, 1), {}, id="grad-add"),
    pytest.param("_identity_with_attr_like_rhs",
                 lambda: [_randn(38, 3, 4), _randn(39, 3, 4)], (0,), {},
                 id="identity-like-rhs"),
    pytest.param("_scatter_plus_scalar", lambda: [_randn(40, 3, 4)], (0,),
                 dict(scalar=1.5), id="scatter-plus"),
    pytest.param("_scatter_minus_scalar", lambda: [_randn(41, 3, 4)], (0,),
                 dict(scalar=0.25), id="scatter-minus"),
    pytest.param("_scatter_elemwise_div",
                 lambda: [_randn(42, 3, 4), _randn(43, 3, 4) + 3.0], (0, 1),
                 {}, id="scatter-div"),
    pytest.param("Convolution_v1",
                 lambda: [_randn(44, 2, 3, 6, 6), _randn(45, 4, 3, 3, 3),
                          _randn(46, 4)], (0, 1, 2),
                 dict(kernel=(3, 3), num_filter=4, pad=(1, 1)),
                 id="convolution-v1"),
    pytest.param("Pooling_v1", lambda: [_randn(47, 2, 3, 6, 6)], (0,),
                 dict(kernel=(2, 2), stride=(2, 2), pool_type="avg"),
                 id="pooling-v1"),
    pytest.param("_linalg_gemm2", lambda: [_randn(48, 3, 4), _randn(49, 4, 5)],
                 (0, 1), dict(alpha=0.5), id="linalg-gemm2-alias"),
    pytest.param("_contrib_fft", lambda: [_randn(50, 3, 8)], (0,), {},
                 id="fft"),
    pytest.param("_contrib_ifft", lambda: [_randn(51, 3, 16)], (0,), {},
                 id="ifft"),
    pytest.param("_contrib_count_sketch",
                 lambda: [_randn(52, 4, 10),
                          _rs(53).randint(0, 6, (1, 10)).astype(np.float32),
                          _rs(54).choice([-1.0, 1.0], (1, 10))
                          .astype(np.float32)],
                 (0,), dict(out_dim=6), id="count-sketch"),
]


@pytest.mark.parametrize("op,make,grad,attrs", CASES)
def test_op_matches_the_reference(op, make, grad, attrs):
    arrays = make()
    want, want_g, want_in = _run(jmx, op, arrays, grad, attrs)
    got, got_g, got_in = _run(tmx, op, arrays, grad, attrs)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, "%s out %d" % (op, i))
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        _close(g, w, "%s grad %d" % (op, i))
    # aux states written back (the KL regularizer's moving average)
    for i, (g, w) in enumerate(zip(got_in, want_in)):
        _close(g, w, "%s input %d after the call" % (op, i))


def test_sequence_mask_neg_inf_value_gives_nan_where_kept():
    x = _randn(60, 4, 2, 3)
    out = tmx.nd.SequenceMask(tmx.nd.array(x, ctx=tmx.cpu()),
                              tmx.nd.array([2.0, 4.0], ctx=tmx.cpu()),
                              use_sequence_length=True,
                              value=float("-inf")).asnumpy()
    assert np.isnan(out[:2]).all() and np.isnan(out[:, 1]).all()
    assert np.isneginf(out[2:, 0]).all()


def test_kl_sparse_reg_inference_keeps_the_moving_average():
    for mx, kw in ((jmx, {}), (tmx, {"ctx": tmx.cpu()})):
        avg = mx.nd.array(np.full(6, 0.2, np.float32), **kw)
        mx.nd.IdentityAttachKLSparseReg(
            mx.nd.array(_randn(61, 4, 6), **kw), avg)
        np.testing.assert_array_equal(avg.asnumpy(),
                                      np.full(6, 0.2, np.float32))


@pytest.mark.parametrize("args", [
    dict(start=5.0), dict(start=0.5, stop=3.0, step=0.5),
    dict(start=2.0, stop=11.0, step=3.0, repeat=3),
    dict(start=-1.0, stop=1.0, step=0.25, dtype="float64"),
    dict(start=0.0, stop=7.0, dtype="int32", repeat=2)])
def test_arange_matches_the_reference(args):
    want = jmx.nd.arange(**args).asnumpy()
    got = tmx.nd.arange(ctx=tmx.cpu(), **args).asnumpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    sym_args = dict(args)
    start = sym_args.pop("start")
    outs = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        s = mx.sym.arange(start, **sym_args)
        with ctx:
            outs.append(s.bind(ctx, {}).forward()[0].asnumpy())
        assert s.infer_shape()[1] == [want.shape]
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], want)


def test_full_matches_the_reference():
    outs = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        s = mx.sym._internal._full(shape=(2, 3), value=2.5, dtype="float32")
        with ctx:
            outs.append(s.bind(ctx, {}).forward()[0].asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])


def test_creation_ops_go_to_the_card_unless_asked():
    attrs = tmx.ops.registry.get_op("_arange").parse_attrs({"start": 3})
    if torch.cuda.is_available():
        assert tmx.ops.registry.get_op("_arange").fn(attrs).is_cuda
    else:
        with pytest.raises(tmx.base.MXNetError, match="CUDA"):
            tmx.ops.registry.get_op("_arange").fn(attrs)
        with pytest.raises(tmx.base.MXNetError, match="CUDA"):
            tmx.nd.arange(3)


def test_moveaxis_matches_the_reference():
    x = _randn(62, 2, 3, 4)
    outs, grads = [], []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": tmx.cpu()})):
        a = mx.nd.array(x, **kw)
        a.attach_grad()
        with mx.autograd.record():
            y = mx.nd.moveaxis(a, 0, 2) * 2
        y.backward(mx.nd.array(_randn(63, 3, 4, 2), **kw))
        outs.append(y.asnumpy())
        grads.append(a.grad.asnumpy())
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(grads[1], grads[0])


def test_symbolic_bind_of_a_sequence_and_regression_graph():
    """A graph of the ported ops through simple_bind's shape inference
    and the executor's backward, in both packages."""
    x, lab = _randn(64, 5, 3, 4), _randn(65, 3, 4)
    outs = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        d = mx.sym.var("data")
        s = mx.sym.SequenceLast(mx.sym.SequenceReverse(d))
        s = mx.sym.LinearRegressionOutput(mx.sym.L2Normalization(s),
                                          mx.sym.var("label"))
        ex = s.simple_bind(ctx, data=x.shape, label=lab.shape)
        ex.arg_dict["data"][:] = x
        ex.arg_dict["label"][:] = lab
        ex.forward(is_train=True)
        ex.backward()
        outs.append((ex.outputs[0].asnumpy(),
                     ex.grad_dict["data"].asnumpy()))
    _close(outs[1][0], outs[0][0], "output")
    _close(outs[1][1], outs[0][1], "data gradient")
