"""Port parity: every op the Gluon slice registers, forward and gradient,
against the JAX package's op on the same seeded numpy inputs.

Each case runs the op eagerly in both packages (``mx.nd`` /
``mx.nd._internal``) under ``autograd.record()`` with the float inputs
attached, then backward with the same seeded head gradient. Outputs and
input gradients agree within 1e-5 relative in fp32 (the same
elementwise math, and sums in another order); integer-valued outputs
(indices, comparisons, rounding) agree exactly. An op whose gradient is
zero or absent (comparisons, ``BlockGrad``, rounding) is differentiated
through ``op(x) + x``, so both sides must route the head to ``x`` alone.
The random ops and Dropout are held to moments in test_torch_random.py.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)

# the ops the port had before this slice, and the random ones (held to
# moments elsewhere): every other registered op needs a case here
_EARLIER = {
    "Activation", "BatchNorm", "Cast", "Convolution", "Custom", "Flatten",
    "FullyConnected", "Pooling", "Reshape", "Softmax", "SoftmaxOutput",
    "_FusedRegion", "_div_scalar", "_minus", "_minus_scalar", "_mul",
    "_mul_scalar", "_ones", "_plus", "_plus_scalar", "_rdiv_scalar",
    "_rminus_scalar", "_sub", "_zeros", "adam_update", "batch_dot",
    "broadcast_add", "broadcast_div", "broadcast_minus", "broadcast_mul",
    "broadcast_plus", "broadcast_sub", "cast", "dot", "elemwise_add",
    "elemwise_mul", "elemwise_sub", "exp", "flatten", "ftrl_update",
    "mp_sgd_mom_update", "mp_sgd_update", "relu", "reshape",
    "rmsprop_update", "rmspropalex_update", "rsqrt", "sgd_mom_update",
    "sgd_update", "sigmoid", "softmax", "softsign", "tanh", "transpose"}
_RANDOM = {
    "Dropout", "_random_exponential", "_random_gamma",
    "_random_generalized_negative_binomial", "_random_negative_binomial",
    "_random_normal", "_random_normal_like", "_random_poisson",
    "_random_uniform", "_random_uniform_like", "_sample_multinomial",
    "normal", "random_exponential", "random_gamma",
    "random_generalized_negative_binomial", "random_negative_binomial",
    "random_normal", "random_poisson", "random_uniform",
    "sample_multinomial", "uniform"}


def _arr(kind, shape, rng):
    """Seeded inputs on each op's domain."""
    if kind == "any":
        return rng.randn(*shape).astype(np.float32)
    if kind == "pos":
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    if kind == "unit":
        return rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    if kind == "ge1":
        return rng.uniform(1.1, 3.0, shape).astype(np.float32)
    if kind == "half":     # values on a 0.5 grid: ties, exact halves
        return (np.round(rng.randn(*shape) * 4) / 2).astype(np.float32)
    if kind == "nan":
        x = rng.randn(*shape).astype(np.float32)
        x.reshape(-1)[::5] = np.nan
        return x
    if kind.startswith("idx"):   # float indices in [0, n), MXNet's API
        n = int(kind[3:])
        return rng.randint(0, n, shape).astype(np.float32)
    if kind.startswith("oob"):   # indices past both ends: clip / wrap
        n = int(kind[3:])
        return rng.randint(-n, 2 * n, shape).astype(np.float32)
    raise ValueError(kind)


def case(op, inputs, grad=None, compose=False, **attrs):
    """``inputs``: [(kind, shape)]; ``grad``: the input positions to
    differentiate (default: every float input)."""
    if grad is None:
        grad = [i for i, (k, _s) in enumerate(inputs)
                if not k.startswith(("idx", "oob"))]
    label = "%s-%s" % (op, "-".join("%s=%s" % kv for kv in
                                    sorted(attrs.items())))
    return pytest.param(op, inputs, grad, compose, attrs, id=label)


_S = (3, 4)
_UNARY_DOMAINS = {
    "any": ["abs", "square", "cbrt", "exp", "expm1", "erf", "sin", "cos",
            "arctan", "degrees", "radians", "sinh", "cosh", "tanh",
            "arcsinh", "negative", "relu", "sigmoid", "softsign", "_copy",
            "identity", "make_loss", "MakeLoss"],
    "pos": ["sqrt", "rsqrt", "rcbrt", "log", "log10", "log2", "log1p",
            "gamma", "gammaln", "reciprocal"],
    "unit": ["arcsin", "arccos", "arctanh", "tan"],
    "ge1": ["arccosh"],
}
# zero / absent gradient: differentiated through op(x) + x
_NOGRAD_UNARY = ["sign", "rint", "round", "ceil", "floor", "trunc", "fix",
                 "logical_not", "BlockGrad", "stop_gradient", "zeros_like",
                 "ones_like"]
_CMP = ["equal", "not_equal", "greater", "greater_equal", "lesser",
        "lesser_equal"]

CASES = []
for _dom, _ops in _UNARY_DOMAINS.items():
    CASES += [case(o, [(_dom, _S)]) for o in _ops]
CASES += [case(o, [("half", _S)], compose=True) for o in _NOGRAD_UNARY]
CASES += [case("MakeLoss", [("any", _S)], grad_scale=0.5,
               normalization="batch")]
# same-shape binaries and their scalar forms
CASES += [case(o, [("any", _S), ("pos", _S)])
          for o in ("elemwise_div", "_div", "_maximum", "_minimum",
                    "_hypot")]
CASES += [case("_power", [("pos", _S), ("any", _S)]),
          case("_mod", [("any", _S), ("pos", _S)])]
CASES += [case("_" + c, [("half", _S), ("half", _S)], compose=True)
          for c in _CMP]
CASES += [case("_" + c + "_scalar", [("half", _S)], compose=True,
               scalar=0.5) for c in _CMP]
CASES += [case("_mod_scalar", [("any", _S)], scalar=0.7),
          case("_rmod_scalar", [("pos", _S)], scalar=1.3),
          case("_power_scalar", [("pos", _S)], scalar=2.5),
          case("_rpower_scalar", [("any", _S)], scalar=1.7),
          case("_maximum_scalar", [("any", _S)], scalar=0.1),
          case("_minimum_scalar", [("any", _S)], scalar=0.1),
          case("_hypot_scalar", [("any", _S)], scalar=0.6),
          case("smooth_l1", [("any", _S)], scalar=1.5),
          case("smooth_l1", [("any", _S)])]
CASES += [case(o, [("any", _S)] * 3) for o in ("add_n", "ElementWiseSum",
                                                 "_sum")]
# broadcasting binaries
_B = [("any", (2, 3, 4)), ("pos", (1, 3, 1))]
CASES += [case("broadcast_" + o, _B)
          for o in ("maximum", "minimum", "hypot")]
CASES += [case("broadcast_power", [("pos", (2, 3, 4)), ("any", (1, 3, 1))]),
          case("broadcast_mod", _B)]
CASES += [case("broadcast_" + c, [("half", (2, 3, 4)), ("half", (1, 3, 1))],
               compose=True) for c in _CMP]
# reductions: axis None / int / tuple / (), keepdims, exclude
_R = [("any", (2, 3, 4))]
for _op in ("sum", "mean", "prod", "max", "min", "nansum", "nanprod"):
    for _kw in ({}, {"axis": 1}, {"axis": (0, 2), "keepdims": True},
                {"axis": 1, "exclude": True}, {"axis": ()},
                {"axis": (), "exclude": True}, {"axis": -1, "keepdims": True}):
        CASES.append(case(_op, [("nan" if _op.startswith("nan") else "any",
                                 (2, 3, 4))], **_kw))
CASES += [case(o, _R, axis=1) for o in ("sum_axis", "max_axis", "min_axis")]
for _kw in ({}, {"ord": 1}, {"axis": 1}, {"axis": (0, 2), "keepdims": True},
            {"ord": 1, "axis": -1}, {"keepdims": True}):
    CASES.append(case("norm", _R, **_kw))
for _op in ("argmax", "argmin"):
    for _kw in ({}, {"axis": 1}, {"axis": 2, "keepdims": True},
                {"keepdims": True}):
        CASES.append(case(_op, _R, grad=[], **_kw))
CASES += [case("argmax_channel", _R, grad=[]),
          case("broadcast_to", [("any", (2, 1, 4))], shape=(2, 3, 4)),
          case("broadcast_to", [("any", (2, 1, 4))], shape=(0, 3, 0)),
          case("broadcast_axis", [("any", (2, 1, 1))], axis=(1, 2),
               size=(3, 4)),
          case("broadcast_axes", [("any", (2, 1, 4))], axis=1, size=3),
          case("broadcast_like", [("any", (2, 1, 4)), ("any", (2, 3, 4))])]
# matrix ops
_M = [("any", (2, 3, 4))]
CASES += [
    case("expand_dims", _M, axis=1), case("expand_dims", _M, axis=-1),
    case("SwapAxis", _M, dim1=0, dim2=2), case("swapaxes", _M, dim1=1),
    case("slice", _M, begin=(0, 1), end=(2, 3)),
    case("slice", _M, begin=(None, None, 3), end=(None, None, 0),
         step=(1, 1, -1)),
    case("slice", _M, begin=(1, None, 0), end=(None, 2, 4), step=(1, 1, 2)),
    case("crop", _M, begin=(0, 0, 1), end=(1, 2, 3)),
    case("slice_axis", _M, axis=2, begin=1, end=3),
    case("slice_axis", _M, axis=-2, begin=-2, end=None),
    case("reverse", _M, axis=1), case("flip", _M, axis=(0, 2)),
    case("repeat", _M, repeats=2, axis=1), case("repeat", _M, repeats=2),
    case("tile", _M, reps=(2, 1, 3)), case("tile", _M, reps=(2,)),
    case("clip", _M, a_min=-0.5, a_max=0.7),
    case("Concat", [("any", (2, 3, 4)), ("any", (2, 2, 4)),
                    ("any", (2, 1, 4))], dim=1),
    case("concat", [("any", (2, 3, 4)), ("any", (2, 3, 2))], dim=-1),
    case("SliceChannel", _M, num_outputs=2, axis=2),
    case("split", _M, num_outputs=3, axis=1, squeeze_axis=True),
    case("stack", [("any", (3, 4))] * 3, axis=1),
    case("stack", [("any", (3, 4))] * 2),
    case("where", [("idx2", (2, 3, 4)), ("any", (2, 3, 4)),
                   ("any", (2, 3, 4))], grad=[1, 2]),
    case("where", [("idx2", (2,)), ("any", (2, 3, 4)), ("any", (2, 3, 4))],
         grad=[1, 2]),
    case("reshape_like", [("any", (2, 6)), ("any", (3, 4))]),
    case("sort", _M), case("sort", _M, axis=1, is_ascend=False),
    case("argsort", _M, grad=[]),
    case("argsort", _M, axis=0, is_ascend=False, grad=[]),
    case("topk", _M, k=2, ret_typ="value"),
    case("topk", _M, k=2, axis=1, ret_typ="indices", grad=[]),
    case("topk", _M, k=3, ret_typ="both", is_ascend=True),
    case("_slice_assign", [("any", (3, 4)), ("any", (2, 2))],
         begin=(1, 0), end=(3, 4), step=(1, 2)),
    case("_crop_assign", [("any", (3, 4)), ("any", (3, 2))],
         begin=(None, 1), end=(None, 3)),
    case("_slice_assign_scalar", [("any", (3, 4))], begin=(0, 1),
         end=(2, 3), scalar=2.5),
    case("_crop_assign_scalar", [("any", (3, 4))], begin=(2, None),
         end=(None, None), scalar=-1.0),
]
# indexing
CASES += [
    case("take", [("any", (5, 3)), ("idx5", (2, 4))]),
    case("take", [("any", (5, 3)), ("oob5", (7,))], mode="wrap"),
    case("take", [("any", (4, 5)), ("oob5", (2, 3))], axis=1),
    case("Embedding", [("oob6", (2, 3)), ("any", (6, 4))], input_dim=6,
         output_dim=4),
    case("one_hot", [("oob4", (2, 3))], depth=4),
    case("one_hot", [("idx4", (5,))], depth=4, on_value=2.0,
         off_value=-1.0),
    case("pick", [("any", (3, 4)), ("oob4", (3,))]),
    case("pick", [("any", (3, 4, 2)), ("idx3", (4, 2))], axis=0),
    case("pick", [("any", (3, 4)), ("idx4", (3,))], keepdims=True),
    case("choose_element_0index", [("any", (3, 4)), ("idx4", (3,))]),
    case("batch_take", [("any", (3, 4)), ("oob4", (3,))]),
    case("batch_take", [("any", (2, 3, 4)), ("idx4", (2, 3))]),
    case("gather_nd", [("any", (3, 4, 2)), ("idx3", (2, 5))]),
    case("scatter_nd", [("any", (4,)), ("idx3", (2, 4))], shape=(3, 3)),
]
# neural-network ops
CASES += [
    case("Deconvolution", [("any", (2, 4, 5, 6)), ("any", (4, 3, 3, 3))],
         kernel=(3, 3), num_filter=3),
    case("Deconvolution", [("any", (2, 4, 5, 6)), ("any", (4, 3, 3, 3)),
                           ("any", (6,))],
         kernel=(3, 3), stride=(2, 2), pad=(1, 1), adj=(1, 0), num_filter=6,
         num_group=2, no_bias=False),
    case("Deconvolution", [("any", (2, 4, 7)), ("any", (4, 2, 3))],
         kernel=(3,), stride=(2,), dilate=(2,), target_shape=(18,),
         num_filter=2),
    case("Deconvolution", [("any", (1, 2, 3, 4, 3)), ("any", (2, 2, 2, 2, 2))],
         kernel=(2, 2, 2), stride=(2, 1, 2), num_filter=2),
    case("LeakyReLU", _M), case("LeakyReLU", _M, slope=0.1),
    case("LeakyReLU", _M, act_type="elu", slope=0.7),
    case("LeakyReLU", [("any", (2, 3, 4)), ("pos", (3,))],
         act_type="prelu"),
    case("log_softmax", _M), case("log_softmax", _M, axis=1,
                                  temperature=2.0),
    case("SoftmaxActivation", _M),
    case("SoftmaxActivation", _M, mode="channel"),
    case("Pad", [("any", (2, 3, 4, 5))], mode="constant",
         pad_width=(0, 0, 0, 0, 1, 2, 2, 1), constant_value=0.5),
    case("pad", [("any", (2, 3, 4, 5))], mode="edge",
         pad_width=(0, 0, 0, 0, 1, 2, 2, 1)),
    case("pad", [("any", (2, 3, 4, 5))], mode="reflect",
         pad_width=(0, 0, 0, 0, 2, 1, 1, 3)),
    case("softmax_cross_entropy", [("any", (4, 5)), ("idx5", (4,))]),
]


def _fn(mx, op):
    return getattr(mx.nd._internal if op.startswith("_") else mx.nd, op)


def _run(mx, op, arrays, grad, compose, attrs, ctx):
    ins = [mx.nd.array(a, dtype=a.dtype, **ctx) for a in arrays]
    for i in grad:
        ins[i].attach_grad()
    with mx.autograd.record():
        out = _fn(mx, op)(*ins, **attrs)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        if compose:
            outs = [outs[0] + ins[0]]
    values = [o.asnumpy() for o in outs]
    if not grad:
        return values, []
    rng = np.random.RandomState(7)
    heads = [mx.nd.array(np.asarray(rng.randn(*o.shape), np.float32), **ctx)
             for o in outs]
    mx.autograd.backward(outs, heads)
    return values, [ins[i].grad.asnumpy() for i in grad]


@pytest.mark.parametrize("op,inputs,grad,compose,attrs", CASES)
def test_op_matches_the_jax_op(op, inputs, grad, compose, attrs):
    rng = np.random.RandomState(0)
    arrays = [_arr(kind, shape, rng) for kind, shape in inputs]
    want, want_g = _run(jmx, op, arrays, grad, compose, attrs, {})
    with tmx.cpu():
        got, got_g = _run(tmx, op, arrays, grad, compose, attrs,
                          {"ctx": tmx.cpu()})
    assert len(got) == len(want)
    for g, w in zip(got + got_g, want + want_g):
        assert g.shape == w.shape
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **TOL)


def test_every_new_op_has_a_case():
    covered = {p.values[0] for p in CASES}
    new = set(tmx.ops.list_ops()) - _EARLIER - _RANDOM
    # _scatter_set_nd backs indexed assignment: its own test below; the
    # fused RNN (a later slice) has its grid in tests/test_torch_rnn.py,
    # the detection and spatial ops theirs in tests/test_torch_detection.py
    # and tests/test_torch_spatial.py; the linalg, legacy, contrib and
    # fork ops (and the nn.py / init_ops.py ops and *_v1 aliases of the
    # same slice) theirs in tests/test_torch_linalg.py,
    # test_torch_legacy_ops.py, test_torch_ctc.py and
    # test_torch_fork_ops.py
    from mxnet_tpu_torch.ops import (contrib, detection, fork_ops,
                                     legacy_ops, linalg, spatial)

    later = {n for n, d in tmx.ops.OP_REGISTRY.items()
             if d.fn.__module__ in (detection.__name__, spatial.__name__,
                                    contrib.__name__, fork_ops.__name__,
                                    legacy_ops.__name__, linalg.__name__)}
    # (the fork's two heads are built by ops/nn.py's ``loss_head``)
    later |= {"LinearRegressionOutput", "LogisticRegressionOutput",
              "MAERegressionOutput", "MultiLogistic", "WeightedL1",
              "L2Normalization", "LRN",
              "InstanceNorm", "SequenceMask", "SequenceLast",
              "SequenceReverse", "_full", "_arange", "Convolution_v1",
              "Pooling_v1", "BatchNorm_v1"}
    assert new - covered - later == {"_scatter_set_nd", "RNN"}, \
        sorted(new - covered - later)


def test_scatter_set_nd_matches():
    rng = np.random.RandomState(3)
    lhs = rng.randn(3, 4).astype(np.float32)
    rhs = rng.randn(2).astype(np.float32)
    idx = np.array([[0, 2], [1, 3]], np.float32)
    want = jmx.nd._internal._scatter_set_nd(
        jmx.nd.array(lhs), jmx.nd.array(rhs), jmx.nd.array(idx),
        shape=(3, 4)).asnumpy()
    with tmx.cpu():
        got = tmx.nd._internal._scatter_set_nd(
            tmx.nd.array(lhs), tmx.nd.array(rhs), tmx.nd.array(idx),
            shape=(3, 4)).asnumpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op,a,b", [
    ("__pow__", "pos", 2.5), ("__rpow__", "any", 1.5),
    ("__mod__", "any", 0.7),
    ("__gt__", "half", 0.5), ("__ge__", "half", 0.5),
    ("__lt__", "half", 0.5), ("__le__", "half", 0.5),
    ("__eq__", "half", 0.5), ("__ne__", "half", 0.5),
    ("__pow__", "pos", "any"), ("__mod__", "any", "pos"),
    ("__gt__", "half", "half"), ("__eq__", "half", "half")])
def test_ndarray_operators(op, a, b):
    rng = np.random.RandomState(1)
    x = _arr(a, _S, rng)
    y = _arr(b, _S, rng) if isinstance(b, str) else b

    def run(mx, ctx):
        lhs = mx.nd.array(x, **ctx)
        rhs = mx.nd.array(y, **ctx) if isinstance(b, str) else y
        return getattr(lhs, op)(rhs).asnumpy()

    with tmx.cpu():
        got = run(tmx, {"ctx": tmx.cpu()})
    np.testing.assert_allclose(got, run(jmx, {}), **TOL)


@pytest.mark.parametrize("expr", [
    lambda F, x, y: x ** 2.0 + (x > 0.0) * y - (y <= x) / (2.0 + x * x),
    lambda F, x, y: 1.0 / (1.0 + F.exp(-x)) + (y ** 2.0 >= x),
])
def test_symbol_operators_match_the_jax_graph(expr):
    rng = np.random.RandomState(2)
    x = rng.randn(*_S).astype(np.float32)
    y = rng.randn(*_S).astype(np.float32)

    def run(mx, ctx):
        s = expr(mx.sym, mx.sym.var("x"), mx.sym.var("y"))
        ex = s.bind(ctx, {"x": mx.nd.array(x, ctx=ctx),
                          "y": mx.nd.array(y, ctx=ctx)})
        return ex.forward()[0].asnumpy()

    np.testing.assert_allclose(run(tmx, tmx.cpu()), run(jmx, jmx.cpu()),
                               **TOL)
