"""Port parity for Gluon (mxnet_tpu_torch/gluon) against the JAX package's
Gluon on the same seeded numpy inputs: Parameter and ParameterDict,
deferred initialization, hybridized against imperative, every layer and
loss against the JAX block with the JAX net's weights carried across
(``gluon_params_from_jax``), SymbolBlock, ``.params`` files across the
packages bit for bit, and the model zoo's ResNets.

Tolerance: rtol = atol = 1e-5 in fp32 for outputs, input gradients and
parameter gradients (the same math; sums in another order), but for the
gradients of the net with two training-mode BatchNorms in a row: those
are held at 1e-2 of each tensor's max |value|, the bar of the port's
ResNet fit (test_torch_resnet_train.py). Each BatchNorm computes its
variance as E[x^2] - E[x]^2 in fp32, and over the second one's 18 samples
of positive-mean inputs that difference cancels, so the two packages' sums
in another order move the gradients by ~1e-3 of their max. The block
name counters are per process in both packages, so every net is built
with an explicit prefix and weights move by stripped name.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = tmx.cpu()


def _ctx(mx):
    return {"ctx": CPU} if mx is tmx else {}


def _rng(seed=0):
    return np.random.RandomState(seed)


def _stripped(net):
    cut = len(net.prefix)
    return {k[cut:]: p for k, p in net.collect_params().items()}


# --- Parameter / ParameterDict ------------------------------------------------

def test_parameter_replicas_grads_and_mutation():
    p = tmx.gluon.Parameter("weight", shape=(2, 3))
    p.initialize(init=tmx.init.One(), ctx=[tmx.cpu(0), tmx.cpu(1)])
    assert len(p.list_data()) == 2 and len(p.list_grad()) == 2
    assert p.data(tmx.cpu(1)).context == CPU
    np.testing.assert_array_equal(p.list_data()[0].asnumpy(),
                                  np.ones((2, 3)))
    p.set_data(np.full((2, 3), 4.0, np.float32))
    for arr in p.list_data():
        np.testing.assert_array_equal(arr.asnumpy(), np.full((2, 3), 4.0))
    p.list_grad()[0][:] = 1.0
    p.zero_grad()
    assert (p.list_grad()[0].asnumpy() == 0).all()
    p.cast("float16")
    assert p.list_data()[0].dtype == np.float16
    p.grad_req = "null"
    with pytest.raises(RuntimeError):
        p.grad()
    assert p.list_ctx() == [tmx.cpu(0), tmx.cpu(1)]
    p.reset_ctx(CPU)
    assert p.list_ctx() == [CPU]


def test_parameter_deferred_init():
    for mx in (jmx, tmx):
        p = mx.gluon.Parameter("weight", shape=(0, 3),
                               allow_deferred_init=True)
        p.initialize(ctx=mx.cpu())
        with pytest.raises(mx.gluon.DeferredInitializationError):
            p.data()
        p.shape = (4, 3)
        p._finish_deferred_init()
        assert p.data().shape == (4, 3)
        with pytest.raises(ValueError):
            mx.gluon.Parameter("bias", shape=(0, 3)).initialize(
                ctx=mx.cpu())


def test_parameter_init_matches_the_jax_package():
    out = []
    for mx in (jmx, tmx):
        np.random.seed(3)
        d = mx.gluon.ParameterDict("net_")
        d.get("weight", shape=(5, 4))
        d.get("bias", shape=(5,), init="zeros")
        d.initialize(mx.init.Xavier(), **_ctx(mx))
        out.append({k: v.data().asnumpy() for k, v in d.items()})
    assert out[0].keys() == out[1].keys()
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k])


def test_parameter_dict_get_merge_and_save_load(tmp_path):
    d = tmx.gluon.ParameterDict("net_")
    w = d.get("weight", shape=(0, 3))
    assert d.get("weight", shape=(2, 0)) is w and w.shape == (2, 3)
    with pytest.raises(AssertionError):
        d.get("weight", shape=(4, 3))
    d.get("bias", shape=(2,))
    d.initialize(tmx.init.Uniform(), ctx=CPU)
    f = str(tmp_path / "p.params")
    d.save(f, strip_prefix="net_")
    e = tmx.gluon.ParameterDict("net_")
    e.get("weight", shape=(2, 3))
    e.get("bias", shape=(2,))
    e.load(f, ctx=CPU, restore_prefix="net_")
    for k in d.keys():
        np.testing.assert_array_equal(d[k].data().asnumpy(),
                                      e[k].data().asnumpy())
    extra = tmx.gluon.ParameterDict("net_")
    extra.get("weight", shape=(2, 3))
    with pytest.raises(AssertionError):
        extra.load(f, ctx=CPU, restore_prefix="net_")
    extra.load(f, ctx=CPU, restore_prefix="net_", ignore_extra=True)
    more = tmx.gluon.ParameterDict("net_")
    for k in ("weight", "bias", "gamma"):
        more.get(k, shape=(2,) if k != "weight" else (2, 3))
    with pytest.raises(AssertionError):
        more.load(f, ctx=CPU, restore_prefix="net_")


def test_block_names_match_the_jax_package():
    def build(mx):
        net = mx.gluon.nn.HybridSequential(prefix="model_")
        with net.name_scope():
            net.add(mx.gluon.nn.Conv2D(4, 3), mx.gluon.nn.BatchNorm(),
                    mx.gluon.nn.Dense(2, activation="relu"))
        return net

    names = [sorted(build(mx).collect_params().keys()) for mx in (jmx, tmx)]
    assert names[0] == names[1]


# --- layers against the JAX blocks --------------------------------------------

def _mlp(mx):
    net = mx.gluon.nn.HybridSequential(prefix="mlp_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, activation="relu"),
                mx.gluon.nn.Dense(5, activation="tanh"),
                mx.gluon.nn.Dense(3, use_bias=False))
    return net


def _convnet(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="conv_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(2),
                nn.Conv2D(6, 3, strides=2, groups=2, use_bias=False),
                nn.BatchNorm(scale=False, center=False), nn.Flatten(),
                nn.Dense(3))
    return net


def _single(make):
    def build(mx):
        net = mx.gluon.nn.HybridSequential(prefix="one_")
        with net.name_scope():
            net.add(make(mx.gluon.nn))
        return net
    return build


# (builder, input shapes, index inputs, train mode)
LAYERS = {
    "mlp": (_mlp, [(4, 6)], False),
    "convnet_train": (_convnet, [(2, 3, 9, 9)], True),
    "convnet_predict": (_convnet, [(2, 3, 9, 9)], False),
    "dense_flatten": (_single(lambda nn: nn.Dense(5, in_units=12)),
                      [(2, 3, 4)], False),
    "dense_no_flatten": (_single(lambda nn: nn.Dense(
        3, use_bias=False, flatten=False)), [(2, 3, 4)], False),
    "activation_sigmoid": (_single(lambda nn: nn.Activation("sigmoid")),
                           [(3, 4)], False),
    "activation_softrelu": (_single(lambda nn: nn.Activation("softrelu")),
                            [(3, 4)], False),
    "leaky_relu": (_single(lambda nn: nn.LeakyReLU(0.1)), [(3, 4)], False),
    "dropout_predict": (_single(lambda nn: nn.Dropout(0.5)), [(3, 4)],
                        False),
    "batchnorm_train": (_single(lambda nn: nn.BatchNorm(in_channels=3)),
                        [(4, 3, 5)], True),
    "batchnorm_axis_last": (_single(lambda nn: nn.BatchNorm(
        axis=-1, momentum=0.7, epsilon=1e-3)), [(4, 5, 3)], True),
    "batchnorm_predict": (_single(lambda nn: nn.BatchNorm()), [(4, 3, 5)],
                          False),
    "flatten": (_single(lambda nn: nn.Flatten()), [(2, 3, 4)], False),
    "conv1d": (_single(lambda nn: nn.Conv1D(4, 3, strides=2, padding=1)),
               [(2, 3, 9)], False),
    "conv2d_dilated_groups": (_single(lambda nn: nn.Conv2D(
        6, 3, dilation=2, groups=3, in_channels=3, activation="relu")),
        [(2, 3, 9, 8)], False),
    "conv3d": (_single(lambda nn: nn.Conv3D(2, (2, 3, 2), padding=(1, 0, 1))),
               [(1, 3, 4, 5, 4)], False),
    "conv1d_transpose": (_single(lambda nn: nn.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1)), [(2, 4, 7)], False),
    "conv2d_transpose": (_single(lambda nn: nn.Conv2DTranspose(
        4, (3, 2), strides=(2, 1), groups=2, in_channels=4,
        activation="relu")), [(2, 4, 5, 6)], False),
    "conv3d_transpose": (_single(lambda nn: nn.Conv3DTranspose(
        2, 2, strides=2, use_bias=False)), [(1, 3, 2, 3, 2)], False),
    "maxpool1d": (_single(lambda nn: nn.MaxPool1D(3, 2, 1)), [(2, 3, 9)],
                  False),
    "maxpool2d_ceil": (_single(lambda nn: nn.MaxPool2D(3, 2, 0,
                                                       ceil_mode=True)),
                       [(2, 3, 8, 8)], False),
    "maxpool3d": (_single(lambda nn: nn.MaxPool3D()), [(1, 2, 4, 4, 4)],
                  False),
    "avgpool1d": (_single(lambda nn: nn.AvgPool1D(2)), [(2, 3, 8)], False),
    "avgpool2d": (_single(lambda nn: nn.AvgPool2D(3, 2, 1)),
                  [(2, 3, 9, 9)], False),
    "avgpool3d": (_single(lambda nn: nn.AvgPool3D(2)), [(1, 2, 4, 4, 4)],
                  False),
    "global_avg1d": (_single(lambda nn: nn.GlobalAvgPool1D()), [(2, 3, 7)],
                     False),
    "global_avg2d": (_single(lambda nn: nn.GlobalAvgPool2D()),
                     [(2, 3, 5, 6)], False),
    "global_avg3d": (_single(lambda nn: nn.GlobalAvgPool3D()),
                     [(1, 2, 3, 4, 5)], False),
    "global_max1d": (_single(lambda nn: nn.GlobalMaxPool1D()), [(2, 3, 7)],
                     False),
    "global_max2d": (_single(lambda nn: nn.GlobalMaxPool2D()),
                     [(2, 3, 5, 6)], False),
    "global_max3d": (_single(lambda nn: nn.GlobalMaxPool3D()),
                     [(1, 2, 3, 4, 5)], False),
    "hybrid_lambda_name": (_single(lambda nn: nn.HybridLambda("tanh")),
                           [(3, 4)], False),
    "hybrid_lambda_fn": (_single(lambda nn: nn.HybridLambda(
        lambda F, x: F.sigmoid(x) * 2 + F.square(x))), [(3, 4)], False),
}


def _forward_backward(mx, net, arrays, train, hybrid, idx=()):
    ctx = _ctx(mx)
    if hybrid:
        net.hybridize()
    ins = [mx.nd.array(a, **ctx) for a in arrays]
    for i, x in enumerate(ins):
        if i not in idx:
            x.attach_grad()
    with mx.autograd.record(train_mode=train):
        out = net(*ins)
    head = mx.nd.array(_rng(5).randn(*out.shape).astype(np.float32), **ctx)
    out.backward(head)
    grads = {k: p.grad().asnumpy() for k, p in _stripped(net).items()
             if p.grad_req != "null"}
    values = {k: p.data().asnumpy() for k, p in _stripped(net).items()}
    return ([out.asnumpy()] + [x.grad.asnumpy() for i, x in enumerate(ins)
                               if i not in idx], grads, values)


def _carried(build, arrays):
    """The JAX net initialised and run once (deferred shapes), and the
    port's net with its weights."""
    np.random.seed(0)
    jnet = build(jmx)
    jnet.initialize(jmx.init.Xavier(magnitude=2.0))
    jnet(*[jmx.nd.array(a) for a in arrays])
    tnet = build(tmx)
    tnet.initialize(ctx=CPU)
    tmx.gluon_params_from_jax(jnet, tnet)
    return jnet, tnet


def _compare(got, want, grad_bar=None):
    g_out, g_grads, g_vals = got
    w_out, w_grads, w_vals = want
    for a, b in zip(g_out, w_out):
        np.testing.assert_allclose(a, b, **TOL)
    assert g_grads.keys() == w_grads.keys()
    for k in w_grads:
        if grad_bar is None:
            np.testing.assert_allclose(g_grads[k], w_grads[k], err_msg=k,
                                       **TOL)
        else:
            # (a conv bias before a training BatchNorm has a gradient
            # of 0 up to rounding: the absolute bar holds it)
            err = np.abs(g_grads[k] - w_grads[k]).max()
            assert err <= max(grad_bar * np.abs(w_grads[k]).max(),
                              TOL["atol"]), (k, err)
    for k in w_vals:   # aux states after the forward (moving statistics)
        np.testing.assert_allclose(g_vals[k], w_vals[k], err_msg=k, **TOL)


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_jax_block(name, hybrid):
    build, shapes, train = LAYERS[name]
    arrays = [_rng(1).randn(*s).astype(np.float32) for s in shapes]
    jnet, tnet = _carried(build, arrays)
    want = _forward_backward(jmx, jnet, arrays, train, hybrid)
    with tmx.cpu():
        got = _forward_backward(tmx, tnet, arrays, train, hybrid)
    _compare(got, want, 1e-2 if name == "convnet_train" else None)


@pytest.mark.parametrize("hybrid", [False, True], ids=["eager", "hybrid"])
def test_embedding_matches_the_jax_block(hybrid):
    build = _single(lambda nn: nn.Embedding(10, 4))
    idx = [_rng(2).randint(-2, 12, (3, 5)).astype(np.float32)]
    jnet, tnet = _carried(build, idx)
    want = _forward_backward(jmx, jnet, idx, False, hybrid, idx=(0,))
    with tmx.cpu():
        got = _forward_backward(tmx, tnet, idx, False, hybrid, idx=(0,))
    _compare(got, want)


def test_sequential_and_lambda_blocks_match():
    def build(mx):
        nn = mx.gluon.nn
        net = nn.Sequential(prefix="seq_")
        with net.name_scope():
            net.add(nn.Dense(6), nn.Lambda("tanh"),
                    nn.Lambda(lambda x: x * 2 + 1), nn.Dropout(0.3),
                    nn.Dense(2))
        return net

    x = [_rng(3).randn(4, 5).astype(np.float32)]
    jnet, tnet = _carried(build, x)
    want = _forward_backward(jmx, jnet, x, False, False)
    with tmx.cpu():
        got = _forward_backward(tmx, tnet, x, False, False)
    _compare(got, want)


def test_hybridized_equals_imperative_in_train_mode():
    x = _rng(4).randn(2, 3, 9, 9).astype(np.float32)
    runs = []
    for hybrid in (False, True):
        np.random.seed(7)
        net = _convnet(tmx)
        net.initialize(tmx.init.Xavier(), ctx=CPU)
        runs.append(_forward_backward(tmx, net, [x], True, hybrid))
    _compare(runs[1], runs[0])


def test_deferred_shapes_match_the_jax_package():
    x = _rng(0).randn(2, 3, 9, 9).astype(np.float32)
    shapes = []
    for mx in (jmx, tmx):
        net = _convnet(mx)
        net.initialize(**_ctx(mx))
        with pytest.raises(Exception):
            net.collect_params()["conv_conv0_weight"].data()
        net.hybridize()
        net(mx.nd.array(x, **_ctx(mx)))
        shapes.append({k: p.shape for k, p in _stripped(net).items()})
    assert shapes[0] == shapes[1]


# --- losses ------------------------------------------------------------------

def _loss_arrays(kind, rng):
    pred = rng.randn(4, 5).astype(np.float32)
    if kind == "sparse":
        label = rng.randint(0, 5, (4,)).astype(np.float32)
    elif kind == "prob":
        label = np.abs(rng.randn(4, 5)).astype(np.float32)
        label /= label.sum(axis=1, keepdims=True)
    elif kind == "binary":
        label = rng.randint(0, 2, (4, 5)).astype(np.float32)
    elif kind == "signed":
        label = (rng.randint(0, 2, (4, 5)) * 2 - 1).astype(np.float32)
    else:
        label = rng.randn(4, 5).astype(np.float32)
    return pred, label


LOSSES = [
    ("L2Loss", {}, "dense"), ("L2Loss", {"weight": 0.5}, "dense"),
    ("L1Loss", {}, "dense"),
    ("SigmoidBinaryCrossEntropyLoss", {}, "binary"),
    ("SigmoidBCELoss", {"from_sigmoid": True}, "binary"),
    ("SoftmaxCrossEntropyLoss", {}, "sparse"),
    ("SoftmaxCELoss", {"sparse_label": False}, "prob"),
    ("SoftmaxCrossEntropyLoss", {"from_logits": True, "weight": 2.0},
     "sparse"),
    ("KLDivLoss", {}, "prob"), ("KLDivLoss", {"from_logits": False}, "prob"),
    ("HuberLoss", {"rho": 0.7}, "dense"), ("HingeLoss", {}, "signed"),
    ("SquaredHingeLoss", {"margin": 2.0}, "signed"),
    ("LogisticLoss", {}, "signed"),
    ("LogisticLoss", {"label_format": "binary"}, "binary"),
]


def _loss_run(mx, cls, kw, pred, label, weight, hybrid):
    ctx = _ctx(mx)
    if cls == "SigmoidBCELoss" and kw.get("from_sigmoid"):
        pred = 1 / (1 + np.exp(-pred))
    loss = getattr(mx.gluon.loss, cls)(**kw)
    if hybrid:
        loss.hybridize()
    p = mx.nd.array(pred, **ctx)
    p.attach_grad()
    args = [mx.nd.array(label, **ctx)]
    if weight is not None:
        args.append(mx.nd.array(weight, **ctx))
    with mx.autograd.record():
        out = loss(p, *args)
    out.backward()
    return out.asnumpy(), p.grad.asnumpy()


@pytest.mark.parametrize("weighted", [False, True], ids=["", "weighted"])
@pytest.mark.parametrize("cls,kw,kind", LOSSES,
                         ids=["%s%s" % (c, "-".join(sorted(k)))
                              for c, k, _ in LOSSES])
def test_loss_matches_the_jax_loss(cls, kw, kind, weighted):
    rng = _rng(6)
    pred, label = _loss_arrays(kind, rng)
    weight = rng.rand(4, 1).astype(np.float32) if weighted else None
    want = _loss_run(jmx, cls, kw, pred, label, weight, False)
    with tmx.cpu():
        got = _loss_run(tmx, cls, kw, pred, label, weight, False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("cls,kw,kind", [
    ("SoftmaxCrossEntropyLoss", {}, "sparse"), ("L2Loss", {}, "dense"),
    ("HuberLoss", {"rho": 0.5}, "dense"), ("LogisticLoss", {}, "signed")])
def test_hybridized_loss_equals_imperative(cls, kw, kind):
    pred, label = _loss_arrays(kind, _rng(8))
    with tmx.cpu():
        runs = [_loss_run(tmx, cls, kw, pred, label, None, h)
                for h in (False, True)]
    for a, b in zip(*runs):
        np.testing.assert_allclose(a, b, **TOL)


def test_triplet_loss_matches():
    rng = _rng(9)
    arrays = [rng.randn(4, 6).astype(np.float32) for _ in range(3)]

    def run(mx):
        ctx = _ctx(mx)
        ins = [mx.nd.array(a, **ctx) for a in arrays]
        ins[0].attach_grad()
        with mx.autograd.record():
            out = mx.gluon.loss.TripletLoss(margin=1.5)(*ins)
        out.backward()
        return out.asnumpy(), ins[0].grad.asnumpy()

    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_ctc_loss_waits_for_its_op():
    # the op is ported: CTCLoss builds and runs over it (its parity is
    # tests/test_torch_ctc.py's)
    loss = tmx.gluon.loss.CTCLoss()
    pred = tmx.nd.array(_rng(14).randn(2, 6, 5).astype(np.float32),
                        ctx=CPU)
    label = tmx.nd.array(np.array([[1, 2], [3, 0]], np.float32), ctx=CPU)
    out = loss(pred, label).asnumpy()
    assert out.shape == (2,) and np.isfinite(out).all()
    assert tmx.ops.registry.get_op("ctc_loss") is not None


# --- SymbolBlock, files, utils ------------------------------------------------

def _fc_symbol(mx):
    data = mx.sym.var("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=8,
                                                name="fc1"),
                          act_type="relu")
    return data, mx.sym.FullyConnected(h, num_hidden=3, name="fc2")


def test_symbol_block_matches_the_jax_package():
    x = _rng(10).randn(4, 5).astype(np.float32)
    blocks = []
    for mx in (jmx, tmx):
        data, out = _fc_symbol(mx)
        blocks.append(mx.gluon.SymbolBlock(out, data))
    jb, tb = blocks
    jb.initialize(jmx.init.Xavier())
    jb(jmx.nd.array(x))
    tb.initialize(ctx=CPU)
    tmx.gluon_params_from_jax(jb, tb)
    assert sorted(tb.collect_params().keys()) == \
        ["fc1_bias", "fc1_weight", "fc2_bias", "fc2_weight"]
    want = _forward_backward(jmx, jb, [x], False, False)
    with tmx.cpu():
        got = _forward_backward(tmx, tb, [x], False, False)
    _compare(got, want)
    # composed with another symbol, then bound
    y = tmx.sym.var("y")
    composed = tb(y * 2.0)
    ex = composed.bind(CPU, dict({"y": tmx.nd.array(x / 2, ctx=CPU)},
                                 **{k: p.data()
                                    for k, p in tb.collect_params().items()}))
    np.testing.assert_allclose(ex.forward()[0].asnumpy(), got[0][0], **TOL)


def _resnet(mx, prefix="rn_"):
    return mx.gluon.model_zoo.vision.resnet18_v1(classes=10, thumbnail=True,
                                                prefix=prefix)


def test_jax_save_params_load_in_the_port_bit_for_bit(tmp_path):
    x = jmx.nd.array(_rng(11).rand(1, 3, 16, 16).astype(np.float32))
    jnet = _resnet(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(x)
    f = str(tmp_path / "jax.params")
    jnet.save_params(f)
    tnet = _resnet(tmx, prefix="other_")
    tnet.load_params(f, ctx=CPU)
    src = _stripped(jnet)
    for k, p in _stripped(tnet).items():
        np.testing.assert_array_equal(p.data().asnumpy(),
                                      src[k].data().asnumpy(), err_msg=k)
    # and the port writes the same bytes back
    g = str(tmp_path / "port.params")
    tnet.save_params(g)
    with open(f, "rb") as a, open(g, "rb") as b:
        assert a.read() == b.read()


_ZOO = ["resnet%d_v%d" % (d, v) for v in (1, 2)
        for d in (18, 34, 50, 101, 152)]
_PUBLISHED = {"resnet18_v1": 11699112, "resnet50_v1": 25629032,
              "resnet50_v2": 25595060}


@pytest.mark.parametrize("name", _ZOO)
def test_model_zoo_parameter_counts_match_the_jax_package(name):
    counts = []
    for mx in (jmx, tmx):
        net = mx.gluon.model_zoo.get_model(name, classes=1000,
                                           prefix="zoo_")
        x = mx.nd.zeros((1, 3, 224, 224), **_ctx(mx))
        net.infer_shape(x)
        counts.append(sum(int(np.prod(p.shape))
                          for p in net.collect_params().values()))
    assert counts[0] == counts[1]
    if name in _PUBLISHED:
        assert counts[1] == _PUBLISHED[name]


def test_model_zoo_forward_matches_the_jax_package():
    x = [_rng(12).rand(2, 3, 16, 16).astype(np.float32)]
    jnet, tnet = _carried(_resnet, x)
    want = _forward_backward(jmx, jnet, x, False, True)
    with tmx.cpu():
        got = _forward_backward(tmx, tnet, x, False, True)
    _compare(got, want)
    with pytest.raises(ValueError):
        tmx.gluon.model_zoo.get_model("vgg17")
    with pytest.raises(tmx.MXNetError):
        tmx.gluon.model_zoo.vision.resnet18_v1(pretrained=True)


def test_utils_match_the_jax_package(tmp_path):
    data = _rng(13).randn(6, 4).astype(np.float32)
    with tmx.cpu():
        parts = tmx.gluon.utils.split_data(tmx.nd.array(data), 3)
        loaded = tmx.gluon.utils.split_and_load(data, [tmx.cpu(0),
                                                       tmx.cpu(1)])
        arrays = [tmx.nd.array(data), tmx.nd.array(data[:2] * 3)]
        norm = tmx.gluon.utils.clip_global_norm(arrays, 1.0)
    jparts = jmx.gluon.utils.split_data(jmx.nd.array(data), 3)
    for a, b in zip(parts, jparts):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    assert [a.shape for a in loaded] == [(3, 4), (3, 4)]
    jarrays = [jmx.nd.array(data), jmx.nd.array(data[:2] * 3)]
    jnorm = jmx.gluon.utils.clip_global_norm(jarrays, 1.0)
    np.testing.assert_allclose(norm, jnorm, rtol=1e-6)
    for a, b in zip(arrays, jarrays):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **TOL)
    with pytest.raises(ValueError):
        tmx.gluon.utils.split_data(tmx.nd.array(data, ctx=CPU), 4)
    f = tmp_path / "blob"
    f.write_bytes(b"gluon")
    import hashlib
    assert tmx.gluon.utils.check_sha1(str(f),
                                      hashlib.sha1(b"gluon").hexdigest())
    with pytest.raises(IOError, match="not available offline"):
        tmx.gluon.utils.download("http://example.invalid/x.params",
                                 path=str(tmp_path / "missing"))
