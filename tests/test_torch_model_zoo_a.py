"""Port parity for Gluon's model zoo, part a: AlexNet, VGG (with and
without BatchNorm), the zoo's registry and ``HybridConcurrent``; the
helper :func:`zoo_parity` that parts b-d use too.

Each family is held at its smallest member and at batch 1, at the
smallest input its layers take, with 10 classes: the JAX net is
initialised (Xavier, ``np.random.seed(0)``), its weights carried into the
port's net by ``gluon_params_from_jax``, then both run one recorded
forward, ``backward`` and one ``Trainer.step`` (SGD 0.05): the logits, the
loss and every parameter and aux state after the step within 1e-5 of
max(1, each tensor's max |value|), except for a net with BatchNorm
recorded in train mode: its recorded logits at 1e-4 (``BN_TRAIN_LOGITS_TOL``)
and its parameters and aux states after the step at 1e-2 (ROADMAP's
BatchNorm-behind-ReLU bar: a batch statistic's rounding moves a ReLU's
boundary, and the step carries that on). The
port's net is hybridized, as the bench trains it, and its imperative
logits equal its hybridized ones. A net with Dropout is recorded in
predict mode (the two packages' masks differ), where BatchNorm is a fixed
affine map, the rest in train mode. """
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-5
CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the parameters and aux states of a net with BatchNorm recorded in train
# mode, after one step (ROADMAP's BatchNorm-behind-ReLU bar)
BN_STEP_TOL = 1e-2
# the recorded logits of such a net: batch statistics over few values (4x4
# at mobilenet0_25's last stage at batch 1) magnify the two packages'
# summation orders (1.79e-5 there, 1.67e-6 at 8x8; densenet121 1.86e-6)
BN_TRAIN_LOGITS_TOL = 1e-4


def _close(got, want, what="", tol=TOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * max(scale, 1.0), \
        "%s: %.3g against max %.3g" % (what, err, scale)


def _stripped(net):
    cut = len(net.prefix)
    return {k[cut:]: p for k, p in net.collect_params().items()}


def _step(mx, net, x, y, train, ctx):
    """One recorded forward, backward and SGD step: (logits, loss, every
    parameter and aux state after the step)."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05}, kvstore="local")
    data, label = mx.nd.array(x, **ctx), mx.nd.array(y, **ctx)
    with mx.autograd.record(train_mode=train):
        out = net(data)
        loss = loss_fn(out, label)
    loss.backward()
    trainer.step(x.shape[0])
    return (out.asnumpy(), loss.asnumpy(),
            {k: p.data().asnumpy() for k, p in _stripped(net).items()})


def zoo_parity(name, size, train, jax_hybrid=False, classes=10, seed=0):
    """Hold the port's ``name`` to the JAX package's (module docstring);
    ``jax_hybrid`` hybridizes the JAX net (one compile instead of an
    eager compile per op: the deep nets)."""
    np.random.seed(seed)
    rng = np.random.RandomState(seed)
    x = rng.rand(1, 3, size, size).astype(np.float32)
    y = rng.randint(0, classes, 1).astype(np.float32)
    jnet = jmx.gluon.model_zoo.vision.get_model(name, classes=classes)
    jnet.initialize(jmx.init.Xavier(magnitude=2.0))
    jnet.infer_shape(jmx.nd.array(x))
    for p in jnet.collect_params().values():
        p._finish_deferred_init()
    tnet = tmx.gluon.model_zoo.vision.get_model(name, classes=classes)
    tnet.initialize(ctx=CPU)
    tmx.gluon_params_from_jax(jnet, tnet)
    if jax_hybrid:
        jnet.hybridize()
    logits = jnet(jmx.nd.array(x)).asnumpy()
    with tmx.cpu():
        imperative = tnet(tmx.nd.array(x)).asnumpy()
        tnet.hybridize()
        hybrid = tnet(tmx.nd.array(x)).asnumpy()
        got = _step(tmx, tnet, x, y, train, {"ctx": CPU})
    want = _step(jmx, jnet, x, y, train, {})
    _close(imperative, logits, "imperative logits")
    _close(hybrid, logits, "hybridized logits")
    bn_train = train and any(k.endswith("running_mean") for k in want[2])
    _close(got[0], want[0], "recorded logits",
           BN_TRAIN_LOGITS_TOL if bn_train else TOL)
    _close(got[1], want[1], "loss")
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        _close(got[2][k], want[2][k], k + " after the step",
               BN_STEP_TOL if bn_train else TOL)


def test_registry_holds_the_reference_names():
    assert sorted(tmx.gluon.model_zoo.vision._models) == \
        sorted(jmx.gluon.model_zoo.vision._models)
    assert len(tmx.gluon.model_zoo.vision._models) == 30
    with pytest.raises(ValueError):
        tmx.gluon.model_zoo.get_model("vgg17")
    for factory in (tmx.gluon.model_zoo.vision.alexnet,
                    tmx.gluon.model_zoo.vision.vgg11,
                    tmx.gluon.model_zoo.vision.squeezenet1_0,
                    tmx.gluon.model_zoo.vision.mobilenet0_25):
        with pytest.raises(tmx.MXNetError):
            factory(pretrained=True)
    for factory in (tmx.gluon.model_zoo.vision.densenet121,
                    tmx.gluon.model_zoo.vision.inception_v3):
        with pytest.raises(NotImplementedError):
            factory(pretrained=True)


@pytest.mark.parametrize("name,size,train", [
    ("alexnet", 64, False), ("vgg11", 32, False), ("vgg11_bn", 32, False)])
def test_family_matches_the_reference(name, size, train):
    zoo_parity(name, size, train)


def test_hybrid_concurrent_concatenates_its_children():
    from mxnet_tpu_torch.gluon.model_zoo.vision.squeezenet import \
        HybridConcurrent
    nn = tmx.gluon.nn
    block = HybridConcurrent(axis=1, prefix="cc_")
    with block.name_scope():
        block.add(nn.Dense(3, in_units=4))
        block.add(nn.Dense(2, in_units=4))
    block.initialize(ctx=CPU)
    x = tmx.nd.array(np.ones((5, 4), np.float32), ctx=CPU)
    out = block(x)
    assert out.shape == (5, 5)
    block.hybridize()
    np.testing.assert_array_equal(block(x).asnumpy(), out.asnumpy())
