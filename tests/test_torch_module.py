"""Port parity: symbolic training through mxnet_tpu_torch (initializers,
Executor forward/backward, the SoftmaxOutput gradient, Module.fit / score /
predict, the local KVStore) against mxnet_tpu on the same numpy inputs.

Tolerances: the JAX package's own fusion-training bars
(tests/test_fusion.py): parameters after two fit epochs at rtol 1e-5 and
atol 1e-6 against the reference composition (both packages compute the
same fp32 ops, in another summation order), and at rtol 2e-4, atol 1e-5
against the Pallas kernels run in interpret mode. Single forward/backward
values at rtol 1e-5, atol 1e-6; initializers bit-exact (both fill from
numpy's global RNG).
"""
import re

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autotune, graph_pass
from mxnet_tpu.config import set_flag

_FIT_TOL = dict(rtol=1e-5, atol=1e-6)
_KERNEL_TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    """Both packages on their default pass pipelines, the JAX tuning cache
    in a scratch file."""
    from mxnet_tpu.autotune import learned

    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.delenv("MXNET_COST_MODEL_PATH", raising=False)
    monkeypatch.delenv("MXNET_GRAPH_PASSES", raising=False)
    autotune.reset()
    learned.reset()
    graph_pass.set_passes(None)
    yield
    graph_pass.set_passes(None)
    set_flag("MXNET_FUSION_INTERPRET", None)
    autotune.reset()
    learned.reset()


# ------------------------------------------------------------- the graphs

def _transformer_block(mx):
    """tests/test_fusion.py _transformer_block: T 6, D 8, 4 classes."""
    T, D = 6, 8
    data = mx.sym.var("data")
    q = mx.sym.FullyConnected(data, num_hidden=D, flatten=False, name="q")
    k = mx.sym.FullyConnected(data, num_hidden=D, flatten=False, name="k")
    v = mx.sym.FullyConnected(data, num_hidden=D, flatten=False, name="v")
    scores = mx.sym.batch_dot(q, mx.sym.transpose(k, axes=(0, 2, 1)))
    attn = mx.sym.softmax(scores / float(np.sqrt(D)), axis=-1)
    ctx = mx.sym.batch_dot(attn, v)
    out = mx.sym.FullyConnected(ctx + data, num_hidden=D, flatten=False,
                                name="proj")
    flat = mx.sym.Flatten(out)
    return mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(flat, num_hidden=4, name="head"),
        name="softmax"), (3, T, D), 4


def _mlp(mx):
    """tests/test_fusion.py _mlp: fc1 + relu carves onto fused_matmul."""
    data = mx.sym.var("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=16,
                                                name="fc1"),
                          act_type="relu")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(h, num_hidden=6,
                                                      name="fc2"),
                                name="softmax"), (5, 8), 6


GRAPHS = {"transformer_block": _transformer_block, "mlp": _mlp}


def _materialize(make_graph, seed=7):
    """tests/test_fusion.py _materialize: parameters and data from one
    RandomState; labels cycle over the classes."""
    sym, dshape, classes = make_graph(jmx)
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(data=dshape)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n != "data" and not n.endswith("label")}
    x = rng.uniform(0, 1, dshape).astype(np.float32)
    y = (np.arange(dshape[0]) % classes).astype(np.float32)
    return args, x, y


def _fit(mx, make_graph, args, x, y, num_epoch=2):
    sym, dshape, _ = make_graph(mx)
    mod = mx.mod.Module(sym, context=mx.cpu())
    it = mx.io.NDArrayIter(x, y, batch_size=dshape[0],
                           label_name="softmax_label")
    mod.fit(it, num_epoch=num_epoch, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=mx.init.Uniform(0.1), force_init=True,
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
            aux_params={}, allow_missing=False)
    return mod


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _jax_fit(make_graph, args, x, y, spec, interpret=0):
    graph_pass.set_passes(spec)
    set_flag("MXNET_FUSION_INTERPRET", interpret)
    try:
        return _params(_fit(jmx, make_graph, args, x, y))
    finally:
        set_flag("MXNET_FUSION_INTERPRET", None)
        graph_pass.set_passes(None)


# ----------------------------------------------------------- initializers

@pytest.mark.parametrize("make", [
    lambda m: m.init.Uniform(0.05),
    lambda m: m.init.Normal(0.3),
    lambda m: m.init.Xavier(),
    lambda m: m.init.Xavier(rnd_type="gaussian", factor_type="in",
                            magnitude=2),
    lambda m: m.init.Constant(0.25),
    lambda m: m.init.One(),
    lambda m: m.init.Zero(),
], ids=["uniform", "normal", "xavier", "xavier_gaussian_in", "constant",
        "one", "zero"])
def test_initializer_bit_exact(make):
    params = (("fc_weight", (7, 5)), ("fc_bias", (7,)),
              ("conv_weight", (4, 3, 3, 3)), ("bn_gamma", (4,)),
              ("bn_moving_var", (4,)), ("lstm_i2h_bias", (8,)),
              ("up_weight", (2, 1, 4, 4)))
    out = []
    for mx in (jmx, tmx):
        np.random.seed(11)
        arrs = {}
        for name, shape in params:
            buf = np.zeros(shape, np.float32)
            make(mx)(mx.init.InitDesc(name), buf)
            arrs[name] = buf
        out.append(arrs)
    for name in out[0]:
        np.testing.assert_array_equal(out[1][name], out[0][name],
                                      err_msg=name)


def test_lr_schedulers():
    got = []
    for mx in (jmx, tmx):
        lrs = []
        for sched in (mx.lr_scheduler.FactorScheduler(3, factor=0.5),
                      mx.lr_scheduler.MultiFactorScheduler([2, 5],
                                                           factor=0.1),
                      mx.lr_scheduler.PolyScheduler(10, base_lr=0.2)):
            sched.base_lr = 0.2
            lrs.append([sched(n) for n in range(1, 12)])
        got.append(lrs)
    np.testing.assert_allclose(got[1], got[0], rtol=1e-7)


def test_initializer_dispatch_and_override():
    for mx in (jmx, tmx):
        buf = np.zeros((3, 2), np.float32)
        desc = mx.init.InitDesc("w", attrs={
            "__init__": mx.init.Constant(2.0).dumps()})
        mx.init.Uniform()(desc, buf)
        np.testing.assert_array_equal(buf, 2.0)
        with pytest.raises(ValueError):
            mx.init.Uniform()(mx.init.InitDesc("mystery"), buf)


# --------------------------------------------------------------- executor

def _bind_both(make_graph, grad_req):
    """The same graph simple_bound in both packages, parameters and data
    set from the same numpy arrays."""
    args, x, y = _materialize(make_graph)
    exes = []
    for mx in (jmx, tmx):
        sym, dshape, _ = make_graph(mx)
        ex = sym.simple_bind(ctx=mx.cpu(), grad_req=grad_req, data=dshape,
                             softmax_label=y.shape)
        for n, v in args.items():
            ex.arg_dict[n][:] = v
        ex.arg_dict["data"][:] = x
        ex.arg_dict["softmax_label"][:] = y
        exes.append(ex)
    return exes


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_executor_forward_backward(graph, grad_req):
    jex, tex = _bind_both(GRAPHS[graph], grad_req)
    for _ in range(2 if grad_req == "add" else 1):
        jout = jex.forward(is_train=True)[0].asnumpy()
        tout = tex.forward(is_train=True)[0].asnumpy()
        jex.backward()
        tex.backward()
    np.testing.assert_allclose(tout, jout, **_FIT_TOL)
    assert set(tex.grad_dict) == set(jex.grad_dict)
    for name in jex.grad_dict:
        np.testing.assert_allclose(tex.grad_dict[name].asnumpy(),
                                   jex.grad_dict[name].asnumpy(),
                                   err_msg=name, **_FIT_TOL)


def test_executor_inference_forward_and_out_grads():
    jex, tex = _bind_both(_mlp, "write")
    np.testing.assert_allclose(tex.forward()[0].asnumpy(),
                               jex.forward()[0].asnumpy(), **_FIT_TOL)
    # explicit head gradients: SoftmaxOutput ignores them (out_grad off)
    seed = np.full((5, 6), 3.0, np.float32)
    for ex, mx in ((jex, jmx), (tex, tmx)):
        ex.forward(is_train=True)
        ex.backward(out_grads=[mx.nd.array(seed, ctx=mx.cpu())])
    np.testing.assert_allclose(tex.grad_dict["fc1_weight"].asnumpy(),
                               jex.grad_dict["fc1_weight"].asnumpy(),
                               **_FIT_TOL)


def test_executor_training_bind_carves_both_regions():
    _jex, tex = _bind_both(_transformer_block, "write")
    regions = tex.fused_regions()
    assert [r["base_op"] for r in regions] == ["batch_dot", "batch_dot"]
    assert [[m.rstrip("0123456789") for m in r["members"]]
            for r in regions] == [["batch_dot", "div_scalar"],
                                  ["batch_dot", "broadcast_add"]]


# --------------------------------------------------------- SoftmaxOutput

@pytest.mark.parametrize("kw", [
    {}, {"normalization": "batch"}, {"normalization": "valid"},
    {"use_ignore": True, "ignore_label": 2.0},
    {"use_ignore": True, "ignore_label": 2.0, "normalization": "valid",
     "grad_scale": 0.5},
    {"multi_output": True},
    {"label_like_output": True, "normalization": "batch"},
    {"out_grad": True},
], ids=["null", "batch", "valid", "ignore", "ignore_valid_scaled",
        "multi_output", "label_like_output", "out_grad"])
def test_softmax_output_gradient(kw):
    kw = dict(kw)
    label_like_output = kw.pop("label_like_output", False)
    rng = np.random.RandomState(4)
    if kw.get("multi_output"):
        x = rng.randn(3, 5, 4).astype(np.float32)
        y = rng.randint(0, 5, (3, 4)).astype(np.float32)
    else:
        x = rng.randn(6, 5).astype(np.float32)
        y = np.array([0, 2, 4, 2, 1, 3], np.float32)
    if label_like_output:
        # soft targets: a distribution per row, shaped like the output
        y = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    head = rng.randn(*x.shape).astype(np.float32)
    grads = []
    for mx in (jmx, tmx):
        sym = mx.sym.SoftmaxOutput(mx.sym.var("data"), name="softmax", **kw)
        ex = sym.simple_bind(ctx=mx.cpu(), grad_req={"data": "write"},
                             data=x.shape, softmax_label=y.shape)
        ex.arg_dict["data"][:] = x
        ex.arg_dict["softmax_label"][:] = y
        out = ex.forward(is_train=True)[0].asnumpy()
        # a head gradient that only out_grad lets through
        ex.backward(out_grads=[mx.nd.array(head, ctx=mx.cpu())])
        grads.append((out, ex.grad_dict["data"].asnumpy()))
    np.testing.assert_allclose(grads[1][0], grads[0][0], **_FIT_TOL)
    np.testing.assert_allclose(grads[1][1], grads[0][1], **_FIT_TOL)


# ------------------------------------------------------------ Module.fit

@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_fit_matches_jax(graph, monkeypatch):
    """Two epochs of Module.fit; the port with its fuse pass on (the
    regions through the fused kernels' plain versions and the
    reference-recompute backward) and off, against the JAX package's
    reference composition, its fused lowering and its Pallas kernels in
    interpret mode."""
    make_graph = GRAPHS[graph]
    args, x, y = _materialize(make_graph)
    p_ref = _jax_fit(make_graph, args, x, y, "default,-fuse")
    p_fused = _jax_fit(make_graph, args, x, y, "default")
    p_kern = _jax_fit(make_graph, args, x, y, "default", interpret=1)
    mod = _fit(tmx, make_graph, args, x, y)
    regions = mod._exec_group.execs[0].fused_regions()
    assert regions and all(r["base_op"] == ("batch_dot" if graph ==
                           "transformer_block" else "FullyConnected")
                           for r in regions)
    p_port = _params(mod)
    monkeypatch.setenv("MXNET_GRAPH_PASSES", "default,-fuse")
    p_port_ref = _params(_fit(tmx, make_graph, args, x, y))
    assert sorted(p_port) == sorted(p_ref)
    # every parameter trained but k_bias, whose gradient is 0: it adds the
    # same q.b to every score of a row, which the softmax cancels
    moved = sorted(k for k in p_port if not np.array_equal(p_port[k],
                                                           args[k]))
    assert moved == sorted(set(p_port) - {"k_bias"}), moved
    for k in sorted(p_ref):
        for got in (p_port, p_port_ref):
            np.testing.assert_allclose(got[k], p_ref[k], err_msg=k,
                                       **_FIT_TOL)
            np.testing.assert_allclose(got[k], p_fused[k], err_msg=k,
                                       **_FIT_TOL)
            np.testing.assert_allclose(got[k], p_kern[k], err_msg=k,
                                       **_KERNEL_TOL)


@pytest.mark.parametrize("kvstore", ["local", "device", None])
def test_fit_with_momentum_and_kvstore(kvstore):
    args, x, y = _materialize(_mlp)
    out = []
    for mx in (jmx, tmx):
        sym, dshape, _ = _mlp(mx)
        mod = mx.mod.Module(sym, context=mx.cpu())
        np.random.seed(3)
        it = mx.io.NDArrayIter(np.concatenate([x, x[::-1]]),
                               np.concatenate([y, y[::-1]]),
                               batch_size=4, shuffle=True)
        kv = mx.kv.create("local") if kvstore == "local" else kvstore
        np.random.seed(5)
        mod.fit(it, num_epoch=2, optimizer="sgd", kvstore=kv,
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                                  "wd": 1e-3},
                initializer=mx.init.Xavier())
        out.append(_params(mod))
    for k in out[0]:
        np.testing.assert_allclose(out[1][k], out[0][k], err_msg=k,
                                   **_FIT_TOL)


def test_fit_batch_callbacks_log_the_metric(caplog):
    """Speedometer and log_train_metric as fit's batch_end_callback: the
    same metric lines as the JAX package (the speed itself varies)."""
    args, x, y = _materialize(_mlp)
    lines = []
    for mx in (jmx, tmx):
        sym, dshape, _ = _mlp(mx)
        mod = mx.mod.Module(sym, context=mx.cpu())
        it = mx.io.NDArrayIter(np.concatenate([x] * 4),
                               np.concatenate([y] * 4), batch_size=5)
        caplog.clear()
        with caplog.at_level("INFO"):
            mod.fit(it, num_epoch=1, optimizer="sgd",
                    eval_data=mx.io.NDArrayIter(x, y, batch_size=5),
                    arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in args.items()},
                    batch_end_callback=[mx.callback.Speedometer(5, 2),
                                        mx.callback.log_train_metric(2)])
        lines.append([re.sub(r"Speed: \S+ samples/sec", "", r.getMessage())
                      for r in caplog.records if "Batch" in r.getMessage()
                      or "Validation" in r.getMessage()])
    # Batch 0 and 2 from log_train_metric, Batch 2 from the Speedometer,
    # the epoch's validation accuracy
    assert lines[1] == lines[0] and len(lines[1]) == 4


def test_predict_score_and_accuracy_match_jax():
    args, x, y = _materialize(_transformer_block)
    xs = np.concatenate([x, x[::-1], x[:1]])   # 7 rows: a padded last batch
    ys = np.concatenate([y, y[::-1], y[:1]])
    res = []
    for mx in (jmx, tmx):
        mod = _fit(mx, _transformer_block, args, x, y, num_epoch=1)
        pred = mod.predict(mx.io.NDArrayIter(xs, ys, batch_size=3))
        acc = mod.score(mx.io.NDArrayIter(xs, ys, batch_size=3), "acc")
        ce = mod.score(mx.io.NDArrayIter(xs, ys, batch_size=3),
                       mx.metric.create(["acc", "ce"]))
        res.append((pred.asnumpy(), acc, ce))
    (jp, jacc, jce), (tp, tacc, tce) = res
    assert tp.shape == jp.shape == (7, 4)
    np.testing.assert_allclose(tp, jp, **_FIT_TOL)
    assert tacc[0][0] == jacc[0][0] == "accuracy"
    assert tacc[0][1] == jacc[0][1]
    assert [n for n, _ in tce] == [n for n, _ in jce]
    np.testing.assert_allclose([v for _, v in tce], [v for _, v in jce],
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["acc", "ce", "composite"])
def test_metric_matches_jax(name):
    """The ported metrics, two updates then get(), on the same numpy
    predictions and labels in both packages."""
    rng = np.random.RandomState(6)
    batches = [(rng.randint(0, 5, 8).astype(np.float32),
                rng.dirichlet(np.ones(5), 8).astype(np.float32))
               for _ in range(2)]
    got = []
    for mx in (jmx, tmx):
        m = mx.metric.create(["acc", "ce"] if name == "composite" else name)
        for y, p in batches:
            m.update([mx.nd.array(y, ctx=mx.cpu())],
                     [mx.nd.array(p, ctx=mx.cpu())])
        got.append(m.get())
    assert got[1][0] == got[0][0]
    np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-5)


def test_local_kvstore_push_pull():
    rng = np.random.RandomState(2)
    w0 = rng.randn(4, 3).astype(np.float32)
    g1, g2 = (rng.randn(4, 3).astype(np.float32) for _ in range(2))
    res = []
    for mx in (jmx, tmx):
        kv = mx.kv.create("local")
        assert kv.type == "local" and kv.rank == 0 and kv.num_workers == 1
        host = dict(ctx=mx.cpu())
        kv.init("w", mx.nd.array(w0, **host))
        kv.init(3, mx.nd.array(w0, **host))
        out = mx.nd.zeros((4, 3), **host)
        kv.push("w", [mx.nd.array(g1, **host),
                      mx.nd.array(g2, **host)])   # sum replaces
        kv.pull("w", out=out)
        summed = out.asnumpy()
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.5,
                                             momentum=0.9))
        for _ in range(2):
            kv.push(3, mx.nd.array(g1, **host))
        kv.pull(3, out=out)
        res.append((summed, out.asnumpy()))
    np.testing.assert_allclose(res[1][0], g1 + g2, rtol=1e-6)
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)
    np.testing.assert_allclose(res[1][1], res[0][1], **_FIT_TOL)


def test_not_ported_paths_raise():
    sym, dshape, _ = _mlp(tmx)
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    it = tmx.io.NDArrayIter(np.zeros(dshape, np.float32),
                            np.zeros(dshape[0], np.float32), batch_size=5)
    with pytest.raises(tmx.MXNetError, match="A13"):
        mod.fit(it, num_epoch=1, resume="somewhere")
    with pytest.raises(tmx.MXNetError, match="A10"):
        tmx.kv.create("dist_sync")
    with pytest.raises(tmx.MXNetError, match="A10"):
        tmx.mod.Module(sym, context=[tmx.cpu(0), tmx.cpu(1)])
    with pytest.raises(tmx.MXNetError, match="A4"):
        tmx.metric.create(lambda label, pred: 0.0)
    if not torch.cuda.is_available():
        with pytest.raises(tmx.MXNetError, match="CUDA"):
            tmx.mod.Module(sym)


# ------------------------------------------------------ mx.models on MNIST

def test_get_mnist_is_bit_identical():
    j, t = jmx.test_utils.get_mnist(), tmx.test_utils.get_mnist()
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("model", ["lenet", "mlp"])
def test_model_fit_on_mnist_matches_jax(model):
    """mx.models' LeNet and MLP, one epoch of 200 synthetic MNIST samples
    in batches of 100 (SGD 0.1, momentum 0.9, Xavier): every parameter
    within 1e-4 of its max |value| of the JAX package's (the convolutions
    sum in another order than XLA's)."""
    out = []
    for mx in (jmx, tmx):
        mnist = mx.test_utils.get_mnist()
        np.random.seed(0)
        it = mx.io.NDArrayIter(mnist["train_data"][:200],
                               mnist["train_label"][:200], batch_size=100,
                               shuffle=True)
        mod = mx.mod.Module(getattr(mx.models, "get_" + model)(10),
                            context=mx.cpu())
        np.random.seed(1)
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mx.init.Xavier(), eval_metric="acc")
        out.append(_params(mod))
    jp, tp = out
    assert sorted(tp) == sorted(jp)
    for k in jp:
        scale = np.abs(jp[k]).max()
        err = np.abs(tp[k] - jp[k]).max()
        assert scale > 0 and err <= 1e-4 * scale, (k, err, scale)
