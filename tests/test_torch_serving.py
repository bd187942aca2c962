"""The ported serving slice end to end at small size: a bottleneck ResNet
(NHWC) served by the port's InferenceServer on the CPU against the JAX
package's InferenceServer, with the same weights carried across by
``params_from_jax``.

Tolerance rtol = atol = 1e-4 on probabilities and logits: the two stacks
sum convolutions in a different order (and the port computes the 1x1
kernel-form regions as matmuls).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.executor import _GraphProgram as JaxProgram
from mxnet_tpu.serving import InferenceServer as JaxServer
from mxnet_tpu.serving import ServingConfig as JaxConfig
from mxnet_tpu_torch import cuda_build
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import _GraphProgram as TorchProgram
from mxnet_tpu_torch.parallel import fused as tfused
from mxnet_tpu_torch.serving import InferenceServer, ServingConfig
from time_limit import time_limit  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
ROW = (32, 32, 3)
BUCKETS = (1, 2, 4, 8)


def _net(pkg):
    with pkg.NameManager() if pkg is tmx else pkg.name.NameManager():
        return pkg.models.resnet.resnet(
            units=[1, 1, 1], num_stages=3, filter_list=[16, 32, 64, 128],
            num_classes=10, image_shape=(3, 32, 32), bottle_neck=True,
            layout="NHWC")


def _params(sym, seed=0):
    """He-scaled conv/FC weights; BN gamma = var = 1 with small random
    beta and mean, so bn_fold has real arithmetic to fold."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1,) + ROW)
    args, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[:-1])) if len(shape) == 4 \
                else shape[1]
            args[name] = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("_gamma"):
            args[name] = np.ones(shape)
        else:
            args[name] = rng.randn(*shape) * 0.1
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = np.ones(shape) if name.endswith("_var") \
            else rng.randn(*shape) * 0.1
    cast = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
    return cast(args), cast(aux)


@pytest.fixture(scope="module")
def served():
    jsym, tsym = _net(jmx), _net(tmx)
    args, aux = _params(jsym)
    jargs = {k: jmx.nd.array(v) for k, v in args.items()}
    jaux = {k: jmx.nd.array(v) for k, v in aux.items()}
    cpu = torch.device("cpu")
    targs, taux = tmx.params_from_jax(jargs, jaux, device=cpu)
    jsrv = JaxServer(jsym, jargs, jaux, data_shapes=[("data", (1,) + ROW)],
                     config=JaxConfig(buckets=BUCKETS))
    tsrv = InferenceServer(tsym, targs, taux,
                           data_shapes=[("data", (1,) + ROW)],
                           devices=[tmx.cpu()],
                           config=ServingConfig(buckets=BUCKETS))
    yield jsym, tsym, args, aux, jsrv, tsrv
    jsrv.stop()
    tsrv.stop()


def _images(n, seed):
    return np.random.RandomState(seed).randn(n, *ROW).astype(np.float32)


def test_single_and_batched_requests_match(served, monkeypatch):
    _, _, _, _, jsrv, tsrv = served
    calls = []
    real = tfused.fused_matmul

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tfused, "fused_matmul", spy)
    before = tsrv.get_stats().get("batches", 0)
    singles = _images(6, 1)
    batched = _images(5, 2)
    jout = [jsrv.predict(x) for x in singles] + [jsrv.predict(batched)]
    tout = [tsrv.predict(x) for x in singles] + [tsrv.predict(batched)]
    for j, t in zip(jout, tout):
        assert t.shape == j.shape and t.dtype == np.float32
        np.testing.assert_allclose(t, j, **TOL)
    jtop = np.concatenate([np.atleast_2d(o) for o in jout]).argmax(-1)
    ttop = np.concatenate([np.atleast_2d(o) for o in tout]).argmax(-1)
    assert (jtop == ttop).mean() == 1.0
    # three bottleneck units: each has a 1x1 conv + bias + relu and a
    # 1x1 conv + residual region, all of kernel form in NHWC
    forwards = tsrv.get_stats()["batches"] - before
    assert len(calls) == 6 * forwards


def test_concurrent_submits_are_batched_in_order(served):
    _, _, _, _, jsrv, tsrv = served
    xs = _images(8, 3)
    futs = [tsrv.submit(x) for x in xs]
    outs = np.stack([f.result(timeout=60) for f in futs])
    ref = np.stack([jsrv.predict(x) for x in xs])
    np.testing.assert_allclose(outs, ref, **TOL)


def test_fc1_internal_matches(served):
    jsym, tsym, args, aux, _, _ = served
    x = _images(2, 4)
    label = np.zeros((2,), np.float32)
    jint, tint = jsym.get_internals(), tsym.get_internals()
    idx = jint.list_outputs().index("fc1_output")
    assert tint.list_outputs()[idx] == "fc1_output"
    jfeed = {k: jmx.nd.array(v)._data for k, v in args.items()}
    jfeed.update(data=jmx.nd.array(x)._data,
                 softmax_label=jmx.nd.array(label)._data)
    jaux = {k: jmx.nd.array(v)._data for k, v in aux.items()}
    (jl,) = JaxProgram(jint).infer_fn(sel=(idx,))(jfeed, jaux, ())
    tfeed = {k: torch.from_numpy(v) for k, v in args.items()}
    tfeed.update(data=torch.from_numpy(x),
                 softmax_label=torch.from_numpy(label))
    taux = {k: torch.from_numpy(v) for k, v in aux.items()}
    (tl,) = TorchProgram(tint).infer_fn(sel=(idx,))(tfeed, taux)
    assert tuple(tl.shape) == (2, 10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_warmup_and_stats(served):
    tsrv = served[5]
    assert tsrv.warmup() == len(BUCKETS)
    stats = tsrv.get_stats()
    # one replica on the CPU: its programs are the eager walk, counted at
    # their first use
    assert tsrv._devices == [torch.device("cpu")]
    assert stats["bucket_programs"] == len(BUCKETS)
    # the stem conv (its BN folded) + three regions per bottleneck unit
    assert len(stats["graph_pass"]["fuse"]["regions"]) == 10


def test_default_device_is_the_card(monkeypatch):
    """No silent CPU fallback: without a card, a server on the default
    device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sym = _net(tmx)
    with pytest.raises(MXNetError, match="CUDA is not available"):
        InferenceServer(sym, {}, {}, data_shapes=[("data", (1,) + ROW)],
                        start=False)


def test_stop_drains_then_rejects(served):
    tsym, args, aux = served[1], served[2], served[3]
    srv = InferenceServer(tsym, args, aux,
                          data_shapes=[("data", (1,) + ROW)],
                          devices=[tmx.cpu()],
                          config=ServingConfig(buckets=(1, 2)))
    futs = [srv.submit(x) for x in _images(3, 5)]
    srv.stop(drain=True)
    assert all(f.done() and f.exception() is None for f in futs)
    with pytest.raises(tmx.serving.ServerClosedError):
        srv.submit(_images(1, 6)[0])


def test_concurrent_submitters_stress():
    """More submitter threads than cores, with a shortened switch
    interval: every request gets exactly its own rows back and the
    counters lose no update."""
    import sys
    import threading

    data = tmx.sym.Variable("data")
    net = tmx.sym.SoftmaxOutput(
        tmx.sym.FullyConnected(data, num_hidden=5, name="fc"),
        name="softmax")
    rng = np.random.RandomState(7)
    w = rng.randn(5, 7).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    srv = InferenceServer(net, {"fc_weight": w, "fc_bias": b},
                          data_shapes=[("data", (1, 7))],
                          devices=[tmx.cpu()],
                          config=ServingConfig(buckets=(1, 2, 4, 8),
                                               max_wait_ms=1))
    n_threads, per_thread = 32, 10
    errors = []

    def client(seed):
        r = np.random.RandomState(seed)
        for _ in range(per_thread):
            x = r.randn(r.randint(1, 4), 7).astype(np.float32)
            z = x @ w.T + b
            ref = np.exp(z - z.max(1, keepdims=True))
            ref /= ref.sum(1, keepdims=True)
            out = srv.predict(x, timeout=60)
            if out.shape != ref.shape or not np.allclose(out, ref,
                                                         atol=1e-5):
                errors.append((seed, out.shape))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        counters = [threading.Thread(
            target=lambda: [cuda_build.count_launch("stress")
                            for _ in range(1000)])
            for _ in range(n_threads)]
        cuda_build.reset_launch_counts()
        for t in counters:
            t.start()
        for t in counters:
            t.join(timeout=60)
        assert cuda_build.launch_counts()["stress"] == \
            n_threads * 1000
    finally:
        sys.setswitchinterval(old)
        srv.stop()
    assert not errors, errors[:3]
    stats = srv.get_stats()
    assert stats["completed"] == stats["requests"] == n_threads * per_thread
    assert stats["rows_real"] == stats["rows_in"]
