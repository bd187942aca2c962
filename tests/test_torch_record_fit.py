"""The slice as a whole: one ``.rec`` of 32 px JPEGs goes through
``ImageRecordIter`` into ``Module.fit`` in both packages, from the same
numpy parameters, on a small NHWC bottleneck ResNet (the cifar stem, units
[1, 1, 1], filters [8, 16, 32, 64]) composed onto ``transpose(data, axes=(0,
2, 3, 1))``, so that the iterators' NCHW batches feed the NHWC graph, as
``chip_smoke.py`` phase 19 trains ResNet-50 from records on the card.

Held: the batches the port's streaming and synchronous readers hand to
``fit`` equal the JAX package's to the bit; the fuse report of the
composed training bind equals the JAX package's (the same regions, and
the same kernel-form regions: the port's ``fused_matmul`` wrapper calls in
a training forward against the JAX package's kernel lowerings, counted
with the Pallas call stubbed); the first training forward at 1e-5 of each
tensor's max; the parameters after two ``fit`` batches (SGD 0.1 / 0.9 /
1e-4) at the standing 1e-2 bar for BatchNorm behind ReLU over more than
one step (ROADMAP.md ground rules; ``tests/test_torch_resnet_train.py``).
On the CPU the port's wrapper runs the kernel's plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.config import set_flag as jset_flag
from mxnet_tpu.parallel import fused as jfused
from mxnet_tpu_torch.ndarray.ndarray import _from_data
from mxnet_tpu_torch.parallel import fused as tfused

BATCH, CLASSES, SIZE = 4, 10, 32
STEP_TOL, FIT_TOL = 1e-5, 1e-2
MEAN = dict(mean_r=123.68, mean_g=116.28, mean_b=103.53,
            std_r=58.395, std_g=57.12, std_b=57.375)


def record_net(mx):
    with mx.NameManager() if mx is tmx else mx.name.NameManager():
        net = mx.models.resnet.resnet(
            units=[1, 1, 1], num_stages=3, filter_list=[8, 16, 32, 64],
            num_classes=CLASSES, image_shape=(3, SIZE, SIZE),
            bottle_neck=True, layout="NHWC")
        data = mx.sym.transpose(mx.sym.Variable("data"), axes=(0, 2, 3, 1))
        return net(data=data)


def params(sym, seed=0):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1, 3, SIZE, SIZE))
    args, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[:-1] if len(shape) == 4 else shape[1:]))
            args[name] = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif name.endswith("_gamma"):
            args[name] = np.ones(shape)
        else:
            args[name] = rng.randn(*shape) * 0.1
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[name] = (np.ones(shape) if name.endswith("_var")
                     else rng.randn(*shape) * 0.1)
    cast = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa: E731
    return cast(args), cast(aux)


def to_package(mx, args, aux):
    if mx is tmx:
        return [{k: _from_data(t) for k, t in d.items()}
                for d in tmx.params_from_jax(args, aux, device=tmx.cpu())]
    return [{k: jmx.nd.array(v) for k, v in d.items()} for d in (args, aux)]


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    rng = np.random.RandomState(0)
    path = str(d / "train.rec")
    w = tmx.recordio.MXIndexedRecordIO(str(d / "train.idx"), path, "w")
    for i in range(2 * BATCH):
        img = rng.randint(0, 255, (SIZE, SIZE, 3)).astype(np.uint8)
        w.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i % CLASSES), i, 0), img,
            quality=90))
    w.close()
    return path


def record_iter(mx, rec, streaming):
    # two decode workers (threads or processes): parity needs no more,
    # and the tier-1 run shares the host's cores
    kw = dict(MEAN, streaming=streaming, preprocess_threads=2)
    if mx is tmx:
        kw["device"] = tmx.cpu()
    return mx.io.ImageRecordIter(rec, (3, SIZE, SIZE), BATCH, **kw)


def fit(mx, rec, streaming, args, aux, n_batches=2):
    sym = record_net(mx)
    mod = mx.mod.Module(sym, context=mx.cpu())
    it = record_iter(mx, rec, streaming)
    seen = []

    def on_batch(param):
        b = param.locals["data_batch"]
        seen.append((b.data[0].asnumpy(), b.label[0].asnumpy()))

    pargs, paux = to_package(mx, args, aux)
    try:
        mod.fit(mx.io.ResizeIter(it, n_batches), num_epoch=1,
                optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                                  "wd": 1e-4},
                arg_params=pargs, aux_params=paux,
                batch_end_callback=on_batch)
    finally:
        it.close()
    a, b = mod.get_params()
    vals = {k: v.asnumpy() for k, v in a.items()}
    vals.update({k: v.asnumpy() for k, v in b.items()})
    return mod, vals, seen


def rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(scope="module")
def jax_run(rec):
    args, aux = params(record_net(jmx))
    _, vals, seen = fit(jmx, rec, False, args, aux)
    return args, aux, vals, seen


@pytest.mark.parametrize("streaming", [True, False])
def test_record_fed_fit_matches_the_jax_package(rec, jax_run, streaming,
                                                monkeypatch):
    args, aux, want, want_seen = jax_run
    calls = []
    real = tfused.fused_matmul

    def counted(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(tfused, "fused_matmul", counted)
    _, got, seen = fit(tmx, rec, streaming, args, aux)
    assert len(seen) == len(want_seen) == 2
    for (gd, gl), (wd, wl) in zip(seen, want_seen):
        assert gd.dtype == wd.dtype == np.float32
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
    # the three bottlenecks' conv3 + residual add: one kernel-form region
    # each, one wrapper call per region per training forward
    assert len(calls) == 2 * 3
    start = dict(args, **aux)
    assert sorted(got) == sorted(want) == sorted(start)
    assert all(not np.array_equal(got[k], start[k]) for k in start)
    for k in want:
        assert rel_err(got[k], want[k]) <= FIT_TOL, (k, rel_err(got[k],
                                                                want[k]))


def jax_kernel_lowerings(args, aux, batch, monkeypatch):
    """Kernel-form regions of the JAX package's training forward: its
    lowering calls ``parallel.fused.fused_matmul`` for each, counted on a
    fresh bind with the Pallas call stubbed."""
    calls = []

    def stub(x, w, extras=(), epilogue=(), wt=True, out_dtype=None,
             interpret=False, **kw):
        calls.append(tuple(x.shape))
        n = w.shape[0] if wt else w.shape[1]
        return jnp.zeros((x.shape[0], n), out_dtype or x.dtype)

    monkeypatch.setattr(jfused, "fused_matmul", stub)
    jset_flag("MXNET_FUSION_INTERPRET", 1)
    try:
        mod = jmx.mod.Module(record_net(jmx), context=jmx.cpu())
        mod.bind(data_shapes=[("data", (BATCH, 3, SIZE, SIZE))],
                 label_shapes=[("softmax_label", (BATCH,))])
        mod.init_params(None, *to_package(jmx, args, aux))
        mod.forward(batch, is_train=True)
        mod.get_outputs()[0].asnumpy()
    finally:
        jset_flag("MXNET_FUSION_INTERPRET", None)
        monkeypatch.undo()
    return sorted(set(calls))


def test_fuse_report_and_first_forward_match(rec, monkeypatch):
    args, aux = params(record_net(jmx))
    mods, outs = {}, {}
    for mx in (jmx, tmx):
        mod = mx.mod.Module(record_net(mx), context=mx.cpu())
        it = record_iter(mx, rec, False)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        pargs, paux = to_package(mx, args, aux)
        mod.init_params(None, arg_params=pargs, aux_params=paux)
        batch = it.next()
        it.close()
        mod.forward(batch, is_train=True)
        vals = {"output": mod.get_outputs()[0].asnumpy()}
        vals.update({k: v[0].asnumpy() for k, v in zip(
            mod._exec_group.aux_names, mod._exec_group.aux_arrays)})
        mods[mx], outs[mx] = (mod, batch), vals
    regions = [mods[mx][0]._exec_group.execs[0].fused_regions()
               for mx in (jmx, tmx)]
    assert regions[1] == regions[0]
    assert [r["members"] for r in regions[1]] == [
        ["stage%d_unit1_conv3" % s, "broadcast_add%d" % (s - 1)]
        for s in (1, 2, 3)]
    for k in outs[jmx]:
        assert rel_err(outs[tmx][k], outs[jmx][k]) <= STEP_TOL, k
    # kernel-form regions: the port's wrapper calls in one training
    # forward against the JAX package's kernel lowerings
    port_calls = []

    def stub(x, w, extras=(), epilogue=(), wt=True, out_dtype=None):
        port_calls.append(tuple(x.shape))
        return torch.zeros((x.shape[0], w.shape[0] if wt else w.shape[1]))

    monkeypatch.setattr(tfused, "fused_matmul", stub)
    mods[tmx][0].forward(mods[tmx][1], is_train=True)
    monkeypatch.undo()
    jcalls = jax_kernel_lowerings(args, aux, mods[jmx][1], monkeypatch)
    assert sorted(port_calls) == jcalls
    assert len(jcalls) == 3


def test_channels_last_conv_of_a_transposed_view():
    """The composed graph's first Convolution receives ``transpose(data,
    (0, 2, 3, 1))``: an NHWC operand that is a view of NCHW memory. It runs
    on channels-last memory as a contiguous NHWC operand does (the same
    values and an NHWC-contiguous output), so the graph after it stays
    channels-last and its fused regions' GEMMs see the memory format the
    convolutions see (on the card, cuDNN picks its algorithms by it: a
    channels-first graph moved the first record-fed ResNet-50 step 7e-2
    away from MXNET_FUSION_KERNEL=0, a channels-last one equals it)."""
    from mxnet_tpu_torch.ops.registry import get_op

    op = get_op("Convolution")
    attrs = op.parse_attrs({"kernel": (3, 3), "num_filter": 4,
                            "pad": (1, 1), "layout": "NHWC"})
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 8, generator=gen)
    w = torch.randn(3, 3, 3, 4, generator=gen)
    b = torch.randn(4, generator=gen)
    view = x.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    (got,), _ = op.apply(attrs, [view, w, b])
    (want,), _ = op.apply(attrs, [view.contiguous(), w, b])
    assert got.is_contiguous() and want.is_contiguous()
    assert torch.equal(got, want)
