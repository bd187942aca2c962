"""Port parity: the ``amp`` graph pass (bfloat16 mixed precision with fp32
islands) against the JAX package's, on the CPU.

* the ``MXNET_GRAPH_PASSES`` grammar gives both packages the same pass sets
  (``all`` enables quantize in both);
* over the JAX tests' ``bn_heavy`` graph and a small NHWC bottleneck
  ResNet, the pipeline under ``default,amp`` gives the same per-pass
  reports (rewrite counts, fuse regions), the same rewritten graph and the
  same number of regions that take the fused kernel (the port's wrapper
  calls against the JAX regions whose Pallas form is eligible, counted in
  interpret mode); the outputs stay float32 and lie within 2e-2 of the JAX
  package's under amp, and within the JAX test's amp tolerance of the fp32
  pipeline (rtol 5e-2, atol 2e-2, tests/test_graph_passes.py);
* one ``Module`` training step under amp matches the JAX step within 2e-2
  of each tensor's max |value|;
* ``InferenceServer`` serves the amp graph: logits within 2e-2 of the JAX
  server's, the ``graph_pass`` stats carry ``amp``, and the
  ``graph_pass.precision_rewrites`` counter counts the casts.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import graph_pass as jgp
from mxnet_tpu.config import set_flag as jset_flag
from mxnet_tpu.ops import fused as jfused
from mxnet_tpu_torch import graph_pass as tgp
from mxnet_tpu_torch.parallel import fused as tfused

AMP_TOL = dict(rtol=5e-2, atol=2e-2)   # tests/test_graph_passes.py:163
PORT_TOL = 2e-2


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    from mxnet_tpu import autotune

    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    monkeypatch.delenv("MXNET_GRAPH_PASSES", raising=False)
    autotune.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for gp in (jgp, tgp):
        gp.set_passes(None)
    yield
    for gp in (jgp, tgp):
        gp.set_passes(None)
    jset_flag("MXNET_FUSION_INTERPRET", None)
    torch.set_num_threads(n)
    autotune.reset()


# ------------------------------------------------------------- the graphs

def _bn_heavy(mx):
    """tests/test_graph_passes.py _bn_heavy."""
    data = mx.sym.var("data")
    x = data
    for i, (nf, nb) in enumerate([(8, False), (12, True), (8, False)]):
        x = mx.sym.Convolution(x, kernel=(3, 3), num_filter=nf, pad=(1, 1),
                               no_bias=nb, name="c%d" % i)
        x = mx.sym.BatchNorm(x, name="bn%d" % i, fix_gamma=(i % 2 == 0))
        x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Pooling(x, global_pool=True, pool_type="avg", name="gp")
    x = mx.sym.Flatten(x)
    x = mx.sym.FullyConnected(x, num_hidden=5, name="fc")
    x = mx.sym.BatchNorm(x, name="bnf", fix_gamma=False, axis=1)
    return mx.sym.SoftmaxOutput(x, name="softmax"), (4, 3, 8, 8)


def _resnet_nhwc(mx):
    """ResNet-50's block structure at toy width: two bottleneck stages,
    channels-last, so its 1x1 convolutions take the fused kernel."""
    return mx.models.resnet.resnet(
        units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
        num_classes=10, image_shape=(3, 16, 16), bottle_neck=True,
        layout="NHWC"), (2, 16, 16, 3)


GRAPHS = {"bn_heavy": _bn_heavy, "resnet_nhwc": _resnet_nhwc}


def _built(make):
    """The same graph in both packages (the symbols' JSON equal)."""
    with jmx.name.NameManager():
        js, shape = make(jmx)
    with tmx.NameManager():
        ts, _ = make(tmx)
    assert js.tojson() == ts.tojson()
    return js, ts, shape


def _materialize(sym, shape, seed=7):
    """tests/test_graph_passes.py _materialize, as numpy."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n != "data" and not n.endswith("label")}
    auxs = {n: rng.uniform(0.5, 1.5, s).astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs, rng.uniform(0, 1, shape).astype(np.float32)


def _nd(mx, arrays):
    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in arrays.items()}


def _predict(mx, sym, shape, spec, args, auxs, x):
    """``Module.predict`` under the pass spec: (module, outputs)."""
    gp = mx.graph_pass
    gp.set_passes(spec)
    try:
        mod = mx.mod.Module(sym, context=mx.cpu())
        mod.bind(data_shapes=[("data", shape)], for_training=False)
        mod.init_params(mx.init.Uniform(0.1))
        mod.set_params(_nd(mx, args), _nd(mx, auxs))
        out = mod.predict(mx.io.NDArrayIter(x, None, batch_size=shape[0]))
        return mod, out.asnumpy()
    finally:
        gp.set_passes(None)


def _reports(mod):
    out = []
    for rep in mod._exec_group.execs[0]._opt.reports:
        rep = dict(rep)
        rep.pop("wall_ms")
        out.append(rep)
    return out


# ---------------------------------------------------------------- grammar

_SPECS = ("off", "default", "default,-bn_fold", "-bn_fold,default",
          "-bn_fold", "amp", "amp=float16", "amp=bfloat16,-fuse",
          "amp,-amp", "layout=nhwc", "fold,prune", "default,amp")


@pytest.mark.parametrize("spec", _SPECS)
def test_pass_config_grammar(spec):
    want, got = jgp.PassConfig(spec), tgp.PassConfig(spec)
    assert got.passes == want.passes
    assert got.amp_dtype == want.amp_dtype
    assert got.layout_force == want.layout_force


def test_pass_config_grammar_errors_and_all():
    assert "amp" in jgp.PassConfig("all").passes
    # 'all' is every pass, quantize included
    assert tgp.PassConfig("all").passes == jgp.PassConfig("all").passes
    assert "quantize" in tgp.PassConfig("all").passes
    assert tgp.PassConfig("all,-quantize").passes == \
        jgp.PassConfig("all,-quantize").passes
    for pkg in (jmx, tmx):
        with pytest.raises(pkg.base.MXNetError):
            pkg.graph_pass.PassConfig("default,bogus")
    assert tgp.PassConfig("default").signature() != \
        tgp.PassConfig("default,amp").signature()


# --------------------------------------------------------- the amp rewrite

def _port_kernel_calls(monkeypatch):
    calls = []
    real = tfused.fused_matmul

    def spy(x, w, *args, **kwargs):
        calls.append((x.dtype, w.dtype))
        return real(x, w, *args, **kwargs)

    monkeypatch.setattr(tfused, "fused_matmul", spy)
    return calls


def _jax_kernel_regions(monkeypatch, js, shape, args, auxs, x):
    """Regions whose Pallas form is eligible in the JAX package's amp
    forward (interpret mode): each such region's ``_try_kernel`` answers
    twice per trace (the eligibility probe, then the call), every other
    region once (the probe)."""
    answers = []
    real = jfused._try_kernel

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        answers.append(out is not None)
        return out

    monkeypatch.setattr(jfused, "_try_kernel", spy)
    jset_flag("MXNET_FUSION_INTERPRET", 1)
    try:
        _, out = _predict(jmx, js, shape, "default,amp", args, auxs, x)
    finally:
        jset_flag("MXNET_FUSION_INTERPRET", None)
    assert sum(answers) % 2 == 0
    return sum(answers) // 2, out


@pytest.mark.parametrize("name,kernel_regions", [("bn_heavy", 1),
                                                 ("resnet_nhwc", 5)])
def test_amp_rewrite_matches_jax(name, kernel_regions, monkeypatch):
    js, ts, shape = _built(GRAPHS[name])
    args, auxs, x = _materialize(js, shape)
    jm, jout = _predict(jmx, js, shape, "default,amp", args, auxs, x)
    _, jref = _predict(jmx, js, shape, "off", args, auxs, x)
    calls = _port_kernel_calls(monkeypatch)
    tm, tout = _predict(tmx, ts, shape, "default,amp", args, auxs, x)
    _, tref = _predict(tmx, ts, shape, "off", args, auxs, x)
    assert _reports(tm) == _reports(jm)
    by_pass = {r["pass"]: r for r in _reports(tm)}
    assert by_pass["amp"]["rewrites"] > 0
    topt, jopt = (m._exec_group.execs[0]._opt for m in (tm, jm))
    assert topt.symbol.tojson() == jopt.symbol.tojson()
    # kernel-form regions: the port's wrapper calls in one forward, with
    # bf16 operands, against the JAX package's eligible regions
    assert len(calls) == kernel_regions
    assert set(calls) == {(torch.bfloat16, torch.bfloat16)}
    jk, jinterp = _jax_kernel_regions(monkeypatch, js, shape, args, auxs, x)
    assert jk == kernel_regions
    assert tout.dtype == np.float32 and jout.dtype == np.float32
    np.testing.assert_allclose(tout, jout, rtol=0, atol=PORT_TOL)
    np.testing.assert_allclose(tout, jinterp, rtol=0, atol=PORT_TOL)
    np.testing.assert_allclose(tout, tref, **AMP_TOL)
    np.testing.assert_allclose(tref, jref, rtol=1e-5, atol=1e-6)


def test_amp_summary_stats_and_counter():
    from mxnet_tpu_torch.observability import metrics

    js, ts, shape = _built(_resnet_nhwc)
    args, auxs, x = _materialize(js, shape)
    metrics.set_enabled(True)
    metrics.reset_metrics()
    try:
        tm, _ = _predict(tmx, ts, shape, "default,amp", args, auxs, x)
        casts = metrics.get_value("graph_pass.precision_rewrites", 0)
    finally:
        metrics.reset_metrics()
        metrics.set_enabled(False)
    opt = tm._exec_group.execs[0]._opt
    amp = [r for r in opt.reports if r["pass"] == "amp"][0]
    assert casts == amp["rewrites"] == 22
    summary = opt.summary()
    assert summary["amp"] is True
    assert tgp.recent_reports()[-1]["amp"] is True
    tgp.note_program("generation", amp=True, dtype="float32")
    assert tgp.recent_reports()[-1] == {"program": "generation", "amp": True,
                                        "dtype": "float32"}


# ------------------------------------------------------ a training step

def _train_step(mx, sym, shape, args, auxs, x, y):
    """One SGD step of ``Module`` under ``default,amp``: (outputs of the
    step's forward, parameters after the update)."""
    mx.graph_pass.set_passes("default,amp")
    try:
        mod = mx.mod.Module(sym, context=mx.cpu())
        mod.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (shape[0],))])
        mod.init_params(mx.init.Uniform(0.1), arg_params=_nd(mx, args),
                        aux_params=_nd(mx, auxs), force_init=True)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        batch = mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                                [mx.nd.array(y, ctx=mx.cpu())])
        mod.forward_backward(batch)
        out = mod.get_outputs()[0].asnumpy()
        mod.update()
        opt = mod._exec_group.execs[0]._opt
        return out, {k: v.asnumpy() for k, v in
                     mod.get_params()[0].items()}, opt
    finally:
        mx.graph_pass.set_passes(None)


def test_module_train_step_under_amp():
    js, ts, shape = _built(_resnet_nhwc)
    args, auxs, x = _materialize(js, shape)
    y = np.array([3, 7], np.float32)
    jout, jparams, jopt = _train_step(jmx, js, shape, args, auxs, x, y)
    tout, tparams, topt = _train_step(tmx, ts, shape, args, auxs, x, y)
    assert topt.for_training and jopt.for_training
    assert [(r["pass"], r["rewrites"]) for r in topt.reports] == \
        [(r["pass"], r["rewrites"]) for r in jopt.reports]
    assert any(r["pass"] == "amp" and r["rewrites"] for r in topt.reports)
    assert tout.dtype == np.float32
    np.testing.assert_allclose(tout, jout, rtol=0, atol=PORT_TOL)
    assert set(tparams) == set(jparams)
    for k, want in jparams.items():
        scale = max(1.0, float(np.abs(want).max()))
        assert np.abs(tparams[k] - want).max() <= PORT_TOL * scale, k
        # the same parameters moved (a fix_gamma gamma stays)
        assert np.array_equal(tparams[k], args[k]) == \
            np.array_equal(want, args[k]), k


# ------------------------------------------------------------- serving

def test_inference_server_under_amp():
    import jax

    js, ts, shape = _built(_resnet_nhwc)
    args, auxs, x = _materialize(js, shape)
    outs = {}
    for name, pkg, dev in (("jax", jmx, jax.devices()[:1]),
                           ("torch", tmx, [tmx.cpu()])):
        sym = js if name == "jax" else ts
        pkg.graph_pass.set_passes("default,amp")
        try:
            srv = pkg.serving.InferenceServer(
                sym, args, auxs, data_shapes=[("data", (1,) + shape[1:])],
                devices=dev, config=pkg.serving.ServingConfig(
                    buckets=(1, 2), max_wait_ms=1))
        finally:
            pkg.graph_pass.set_passes(None)
        try:
            outs[name] = np.asarray(srv.submit(x).result(timeout=120))
            stats = srv.get_stats()
        finally:
            srv.stop()
        assert stats["graph_pass"]["amp"] is True
        passes = {r["pass"]: r["rewrites"]
                  for r in stats["graph_pass"]["passes"]}
        assert passes["amp"] == 22
    assert outs["torch"].dtype == np.float32
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=0,
                               atol=PORT_TOL)
