"""Port parity: int8 post-training quantization against the JAX package's,
on the CPU: the integer ops, calibration, the ``quantize`` rewrite, the
quantized model's outputs, the passes around it and the int8 serving bind.

* Integer ops on identical int32 inputs equal the JAX package's bit for
  bit: Convolution (NCHW and NHWC, stride, pad, groups), FullyConnected,
  ``dot``, ``batch_dot``; so do the lattice ops (``round`` half to even,
  ``clip``, ``Cast`` to int8 and int32, the weight scale's
  ``max(..., exclude=True, keepdims=True)``) and ``_contrib_quantize``
  (uint8 equal; ``_contrib_dequantize`` within 1e-6).
* Calibration: one package repeats its fingerprint byte for byte; across
  packages the ranges agree within 1e-5 relative, a table written by one
  loads in the other (same fingerprint as its writer's), and the
  percentile mode clips outliers as the JAX package's does.
* The rewrite, on the same symbol and the table loaded from the JAX
  package's JSON: the same rewritten graph (node names and ops), the same
  coverage report and skip reasons (fp32 islands, ``no_calibration``,
  ``tuned_fp32`` by the skip list and by the tuning cache, no table, no
  rewrite), and the per-channel scale math of a numpy reference.
* The quantized model: every island's int32 output, fed the JAX package's
  quantized inputs (tapped by the monitor), equals the JAX package's bit
  for bit; the quantized toy ResNet's outputs (the pruned head's softmax)
  lie within 1e-5 of max |output| of the JAX package's (measured: 3.2e-7
  at most over the four graphs; no activation lands on a rounding
  boundary here, so no int8 value flips) with top-1 agreement 1.0.
* Passes and binds: fold keeps int8 weights, the fuse report over the
  islands equals the JAX package's (regions, members, no kernel-form
  region), the pipeline does not rerun across rebinds, a training bind
  never quantizes, ``InferenceServer(quantize=)`` serves with a table or
  a path and raises without one, the stats and counter count the ops, and
  ``tune_quantize_layers`` pins the damaging layer (tests/test_quantize.py
  :619).
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import autotune as jautotune
from mxnet_tpu import graph_pass as jgp
from mxnet_tpu.config import set_flag as jset_flag
from mxnet_tpu.graph_pass import quantize as jqz
from mxnet_tpu.ops import fused as jfused
from mxnet_tpu_torch import autotune as tautotune
from mxnet_tpu_torch import graph_pass as tgp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.graph_pass import quantize as tqz
from mxnet_tpu_torch.parallel import fused as tfused

# the quantized models' outputs against the JAX package's, relative to
# max |output| (measured 3.2e-7 at most: the islands are exact, the fp32
# rescale, bias, pooling and softmax differ in summation order only)
LOGIT_TOL = 1e-5


@pytest.fixture(autouse=True)
def _hermetic(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tuning.json"))
    for name in ("MXNET_GRAPH_PASSES", "MXNET_QUANT_TABLE"):
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for gp in (jgp, tgp):
        gp.set_passes(None)
        gp.set_calibration_table(None)
        gp.set_quantize_skip(None)
        gp.reset_stats()
    for at in (jautotune, tautotune):
        at.reset()
    yield
    for gp in (jgp, tgp):
        gp.set_passes(None)
        gp.set_calibration_table(None)
        gp.set_quantize_skip(None)
    for at in (jautotune, tautotune):
        at.reset()
    torch.set_num_threads(n)


# ---------------------------------------------------------------- helpers

def _i32(rng, shape, lim=127):
    return rng.randint(-lim, lim + 1, size=shape).astype(np.int32)


def _jnd(a):
    return jmx.nd.array(a, dtype=a.dtype)


def _tnd(a):
    return tmx.nd.array(a, ctx=tmx.cpu(), dtype=a.dtype)


def _both(op, arrays, **attrs):
    """(jax result, port result) of ``mx.nd.<op>`` on the same arrays."""
    j = getattr(jmx.nd, op)(*[_jnd(a) for a in arrays], **attrs)
    t = getattr(tmx.nd, op)(*[_tnd(a) for a in arrays], **attrs)
    return j, t


def _bit_equal(t, j):
    t, j = np.asarray(t.asnumpy()), np.asarray(j.asnumpy())
    assert t.dtype == j.dtype, (t.dtype, j.dtype)
    assert t.shape == j.shape, (t.shape, j.shape)
    assert np.array_equal(t, j)


def _conv_net(mx):
    """tests/test_quantize.py _conv_net."""
    data = mx.sym.var("data")
    x = data
    for i in range(2):
        x = mx.sym.Convolution(x, kernel=(3, 3), num_filter=8, pad=(1, 1),
                               no_bias=(i == 1), name="c%d" % i)
        x = mx.sym.BatchNorm(x, name="bn%d" % i, fix_gamma=(i == 0))
        x = mx.sym.Activation(x, act_type="relu", name="act%d" % i)
    x = mx.sym.Flatten(x, name="flat")
    x = mx.sym.FullyConnected(x, num_hidden=7, name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax"), (6, 3, 10, 10), "fc"


def _fc_net(mx):
    """tests/test_quantize.py _fc_net."""
    data = mx.sym.var("data")
    x = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    x = mx.sym.Activation(x, act_type="relu", name="act")
    x = mx.sym.FullyConnected(x, num_hidden=5, name="fc2")
    return mx.sym.SoftmaxOutput(x, name="softmax"), (8, 12), "fc2"


def _matmul_net(mx):
    """Two activation-side matmuls (the per-tensor dot / batch_dot
    islands) beside a frozen-operand dot that stays fp32."""
    data = mx.sym.var("data")
    w = mx.sym.var("proj_weight", shape=(6, 3))
    a = mx.sym.FullyConnected(data, num_hidden=6, no_bias=True, name="pa")
    b = mx.sym.FullyConnected(data, num_hidden=6, no_bias=True, name="pb")
    d = mx.sym.dot(a, b, transpose_b=True, name="aat")
    a3 = mx.sym.Reshape(a, shape=(2, 2, 6), name="a3")
    b3 = mx.sym.Reshape(b, shape=(2, 2, 6), name="b3")
    bd = mx.sym.batch_dot(a3, b3, transpose_b=True, name="bdot")
    fw = mx.sym.dot(a, w, name="frozen_dot")
    out = mx.sym.Group([d, bd, fw])
    return out, (4, 5), None


def _resnet(mx):
    """The bench's QUICK geometry: ResNet 8 layers at 16 px, 10 classes."""
    return (mx.models.get_resnet(num_classes=10, num_layers=8,
                                 image_shape=(3, 16, 16)),
            (4, 3, 16, 16), "fc1")


def _resnet_nhwc(mx):
    """ResNet-50's block structure at toy width, channels-last
    (tests/test_torch_amp.py's)."""
    return (mx.models.resnet.resnet(
        units=[1, 1], num_stages=2, filter_list=[8, 16, 32],
        num_classes=10, image_shape=(3, 16, 16), bottle_neck=True,
        layout="NHWC"), (2, 16, 16, 3), "fc1")


GRAPHS = {"conv": _conv_net, "fc": _fc_net, "matmul": _matmul_net,
          "resnet": _resnet, "resnet_nhwc": _resnet_nhwc}


def _built(make):
    with jmx.name.NameManager():
        js, shape, head = make(jmx)
    with tmx.NameManager():
        ts, _, _ = make(tmx)
    assert js.tojson() == ts.tojson()
    return js, ts, shape, head


def _materialize(sym, shape, head=None, seed=7, head_gain=8.0):
    """tests/test_quantize.py _materialize, as numpy."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n != "data" and not n.endswith("label")}
    if head is not None:
        args[head + "_weight"] = args[head + "_weight"] * head_gain
    auxs = {n: rng.uniform(0.5, 1.5, s).astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs, rng.uniform(0, 1, shape).astype(np.float32)


def _nd(mx, arrays):
    return {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in arrays.items()}


def _bind(mx, sym, spec, shape, args, auxs):
    mx.graph_pass.set_passes(spec)
    try:
        mod = mx.mod.Module(sym, context=mx.cpu(),
                            label_names=[n for n in sym.list_arguments()
                                         if n.endswith("label")])
        mod.bind(data_shapes=[("data", shape)], for_training=False)
        mod.init_params(mx.init.Uniform(0.1))
        mod.set_params(_nd(mx, args), _nd(mx, auxs))
        return mod
    finally:
        mx.graph_pass.set_passes(None)


def _predict(mx, mod, x):
    out = mod.predict(mx.io.NDArrayIter(x, None, batch_size=x.shape[0]))
    return (out[0] if isinstance(out, list) else out).asnumpy()


def _opt(mod):
    return mod._exec_group.execs[0]._opt


def _quant_summary(mod):
    return _opt(mod).summary().get("quantize", {})


def _calibrated(make, tmp_path, spec="default"):
    """Both packages' modules under ``spec``, the JAX package's table
    saved to JSON and loaded by both, and the inputs."""
    js, ts, shape, head = _built(make)
    args, auxs, x = _materialize(js, shape, head)
    jm = _bind(jmx, js, spec, shape, args, auxs)
    table = jgp.calibrate(jm, [x])
    path = str(tmp_path / "table.json")
    table.save(path)
    return dict(js=js, ts=ts, shape=shape, args=args, auxs=auxs, x=x,
                jm=jm, path=path, jtable=jqz.CalibrationTable.load(path),
                ttable=tqz.CalibrationTable.load(path))


def _quantized(c, spec="default,quantize"):
    """(jax module, port module) bound under ``spec`` with the table."""
    jgp.set_calibration_table(c["jtable"])
    tgp.set_calibration_table(c["ttable"])
    jq = _bind(jmx, c["js"], spec, c["shape"], c["args"], c["auxs"])
    tq = _bind(tmx, c["ts"], spec, c["shape"], c["args"], c["auxs"])
    return jq, tq


# ----------------------------------------------------- integer operations

_CONV_CASES = {
    "nchw_stride_pad": dict(shape=(2, 3, 9, 9), kernel=(3, 3),
                            stride=(2, 2), pad=(1, 1), num_filter=5),
    "nchw_groups": dict(shape=(2, 4, 7, 7), kernel=(3, 3), pad=(1, 1),
                        num_filter=6, num_group=2),
    "nchw_1x1_bias": dict(shape=(3, 8, 5, 5), kernel=(1, 1), num_filter=4,
                          no_bias=False),
    "nhwc_stride_pad": dict(shape=(2, 9, 9, 3), kernel=(3, 3),
                            stride=(2, 2), pad=(1, 1), num_filter=5,
                            layout="NHWC"),
    "nhwc_groups": dict(shape=(2, 7, 7, 4), kernel=(3, 3), pad=(1, 1),
                        num_filter=6, num_group=2, layout="NHWC"),
    "nhwc_7x7_stem": dict(shape=(2, 16, 16, 3), kernel=(7, 7),
                          stride=(2, 2), pad=(3, 3), num_filter=8,
                          layout="NHWC"),
}


@pytest.mark.parametrize("case", sorted(_CONV_CASES))
def test_integer_convolution_bit_identical(case):
    kw = dict(_CONV_CASES[case])
    shape = kw.pop("shape")
    kw.setdefault("no_bias", True)
    sym = tmx.sym.Convolution(tmx.sym.var("data"), name="c", **kw)
    arg_shapes, _, _ = sym.infer_shape(data=shape)
    rng = np.random.RandomState(len(case))
    arrays = [_i32(rng, s) for s in arg_shapes]
    j, t = _both("Convolution", arrays, **kw)
    _bit_equal(t, j)
    assert t.dtype == np.int32


@pytest.mark.parametrize("case", ["fc", "fc_bias_nd", "dot", "dot_ta",
                                  "dot_tb", "batch_dot", "batch_dot_tb",
                                  "wide_reduction"])
def test_integer_contractions_bit_identical(case):
    rng = np.random.RandomState(hash(case) % 1000)
    if case == "fc":
        arrays, op, kw = [_i32(rng, (5, 9)), _i32(rng, (4, 9))], \
            "FullyConnected", dict(num_hidden=4, no_bias=True)
    elif case == "fc_bias_nd":
        arrays, op, kw = [_i32(rng, (3, 2, 6)), _i32(rng, (4, 12)),
                          _i32(rng, (4,))], "FullyConnected", \
            dict(num_hidden=4)
    elif case.startswith("dot"):
        ta, tb = case == "dot_ta", case == "dot_tb"
        a = _i32(rng, (6, 5) if ta else (5, 6))
        b = _i32(rng, (7, 6) if tb else (6, 7))
        arrays, op, kw = [a, b], "dot", dict(transpose_a=ta,
                                             transpose_b=tb)
    elif case.startswith("batch_dot"):
        tb = case.endswith("tb")
        arrays, op, kw = [_i32(rng, (3, 4, 5)),
                          _i32(rng, (3, 6, 5) if tb else (3, 5, 6))], \
            "batch_dot", dict(transpose_b=tb)
    else:
        # ResNet-50's widest reduction: 3 x 3 x 512 = 4608 products
        arrays, op, kw = [_i32(rng, (2, 4608)), _i32(rng, (3, 4608))], \
            "FullyConnected", dict(num_hidden=3, no_bias=True)
    j, t = _both(op, arrays, **kw)
    _bit_equal(t, j)


def test_lattice_ops_bit_identical():
    """The quantize island's elementwise steps on the same float inputs:
    divide, round half to even (exact .5 ties included), clip, the casts,
    and the weight scale's exclude-max."""
    rng = np.random.RandomState(5)
    x = rng.uniform(-200, 200, (4, 3, 5)).astype(np.float32)
    x[0, 0, :4] = [0.5, 1.5, -2.5, 126.5]
    for mx, out in ((jmx, {}), (tmx, {})):
        a = (mx.nd.array(x) if mx is jmx else _tnd(x))
        r = mx.nd.round(a)
        c = mx.nd.clip(r, a_min=-127.0, a_max=127.0)
        i8 = mx.nd.Cast(c, dtype="int8")
        i32 = mx.nd.Cast(i8, dtype="int32")
        back = mx.nd.Cast(i32, dtype="float32")
        m = mx.nd.max(mx.nd.abs(a), axis=(2,), exclude=True, keepdims=True)
        div = a / 0.37
        if mx is jmx:
            want = [v.asnumpy() for v in (r, c, i8, i32, back, m, div)]
        else:
            got = [v.asnumpy() for v in (r, c, i8, i32, back, m, div)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert list(got[0][0, 0, :4]) == [0.0, 2.0, -2.0, 126.0]


def test_contrib_quantize_dequantize():
    rng = np.random.RandomState(6)
    x = rng.uniform(-3, 2, (5, 7)).astype(np.float32)
    lo = np.array([-3.0], np.float32)
    hi = np.array([2.0], np.float32)
    jq, jlo, jhi = jmx.nd.contrib.quantize(*[jmx.nd.array(a)
                                             for a in (x, lo, hi)])
    tq, tlo, thi = tmx.nd.contrib.quantize(*[_tnd(a) for a in (x, lo, hi)])
    _bit_equal(tq, jq)
    assert tq.dtype == np.uint8
    assert np.array_equal(tlo.asnumpy(), lo) and \
        np.array_equal(thi.asnumpy(), hi)
    jd = jmx.nd.contrib.dequantize(jq, jlo, jhi).asnumpy()
    td = tmx.nd.contrib.dequantize(tq, tlo, thi).asnumpy()
    assert td.dtype == np.float32
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    # the symbolic form infers the three outputs' shapes
    s = tmx.sym.contrib.quantize(tmx.sym.var("d"), tmx.sym.var("lo"),
                                 tmx.sym.var("hi"))
    _, outs, _ = s.infer_shape(d=(5, 7), lo=(1,), hi=(1,))
    assert outs == [(5, 7), (1,), (1,)]


# ------------------------------------------------------------ calibration

def test_calibration_deterministic_and_matches_jax(tmp_path):
    js, ts, shape, head = _built(_conv_net)
    args, auxs, x = _materialize(js, shape, head)
    batches = [x[i:i + 2] for i in range(0, 6, 2)]
    tm = _bind(tmx, ts, "default", shape, args, auxs)
    t1 = tgp.calibrate(tm, batches)
    t2 = tgp.calibrate(tm, batches)
    assert t1.batches == 3 and len(t1) > 3
    assert t1.fingerprint() == t2.fingerprint()
    jt = jgp.calibrate(_bind(jmx, js, "default", shape, args, auxs),
                       batches)
    assert sorted(t1.ranges()) == sorted(jt.ranges())
    assert "data" in t1.ranges() and "act0_output" in t1.ranges()
    for name, want in jt.ranges().items():
        assert abs(t1.get(name) - want) <= 1e-5 * abs(want), name
    # a table written by either package loads in the other, and the
    # reader's fingerprint is the writer's
    for writer, reader, table in ((jqz, tqz, jt), (tqz, jqz, t1)):
        path = str(tmp_path / ("%s.json" % writer.__name__))
        table.save(path)
        loaded = reader.CalibrationTable.load(path)
        assert loaded.fingerprint() == table.fingerprint()
        assert loaded.ranges() == table.ranges()
        assert loaded.batches == 3
    # the JSON layout is the JAX package's
    with open(str(tmp_path / ("%s.json" % tqz.__name__))) as f:
        assert set(json.load(f)) == {"version", "mode", "percentile",
                                     "batches", "ranges"}


def test_calibration_percentile_mode_matches_jax():
    arr = np.ones(1000, np.float32)
    arr[0] = 1000.0
    arr[1:50] = np.linspace(1, 3, 49)
    got = {}
    for pkg in (jqz, tqz):
        t = pkg.CalibrationTable(mode="percentile", percentile=90.0)
        t.observe("x", arr)
        t_abs = pkg.CalibrationTable(mode="absmax")
        t_abs.observe("x", arr)
        t_abs.observe("x", np.array([np.inf], np.float32))
        got[pkg] = (t.get("x"), t_abs.get("x"), t.fingerprint())
    assert got[tqz] == got[jqz]
    assert got[tqz][0] < 2.0 and got[tqz][1] == 1000.0
    with pytest.raises(ValueError):
        tqz.CalibrationTable(mode="minmax")


def test_calibrate_needs_a_bound_module():
    mod = tmx.mod.Module(_fc_net(tmx)[0], context=tmx.cpu())
    with pytest.raises(MXNetError, match="bound Module"):
        tgp.calibrate(mod, [np.zeros((8, 12), np.float32)])


# ------------------------------------------------------------- the rewrite

def _graph(opt):
    return [(n.name, n.op, dict(n.attrs))
            for n in opt.symbol.topo_nodes()]


@pytest.mark.parametrize("name", ["conv", "fc", "matmul", "resnet",
                                  "resnet_nhwc"])
def test_rewrite_matches_jax(name, tmp_path):
    c = _calibrated(GRAPHS[name], tmp_path)
    jq, tq = _quantized(c)
    jopt, topt = _opt(jq), _opt(tq)
    assert _graph(topt) == _graph(jopt)
    assert topt.symbol.tojson() == jopt.symbol.tojson()
    tsum, jsum = topt.summary(), jopt.summary()
    assert tsum["quantize"] == jsum["quantize"]
    assert tsum["quantize"]["table"] == c["jtable"].fingerprint()
    rep = [r for r in topt.reports if r["pass"] == "quantize"][0]
    jrep = [r for r in jopt.reports if r["pass"] == "quantize"][0]
    assert rep["detail"] == jrep["detail"]
    assert rep["rewrites"] == jrep["rewrites"] > 0
    if name == "matmul":
        assert rep["detail"]["skipped"] == {
            "frozen_dot": "frozen_matmul_input"}
        assert rep["detail"]["quantized"] == ["pa", "pb", "aat", "bdot"]


def test_skip_reasons_match_jax(tmp_path):
    c = _calibrated(_conv_net, tmp_path)
    cases = {}
    # the tuned skip list, a table without the FC's input range, no table
    # at all, the tuning cache's quantize.layers entry (last: the entry
    # persists in the test's cache file)
    for case in ("skip_list", "no_calibration", "no_table", "tuned_cache"):
        jtab, ttab = c["jtable"], c["ttable"]
        if case == "no_calibration":
            ranges = dict(c["jtable"].ranges())
            del ranges["flat_output"]
            jtab, ttab = jqz.CalibrationTable(), tqz.CalibrationTable()
            for k, v in ranges.items():
                jtab.observe(k, np.array([v]))
                ttab.observe(k, np.array([v]))
        for gp, at, tab, mx, sym in ((jgp, jautotune, jtab, jmx, c["js"]),
                                     (tgp, tautotune, ttab, tmx, c["ts"])):
            gp.set_calibration_table(None if case == "no_table" else tab)
            gp.set_quantize_skip(["c1"] if case == "skip_list" else None)
            if case == "tuned_cache":
                at.record("quantize.layers", gp.graph_fingerprint(sym),
                          {"skip": ["fc"]})
            mod = _bind(mx, sym, "default,quantize", c["shape"], c["args"],
                        c["auxs"])
            summary = _opt(mod).summary() if _opt(mod) is not None else {}
            rep = [r for r in _opt(mod).reports if r["pass"] == "quantize"]
            cases.setdefault(case, []).append(
                (summary.get("quantize"), rep[0]["detail"]))
            gp.set_quantize_skip(None)
            at.reset()
    assert cases["skip_list"][1] == cases["skip_list"][0]
    assert cases["skip_list"][1][1]["skipped"] == {"c1": "tuned_fp32"}
    assert cases["tuned_cache"][1] == cases["tuned_cache"][0]
    assert cases["tuned_cache"][1][1]["skipped"] == {"fc": "tuned_fp32"}
    assert cases["no_calibration"][1] == cases["no_calibration"][0]
    assert cases["no_calibration"][1][1]["skipped"] == {
        "fc": "no_calibration"}
    assert cases["no_table"][1][1] == cases["no_table"][0][1]
    assert cases["no_table"][1][1]["skipped"] == {
        "*": "no_calibration_table"}
    assert cases["no_table"][1][1]["ops_quantized"] == 0


def test_fp32_islands_and_no_table_means_no_rewrite(tmp_path):
    c = _calibrated(_conv_net, tmp_path)
    _, tq = _quantized(c)
    topt = _opt(tq)
    ops = [(n.op, n.attrs) for n in topt.symbol.topo_nodes()
           if not n.is_variable]
    assert "softmax" in [o for o, _ in ops]
    assert topt.symbol._outputs[0][0].op == "softmax"
    assert any(o == "Cast" and a.get("dtype") == "int8" for o, a in ops)
    # without a table the quantize pass is a spec-level no-op
    tgp.set_calibration_table(None)
    plain = _bind(tmx, c["ts"], "default", c["shape"], c["args"], c["auxs"])
    noq = _bind(tmx, c["ts"], "default,quantize", c["shape"], c["args"],
                c["auxs"])
    np.testing.assert_array_equal(_predict(tmx, noq, c["x"]),
                                  _predict(tmx, plain, c["x"]))


def test_per_channel_scale_math_vs_numpy():
    """tests/test_quantize.py:153, on the port."""
    data = tmx.sym.var("data")
    out = tmx.sym.FullyConnected(data, num_hidden=5, name="fc")
    rng = np.random.RandomState(3)
    W = rng.uniform(-0.7, 0.7, (5, 9)).astype(np.float32)
    b = rng.uniform(-0.2, 0.2, (5,)).astype(np.float32)
    x = rng.uniform(-1.2, 1.2, (4, 9)).astype(np.float32)
    args = {"fc_weight": W, "fc_bias": b}
    mod = _bind(tmx, out, "default", x.shape, args, {})
    tgp.set_calibration_table(tgp.calibrate(mod, [x]))
    qmod = _bind(tmx, out, "default,quantize", x.shape, args, {})
    got = _predict(tmx, qmod, x)
    assert _quant_summary(qmod)["ops_quantized"] == 1
    s_x = max(float(np.abs(x).max()), 1e-12) / 127.0
    xq = np.clip(np.round(x / s_x), -127, 127).astype(np.int32)
    s_w = np.maximum(np.abs(W).max(axis=1, keepdims=True) / 127.0, 1e-12)
    wq = np.clip(np.round(W / s_w), -127, 127).astype(np.int32)
    ref = (xq @ wq.T).astype(np.float32) * (s_x * s_w[:, 0])[None, :] + b
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------- the quantized model

def _tap(mx, mod, x):
    """{entry name: value} of every node output in one monitored forward."""
    seen = {}
    exe = mod._exec_group.execs[0]
    exe.set_monitor_callback(lambda n, v: seen.__setitem__(n, v.asnumpy()))
    try:
        _predict(mx, mod, x)
    finally:
        exe.set_monitor_callback(None)
    return seen


@pytest.mark.parametrize("name", ["conv", "resnet", "resnet_nhwc",
                                  "matmul"])
def test_island_int32_outputs_bit_identical(name, tmp_path):
    """Each island's integer contraction, fed the JAX package's quantized
    int32 operands (tapped by the monitor, with fuse off so the islands
    stay visible), gives the JAX package's int32 output bit for bit."""
    c = _calibrated(GRAPHS[name], tmp_path, spec="default,-fuse")
    jq, tq = _quantized(c, spec="default,quantize,-fuse")
    jtap = _tap(jmx, jq, c["x"])
    topt = _opt(tq)
    islands = [n for n in topt.symbol.topo_nodes()
               if n.name.startswith("_gp_qz") and n.name.endswith("_int")]
    assert len(islands) == _quant_summary(tq)["ops_quantized"] > 0
    folded = dict(tq._exec_group.execs[0]._folded())
    for node in islands:
        ins = []
        for src, idx in node.inputs:
            key = src.name if src.is_variable else (
                src.name + "_output")
            if src.is_variable:
                ins.append(folded[src.name].numpy())
            else:
                ins.append(jtap[key])
        assert all(a.dtype == np.int32 for a in ins), node.name
        want = jtap[node.name + "_output"]
        attrs = node.parsed_attrs()
        outs, _ = node.opdef().apply(attrs, [torch.from_numpy(a)
                                             for a in ins], [])
        got = outs[0].numpy()
        assert got.dtype == want.dtype == np.int32, node.name
        assert np.array_equal(got, want), node.name
    # and the port's own walk reaches the same int32 values
    ttap = _tap(tmx, tq, c["x"])
    same = sum(np.array_equal(ttap[n.name + "_output"],
                              jtap[n.name + "_output"]) for n in islands)
    assert same == len(islands)


@pytest.mark.parametrize("name", ["resnet", "resnet_nhwc", "conv", "fc"])
def test_quantized_logits_match_jax(name, tmp_path):
    c = _calibrated(GRAPHS[name], tmp_path)
    jq, tq = _quantized(c)
    jout, tout = _predict(jmx, jq, c["x"]), _predict(tmx, tq, c["x"])
    err = float(np.abs(tout - jout).max())
    assert err <= LOGIT_TOL * float(np.abs(jout).max()), err
    assert (tout.argmax(1) == jout.argmax(1)).mean() == 1.0
    # and int8 against fp32 stays at the JAX test's bar
    fp32 = _predict(tmx, _bind(tmx, c["ts"], "default", c["shape"],
                               c["args"], c["auxs"]), c["x"])
    assert (fp32.argmax(1) == tout.argmax(1)).mean() >= 0.99


def test_fold_materializes_int8_weights(tmp_path):
    c = _calibrated(_resnet, tmp_path)
    _, tq = _quantized(c)
    info = _quant_summary(tq)
    assert info["ops_quantized"] == info["ops_eligible"] > 5
    folded = tq._exec_group.execs[0]._folded()
    int8 = [n for n, v in folded.items() if v.dtype == torch.int8]
    assert len(int8) == info["ops_quantized"]
    # the widening cast stays in the graph, behind the fold barrier
    widen = [n for n in _opt(tq).symbol.topo_nodes()
             if n.name.endswith("_w_i32")]
    assert widen and all(n.user_attrs.get("__nofold__") == "1"
                         for n in widen)


def _jax_kernel_regions(monkeypatch, c, spec):
    answers = []
    real = jfused._try_kernel

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        answers.append(out is not None)
        return out

    monkeypatch.setattr(jfused, "_try_kernel", spy)
    jset_flag("MXNET_FUSION_INTERPRET", 1)
    try:
        jgp.set_calibration_table(c["jtable"])
        mod = _bind(jmx, c["js"], spec, c["shape"], c["args"], c["auxs"])
        _predict(jmx, mod, c["x"])
    finally:
        jset_flag("MXNET_FUSION_INTERPRET", None)
    return sum(answers) // 2


@pytest.mark.parametrize("name", ["conv", "resnet_nhwc"])
def test_fuse_report_over_int_islands_matches_jax(name, tmp_path,
                                                  monkeypatch):
    """The rescale and the bias are epilogue steps: regions carve over the
    int islands exactly as in the JAX package, and no region whose root is
    an int32 contraction takes the fused kernel (none does in the JAX
    package's interpret-mode forward either)."""
    c = _calibrated(GRAPHS[name], tmp_path)
    jq, tq = _quantized(c)
    jf, tf = _opt(jq).summary()["fuse"], _opt(tq).summary()["fuse"]
    assert tf == jf
    assert tf["regions"]
    assert [r["members"] for r in tq._exec_group.execs[0].fused_regions()] \
        == [r["members"] for r in jq._exec_group.execs[0].fused_regions()]
    calls = []
    real = tfused.fused_matmul
    monkeypatch.setattr(tfused, "fused_matmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _predict(tmx, tq, c["x"])
    assert len(calls) == _jax_kernel_regions(monkeypatch, c,
                                             "default,quantize") == 0


def test_rebinds_flat_and_training_binds_never_quantize(tmp_path):
    c = _calibrated(_conv_net, tmp_path)
    tgp.set_calibration_table(c["ttable"])
    tgp.set_passes("default,quantize")
    try:
        mod = tmx.mod.Module(c["ts"], context=tmx.cpu())
        mod.bind(data_shapes=[("data", c["shape"])], for_training=False)
        mod.init_params(tmx.init.Uniform(0.1))
        mod.set_params(_nd(tmx, c["args"]), _nd(tmx, c["auxs"]))
        ref = _predict(tmx, mod, c["x"])
        runs = tgp.stats()["pipeline_runs"]
        small = c["x"][:2]
        for _ in range(2):
            mod.reshape([("data", small.shape)])
            np.testing.assert_array_equal(_predict(tmx, mod, small),
                                          ref[:2])
            mod.reshape([("data", c["shape"])])
            _predict(tmx, mod, c["x"])
        assert tgp.stats()["pipeline_runs"] == runs
        # a training bind under the same spec never quantizes
        train = tmx.mod.Module(c["ts"], context=tmx.cpu())
        train.bind(data_shapes=[("data", c["shape"])],
                   label_shapes=[("softmax_label", (c["shape"][0],))])
        opt = _opt(train)
        assert opt is None or "quantize" not in [r["pass"]
                                                 for r in opt.reports]
    finally:
        tgp.set_passes(None)
    opt = tgp.optimize(c["ts"], for_training=True,
                       frozen=set(c["args"]) | set(c["auxs"]),
                       arg_shapes={"data": c["shape"]},
                       config=tgp.PassConfig(spec="default,quantize"))
    assert "quantize" not in [r["pass"] for r in (opt.reports if opt
                                                  else [])]


def test_grammar_signature_and_env_table(tmp_path, monkeypatch):
    c = _calibrated(_fc_net, tmp_path)
    for spec in ("default,quantize", "all", "all,-quantize",
                 "quantize=%s" % c["path"]):
        assert tgp.PassConfig(spec).passes == jgp.PassConfig(spec).passes
    cfg = tgp.PassConfig("default,quantize=%s" % c["path"])
    assert cfg.quant_table == c["path"]
    assert tqz.resolve_table(cfg).fingerprint() == \
        c["jtable"].fingerprint()
    assert cfg.signature() != tgp.PassConfig("default,quantize").signature()
    sig = [tgp.PassConfig(spec="default,quantize", quant_table=t,
                          quant_skip=s).signature()
           for t, s in ((c["ttable"], ()), (c["ttable"], ("fc1",)))]
    assert sig[0] != sig[1]
    # a configured table that does not load raises, never binds fp32
    bad = tgp.PassConfig("default,quantize=%s" % (tmp_path / "none.json"))
    with pytest.raises(MXNetError, match="failed to load"):
        bad.signature()
    # MXNET_GRAPH_PASSES + MXNET_QUANT_TABLE drive Module.predict
    monkeypatch.setenv("MXNET_GRAPH_PASSES", "default,quantize")
    monkeypatch.setenv("MXNET_QUANT_TABLE", c["path"])
    mod = tmx.mod.Module(c["ts"], context=tmx.cpu())
    mod.bind(data_shapes=[("data", c["shape"])], for_training=False)
    mod.init_params(tmx.init.Uniform(0.1))
    mod.set_params(_nd(tmx, c["args"]), _nd(tmx, c["auxs"]))
    _predict(tmx, mod, c["x"])
    assert _quant_summary(mod)["ops_quantized"] == 2


def test_stats_summary_and_counter(tmp_path):
    from mxnet_tpu_torch.observability import metrics

    c = _calibrated(_conv_net, tmp_path)
    tgp.set_quantize_skip(["fc"])
    metrics.set_enabled(True)
    metrics.reset_metrics()
    try:
        _, tq = _quantized(c)
        counted = metrics.get_value("graph_pass.quantized_ops", 0)
    finally:
        metrics.reset_metrics()
        metrics.set_enabled(False)
    info = _quant_summary(tq)
    assert info["skipped"] == {"fc": "tuned_fp32"}
    assert counted == info["ops_quantized"] == 2
    stats = tgp.stats()
    assert stats["quantized_ops"] >= 2 and stats["quantize_skipped"] >= 1
    recent = [r for r in tgp.recent_reports() if "quantize" in r]
    assert recent[-1]["quantize"]["table"] == c["ttable"].fingerprint()


# ------------------------------------------------------------ serving bind

def test_inference_server_quantize_with_table_or_path(tmp_path):
    c = _calibrated(_conv_net, tmp_path)
    ref = _predict(tmx, _bind(tmx, c["ts"], "default", c["shape"],
                              c["args"], c["auxs"]), c["x"])
    jgp.set_calibration_table(c["jtable"])
    jq = _bind(jmx, c["js"], "default,quantize", c["shape"], c["args"],
               c["auxs"])
    jout = _predict(jmx, jq, c["x"])
    for quantize in (c["ttable"], c["path"]):
        srv = tmx.serving.InferenceServer(
            c["ts"], c["args"], c["auxs"],
            data_shapes=[("data", c["shape"])], devices=[tmx.cpu()],
            quantize=quantize)
        try:
            out = np.asarray(srv.predict(c["x"], timeout=120))
            q = srv.get_stats()["graph_pass"]["quantize"]
            int8 = [n for n, v in srv._replica_args[0].items()
                    if v.dtype == torch.int8]
        finally:
            srv.stop()
        assert q["ops_quantized"] == 3 and q["table"] == \
            c["jtable"].fingerprint()
        assert len(int8) == q["ops_quantized"]
        assert (out.argmax(1) == ref.argmax(1)).all()
        np.testing.assert_allclose(out, jout, rtol=0, atol=1e-6)


def test_inference_server_quantize_ambient_or_raise(tmp_path):
    c = _calibrated(_fc_net, tmp_path)
    with pytest.raises(MXNetError, match="calibration table"):
        tmx.serving.InferenceServer(c["ts"], c["args"], c["auxs"],
                                    data_shapes=[("data", c["shape"])],
                                    devices=[tmx.cpu()], quantize=True,
                                    start=False)
    tgp.set_calibration_table(c["ttable"])
    srv = tmx.serving.InferenceServer(c["ts"], c["args"], c["auxs"],
                                      data_shapes=[("data", c["shape"])],
                                      devices=[tmx.cpu()], quantize=True,
                                      start=False)
    try:
        assert srv.get_stats()["graph_pass"]["quantize"][
            "ops_quantized"] == 2
    finally:
        srv.stop()


# ------------------------------------------------------------------ tuner

def test_tune_quantize_layers_greedy_drop(tmp_path):
    """tests/test_quantize.py:619: with the FC's activation range poisoned
    the arbiter pins exactly that layer, and a later bind consults it."""
    js, ts, shape, head = _built(_conv_net)
    args, auxs, x = _materialize(js, shape, head)
    mod = _bind(tmx, ts, "default", shape, args, auxs)
    table = tgp.calibrate(mod, [x])
    table.observe("flat_output", np.array([1e6], np.float32))
    out = tautotune.tune_quantize_layers(mod, [x], table, budget=0.99)
    assert "fc" in out["skip"] and out["agreement"] >= 0.99
    assert tautotune.stats()["measurements"] >= 1
    tgp.set_calibration_table(table)
    qmod = _bind(tmx, ts, "default,quantize", shape, args, auxs)
    assert _quant_summary(qmod)["skipped"].get("fc") == "tuned_fp32"


def test_served_fuse_report_matches_jax(tmp_path):
    """The int8 server's own pipeline (every parameter frozen, only the
    data's shape known at bind) carves the same regions as the JAX
    package's server: there the rewritten weights' shapes stay unknown to
    the fuse pass past the first island, in both packages alike."""
    import jax

    c = _calibrated(_resnet_nhwc, tmp_path)
    reports = {}
    for name, pkg, sym, table, dev in (
            ("jax", jmx, c["js"], c["jtable"], jax.devices()[:1]),
            ("torch", tmx, c["ts"], c["ttable"], [tmx.cpu()])):
        srv = pkg.serving.InferenceServer(
            sym, c["args"], c["auxs"],
            data_shapes=[("data", (1,) + c["shape"][1:])], devices=dev,
            config=pkg.serving.ServingConfig(buckets=(1, 2)),
            quantize=table, start=False)
        try:
            reports[name] = srv.get_stats()["graph_pass"]
        finally:
            srv.stop()
    assert reports["torch"]["fuse"] == reports["jax"]["fuse"]
    assert reports["torch"]["quantize"] == reports["jax"]["quantize"]
    regions = reports["torch"]["fuse"]["regions"]
    assert len(regions) >= 1 and regions[0]["base"].endswith("_int")
