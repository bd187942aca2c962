"""Port parity of the graph-pass layer at full ResNet-50 width (no
compute): the port's pass reports equal the JAX package's, and its
symbol frontend reads the JAX package's JSON. Kernel-form regions are
counted by running the optimized graph on ``meta`` tensors (shapes only)
with the kernel wrapper stubbed.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import graph_pass as jgp
from mxnet_tpu_torch import graph_pass as tgp
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import _GraphProgram
from mxnet_tpu_torch.parallel import fused as tfused

_SHAPES = {"NHWC": (1, 224, 224, 3), "NCHW": (1, 3, 224, 224)}


def _resnet50(layout):
    with jmx.name.NameManager():
        js = jmx.models.get_resnet(num_layers=50, layout=layout)
    with tmx.NameManager():
        ts = tmx.models.get_resnet(num_layers=50, layout=layout)
    return js, ts


def _optimize(gp, sym, layout):
    frozen = [a for a in sym.list_arguments()
              if a not in ("data", "softmax_label")] + \
        sym.list_auxiliary_states()
    return gp.optimize(sym, for_training=False, frozen=frozen,
                       arg_shapes={"data": _SHAPES[layout]})


def _reports(opt):
    out = []
    for rep in opt.reports:
        rep = dict(rep)
        rep.pop("wall_ms")
        out.append(rep)
    return out


def _kernel_form_count(opt, layout, monkeypatch):
    """fused_matmul calls in one forward of the optimized graph."""
    calls = []

    def stub(x, w, extras=(), epilogue=(), wt=True, out_dtype=None):
        calls.append(tuple(x.shape))
        n = w.shape[0] if wt else w.shape[1]
        return torch.empty((x.shape[0], n), device="meta")

    monkeypatch.setattr(tfused, "fused_matmul", stub)
    sym = opt.symbol
    arg_shapes, out_shapes, aux_shapes = sym.infer_shape(
        data=_SHAPES[layout])
    args = {n: torch.empty(s, device="meta")
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: torch.empty(s, device="meta")
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    (out,) = _GraphProgram(sym).infer_fn()(args, aux)
    assert tuple(out.shape) == tuple(out_shapes[0]) == (1, 1000)
    return len(calls)


@pytest.mark.parametrize("layout,kernel_regions", [("NHWC", 32),
                                                   ("NCHW", 0)])
def test_resnet50_pass_reports_match(layout, kernel_regions, monkeypatch):
    js, ts = _resnet50(layout)
    assert js.tojson() == ts.tojson()
    jopt, topt = _optimize(jgp, js, layout), _optimize(tgp, ts, layout)
    assert _reports(topt) == _reports(jopt)
    assert topt.symbol.tojson() == jopt.symbol.tojson()
    assert [n for n, _e, _d in topt.fold_exprs] == \
        [n for n, _e, _d in jopt.fold_exprs]
    by_pass = {r["pass"]: r for r in _reports(topt)}
    assert by_pass["bn_fold"]["rewrites"] == 33
    fuse = by_pass["fuse"]["detail"]
    assert len(fuse["regions"]) == 49
    ops = [tuple(r["ops"]) for r in fuse["regions"]]
    assert ops.count(("Convolution", "Activation")) == 33
    assert ops.count(("Convolution", "broadcast_add")) == 16
    assert sorted(fuse["rejected"].values()) == \
        ["claimed_consumer"] * 4 + ["op:softmax"]
    assert _kernel_form_count(topt, layout, monkeypatch) == kernel_regions


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_jax_json_loads_in_port(layout):
    js, _ = _resnet50(layout)
    ts = tmx.sym.load_json(js.tojson())
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert ts.list_outputs() == js.list_outputs()
    shape = _SHAPES[layout]
    assert ts.infer_shape(data=shape) == js.infer_shape(data=shape)
    jt = [np.dtype(t) for part in js.infer_type(data="float32")
          for t in part]
    tt = [np.dtype(t) for part in ts.infer_type(data="float32")
          for t in part]
    assert tt == jt


def test_pass_grammar():
    cfg = tgp.PassConfig(spec="default,-fuse")
    assert cfg.passes == frozenset({"prune", "bn_fold", "layout", "fold"})
    assert not tgp.PassConfig(spec="off").enabled
    assert tgp.PassConfig(spec="layout=NHWC").layout_force == "NHWC"
    assert "amp" in tgp.PassConfig(spec="default,amp").passes
    assert tgp.PassConfig(spec="amp=float16").amp_dtype == "float16"
    for spec in ("quantize=table.json", "all"):
        assert tgp.PassConfig(spec=spec).passes == \
            jgp.PassConfig(spec=spec).passes
    assert tgp.PassConfig(spec="quantize=Table.json").quant_table == \
        "Table.json"
    with pytest.raises(MXNetError, match="unknown pass"):
        tgp.PassConfig(spec="nope")


def test_forced_layout_rewrite_matches():
    """``layout=NCHW`` on the NHWC graph: the transpose sink/cancel
    rewrite gives the same report and graph in both packages."""
    js, ts = _resnet50("NHWC")
    jopt = jgp.optimize(js, arg_shapes={"data": _SHAPES["NHWC"]},
                        config=jgp.PassConfig(spec="layout=NCHW"))
    topt = tgp.optimize(ts, arg_shapes={"data": _SHAPES["NHWC"]},
                        config=tgp.PassConfig(spec="layout=NCHW"))
    assert _reports(topt)[0]["rewrites"] > 0
    assert _reports(topt) == _reports(jopt)
    assert topt.symbol.tojson() == jopt.symbol.tojson()
