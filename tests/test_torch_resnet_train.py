"""Port parity: training-mode BatchNorm and ``Module.fit`` of a small
bottleneck ResNet through mxnet_tpu_torch against mxnet_tpu, on the same
numpy inputs and parameters (carried across by ``params_from_jax``).

The network is the served one of ``tests/test_torch_serving.py``: units
[1, 1, 1], filters [16, 32, 64, 128], 32x32 input, 10 classes, batch 4,
in NHWC and NCHW.

Tolerances. One BatchNorm call: 1e-5 of each tensor's max |value| in fp32,
2e-2 with bf16 data (fp32 statistics either way). A training forward of
the network (outputs and every new aux state): 1e-5 of each tensor's max.
Two ``fit`` batches (parameters, aux states and the post-fit outputs):
1e-2 of each tensor's max. A fit through ReLUs behind BatchNorm does not
stay within fp32 rounding of another summation order: the two packages'
batch statistics differ in their last bits (XLA on the CPU sums a channel
in sequence, torch pairwise, 100x nearer the float64 value), a ReLU whose
input lies that near zero opens in one package and not in the other, and
that element's cotangent enters or leaves a whole channel's gradients.
Measured at this size: the port against the JAX package 2.5e-3
(parameters) and 1.4e-3 (outputs); the JAX package's interpreted kernels
against its own reference composition 5.6e-4; the port against itself
with the input scaled by 1 + 1e-5 noise 4.7e-3 and 3.4e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import graph_pass
from mxnet_tpu.config import set_flag
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.ndarray.ndarray import _from_data

BATCH = 4
CLASSES = 10
BN_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
STEP_TOL = 1e-5
FIT_TOL = 1e-2
LAYOUTS = ("NHWC", "NCHW")


def row(layout):
    return (32, 32, 3) if layout == "NHWC" else (3, 32, 32)


def small_resnet(mx, layout):
    """The bottleneck ResNet of tests/test_torch_serving.py in ``layout``."""
    with mx.NameManager() if mx is tmx else mx.name.NameManager():
        return mx.models.resnet.resnet(
            units=[1, 1, 1], num_stages=3, filter_list=[16, 32, 64, 128],
            num_classes=CLASSES, image_shape=(3, 32, 32), bottle_neck=True,
            layout=layout)


def small_params(sym, layout, seed=0):
    """He-scaled conv/FC weights, BN gamma and moving var 1, small random
    beta, biases and moving means; numpy fp32."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1,) + row(layout))
    args, aux = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_weight"):
            fan_in = int(np.prod(shape[:-1] if len(shape) == 4
                                 and layout == "NHWC" else shape[1:]))
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


def small_data(layout, n_batches=1, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH * n_batches, *row(layout)).astype(np.float32)
    y = (np.arange(BATCH * n_batches) % CLASSES).astype(np.float32)
    return x, y


def to_package(mx, args, aux):
    """The numpy parameters as (arg, aux) dicts of host NDArrays of
    ``mx``; the port's through ``params_from_jax``."""
    if mx is tmx:
        return [{k: _from_data(t) for k, t in d.items()}
                for d in tmx.params_from_jax(args, aux, device=tmx.cpu())]
    return [{k: jmx.nd.array(v) for k, v in d.items()} for d in (args, aux)]


def rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(autouse=True)
def _hermetic():
    graph_pass.set_passes(None)
    yield
    graph_pass.set_passes(None)
    set_flag("MXNET_FUSION_INTERPRET", None)


# ------------------------------------------------------------- BatchNorm

BN_MODES = {"train": (True, False), "global_stats": (True, True),
            "inference": (False, False)}


def _jax_batch_norm(kw, is_train, dtype, x, params, head):
    op = jax_get_op("BatchNorm")
    attrs = op.parse_attrs(kw)
    gamma, beta, mmean, mvar = (jnp.asarray(p) for p in params)

    def f(data, g, b):
        outs, new_aux = op.apply(attrs, [data, g, b], [mmean, mvar],
                                 is_train=is_train)
        return outs[0], (outs, new_aux)

    _, vjp, (outs, new_aux) = jax.vjp(
        f, jnp.asarray(x, dtype), gamma, beta, has_aux=True)
    grads = vjp(jnp.asarray(head, dtype))
    return [np.asarray(t, np.float32) for t in
            list(outs) + list(new_aux) + list(grads)]


def _torch_batch_norm(kw, is_train, dtype, x, params, head):
    op = tmx.ops.registry.get_op("BatchNorm")
    attrs = op.parse_attrs(kw)
    data = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    gamma, beta, mmean, mvar = (torch.from_numpy(p) for p in params)
    gamma.requires_grad_()
    beta.requires_grad_()
    outs, new_aux = op.apply(attrs, [data, gamma, beta], [mmean, mvar],
                             is_train=is_train)
    outs[0].backward(torch.from_numpy(head).to(data.dtype))
    # a leaf the output does not reach (gamma under fix_gamma) has no
    # gradient: zero, as the executor reports it
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in (data, gamma, beta)]
    return [t.detach().float().numpy() for t in
            list(outs) + list(new_aux) + grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("output_mean_var", [False, True])
@pytest.mark.parametrize("mode", sorted(BN_MODES))
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_batch_norm_matches_jax(layout, fix_gamma, mode, output_mean_var,
                                dtype):
    """One BatchNorm op call and its gradient: the outputs (with the
    returned mean and var), the new moving statistics, and dx, dgamma and
    dbeta for a random head gradient; fp32 parameters and moving
    statistics beside fp32 or bf16 data."""
    is_train, use_global = BN_MODES[mode]
    axis = -1 if layout == "NHWC" else 1
    shape = (4, 5, 6, 3) if layout == "NHWC" else (4, 3, 5, 6)
    rng = np.random.RandomState(3)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    c = shape[axis]
    params = [(rng.rand(c) + 0.5).astype(np.float32),     # gamma
              rng.randn(c).astype(np.float32),            # beta
              rng.randn(c).astype(np.float32),            # moving mean
              (rng.rand(c) + 0.5).astype(np.float32)]     # moving var
    head = rng.randn(*shape).astype(np.float32)
    kw = {"axis": axis, "eps": 2e-5, "momentum": 0.9,
          "fix_gamma": fix_gamma, "use_global_stats": use_global,
          "output_mean_var": output_mean_var}
    want = _jax_batch_norm(kw, is_train, dtype, x, params, head)
    got = _torch_batch_norm(kw, is_train, dtype, x, params, head)
    names = ["out", "mean", "var"][:3 if output_mean_var else 1] + [
        "moving_mean", "moving_var", "dx", "dgamma", "dbeta"]
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if name == "dgamma" and fix_gamma:
            assert not g.any() and not w.any()
            continue
        assert rel_err(g, w) <= BN_TOL[dtype], (name, rel_err(g, w))
    updated = is_train and not use_global
    for name, before, after in zip(["moving_mean", "moving_var"],
                                   params[2:], got[-5:-3]):
        assert np.array_equal(after, before) != updated, name


# --------------------------------------------------- the small ResNet

def _bound(mx, layout, args, aux, for_training=True):
    sym = small_resnet(mx, layout)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind(data_shapes=[("data", (BATCH,) + row(layout))],
             label_shapes=[("softmax_label", (BATCH,))],
             for_training=for_training)
    pargs, paux = to_package(mx, args, aux)
    mod.init_params(None, arg_params=pargs, aux_params=paux)
    return mod


@pytest.mark.parametrize("layout", LAYOUTS)
def test_training_regions_match_jax(layout):
    """The training bind's fuse regions (names, base op, members) are the
    JAX package's: the three bottlenecks' conv3 + residual add."""
    args, aux = small_params(small_resnet(jmx, layout), layout)
    regions = [_bound(mx, layout, args, aux)._exec_group.execs[0]
               .fused_regions() for mx in (jmx, tmx)]
    assert regions[1] == regions[0]
    assert [r["members"][0] for r in regions[1]] == [
        "stage%d_unit1_conv3" % s for s in (1, 2, 3)]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_training_forward_matches_jax(layout):
    """One training forward from the same parameters: the outputs and
    every moving statistic it writes back."""
    args, aux = small_params(small_resnet(jmx, layout), layout)
    x, y = small_data(layout)
    got = []
    for mx in (jmx, tmx):
        mod = _bound(mx, layout, args, aux)
        mod.forward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                                    label=[mx.nd.array(y, ctx=mx.cpu())]),
                    is_train=True)
        vals = {"output": mod.get_outputs()[0].asnumpy()}
        vals.update({k: v[0].asnumpy() for k, v in zip(
            mod._exec_group.aux_names, mod._exec_group.aux_arrays)})
        got.append(vals)
    jv, tv = got
    assert sorted(tv) == sorted(jv) and len(tv) == 1 + len(aux)
    for k in jv:
        assert rel_err(tv[k], jv[k]) <= STEP_TOL, (k, rel_err(tv[k], jv[k]))
    moved = [k for k in aux if not np.array_equal(tv[k], aux[k])]
    assert sorted(moved) == sorted(aux)


def _fit(mx, layout, args, aux, x, y):
    sym = small_resnet(mx, layout)
    mod = mx.mod.Module(sym, context=mx.cpu())
    pargs, paux = to_package(mx, args, aux)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=BATCH), num_epoch=1,
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params=pargs, aux_params=paux)
    a, b = mod.get_params()
    vals = {k: v.asnumpy() for k, v in a.items()}
    vals.update({k: v.asnumpy() for k, v in b.items()})
    out = mod.predict(mx.io.NDArrayIter(x[:BATCH], y[:BATCH],
                                        batch_size=BATCH)).asnumpy()
    return vals, out


def _jax_fit(layout, args, aux, x, y, spec, interpret=0):
    graph_pass.set_passes(spec)
    set_flag("MXNET_FUSION_INTERPRET", interpret)
    try:
        return _fit(jmx, layout, args, aux, x, y)
    finally:
        set_flag("MXNET_FUSION_INTERPRET", None)
        graph_pass.set_passes(None)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fit_matches_jax(layout, monkeypatch):
    """Two batches of ``Module.fit`` (SGD lr 0.1, momentum 0.9, wd 1e-4):
    the port with its fuse pass on and off against the JAX package's
    reference composition, its fused lowering and its Pallas kernels in
    interpret mode; every parameter and aux state moved, and the post-fit
    predictions."""
    args, aux = small_params(small_resnet(jmx, layout), layout)
    x, y = small_data(layout, n_batches=2)
    refs = [_jax_fit(layout, args, aux, x, y, "default,-fuse"),
            _jax_fit(layout, args, aux, x, y, "default"),
            _jax_fit(layout, args, aux, x, y, "default", interpret=1)]
    ports = [_fit(tmx, layout, args, aux, x, y)]
    monkeypatch.setenv("MXNET_GRAPH_PASSES", "default,-fuse")
    ports.append(_fit(tmx, layout, args, aux, x, y))
    start = dict(args, **aux)
    for vals, out in ports:
        assert sorted(vals) == sorted(start)
        assert all(not np.array_equal(vals[k], start[k]) for k in start)
        for ref_vals, ref_out in refs:
            for k in ref_vals:
                assert rel_err(vals[k], ref_vals[k]) <= FIT_TOL, (
                    k, rel_err(vals[k], ref_vals[k]))
            assert rel_err(out, ref_out) <= FIT_TOL
