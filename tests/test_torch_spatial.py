"""Port parity for the spatial-transformer ops of
``mxnet_tpu_torch/ops/spatial.py``: GridGenerator (affine and warp),
BilinearSampler, SpatialTransformer, UpSampling (nearest with ``concat`` /
``sum`` and several inputs, bilinear through its weight input) and
SVMOutput (its injected L1 / L2 hinge gradient), against the JAX
package's ops on the same seeded numpy inputs on the CPU.

Each case runs the op in both packages under ``autograd.record()`` with
the float inputs attached, then backward with the same seeded head
gradient: outputs and input gradients within 1e-5 of each tensor's max.
The cases are ``tests/test_linalg_spatial.py``'s spatial ones, at their
shapes, and the same ops at seeded random inputs (fractional grids that
reach past the border, flow, several scales).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= TOL * (scale if scale > 0 else 1.0), \
        "%s: %.3g against max %.3g" % (what, err, scale)


def _run(mx, op, arrays, grad, attrs, seed=7):
    ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
    ins = [mx.nd.array(a, **ctx) for a in arrays]
    for i in grad:
        ins[i].attach_grad()
    with mx.autograd.record():
        out = getattr(mx.nd, op)(*ins, **attrs)
    value = out.asnumpy()
    rng = np.random.RandomState(seed)
    out.backward(mx.nd.array(rng.randn(*value.shape).astype(np.float32),
                             **ctx))
    return value, [ins[i].grad.asnumpy() for i in grad]


def _identity(n):
    return np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (n, 1))


def _theta(seed, n):
    r = np.random.RandomState(seed)
    return (_identity(n) + r.randn(n, 6).astype(np.float32) * 0.3)


def _bilinear_weight(c, scale):
    """test_linalg_spatial.py's bilinear filter."""
    k = 2 * scale - scale % 2
    f = np.ceil(k / 2.0)
    cc = (2 * f - 1 - f % 2) / (2.0 * f)
    og = np.ogrid[:k, :k]
    filt = (1 - abs(og[0] / f - cc)) * (1 - abs(og[1] / f - cc))
    w = np.zeros((c, 1, k, k), np.float32)
    w[:, 0] = filt
    return w


def _rs(seed):
    return np.random.RandomState(seed)


CASES = [
    # test_grid_generator_bilinear_sampler
    pytest.param("GridGenerator", lambda: [_identity(2)], (0,),
                 dict(transform_type="affine", target_shape=(5, 7)),
                 id="grid-affine-identity"),
    pytest.param("GridGenerator", lambda: [_theta(1, 3)], (0,),
                 dict(transform_type="affine", target_shape=(4, 9)),
                 id="grid-affine"),
    pytest.param("GridGenerator",
                 lambda: [np.stack([np.ones((2, 5, 7)),
                                    np.zeros((2, 5, 7))], 1)
                          .astype(np.float32)], (0,),
                 dict(transform_type="warp"), id="grid-warp-shift"),
    pytest.param("GridGenerator",
                 lambda: [_rs(2).randn(2, 2, 6, 5).astype(np.float32) * 2],
                 (0,), dict(transform_type="warp"), id="grid-warp"),
    pytest.param("BilinearSampler",
                 lambda: [_rs(5).randn(2, 3, 5, 7).astype(np.float32),
                          np.asarray(tmx.nd.GridGenerator(
                              tmx.nd.array(_identity(2), ctx=tmx.cpu()),
                              transform_type="affine",
                              target_shape=(5, 7)).asnumpy())],
                 (0, 1), {}, id="sampler-identity"),
    pytest.param("BilinearSampler",
                 lambda: [_rs(3).randn(2, 3, 6, 8).astype(np.float32),
                          _rs(4).uniform(-1.3, 1.3, (2, 2, 5, 4))
                          .astype(np.float32)],
                 (0, 1), {}, id="sampler-random"),
    # test_spatial_transformer
    pytest.param("SpatialTransformer",
                 lambda: [_rs(6).randn(2, 3, 6, 6).astype(np.float32),
                          _identity(2)], (0, 1),
                 dict(target_shape=(6, 6), transform_type="affine",
                      sampler_type="bilinear"), id="transformer-identity"),
    pytest.param("SpatialTransformer",
                 lambda: [_rs(7).randn(3, 2, 7, 5).astype(np.float32),
                          _theta(8, 3)], (0, 1),
                 dict(target_shape=(4, 6), transform_type="affine",
                      sampler_type="bilinear"), id="transformer"),
    # test_upsampling
    pytest.param("UpSampling",
                 lambda: [np.arange(8).reshape(1, 2, 2, 2)
                          .astype(np.float32)], (0,),
                 dict(scale=2, sample_type="nearest"), id="nearest"),
    pytest.param("UpSampling",
                 lambda: [np.ones((1, 1, 4, 4), np.float32),
                          np.ones((1, 1, 2, 2), np.float32) * 2], (0, 1),
                 dict(scale=2, sample_type="nearest", num_args=2),
                 id="nearest-concat"),
    pytest.param("UpSampling",
                 lambda: [_rs(9).randn(2, 3, 6, 6).astype(np.float32),
                          _rs(10).randn(2, 3, 3, 3).astype(np.float32),
                          _rs(11).randn(2, 3, 2, 2).astype(np.float32)],
                 (0, 1, 2),
                 dict(scale=2, sample_type="nearest", num_args=3,
                      multi_input_mode="sum"), id="nearest-sum"),
    pytest.param("UpSampling",
                 lambda: [np.ones((1, 3, 4, 4), np.float32),
                          _bilinear_weight(3, 2)], (0, 1),
                 dict(scale=2, sample_type="bilinear", num_filter=3,
                      num_args=2), id="bilinear-constant"),
    pytest.param("UpSampling",
                 lambda: [_rs(12).randn(2, 2, 5, 3).astype(np.float32),
                          _bilinear_weight(2, 3)], (0, 1),
                 dict(scale=3, sample_type="bilinear", num_filter=2,
                      num_args=2), id="bilinear-scale3"),
    pytest.param("UpSampling",
                 lambda: [_rs(13).randn(1, 4, 3, 4).astype(np.float32),
                          _rs(14).randn(4, 1, 4, 4).astype(np.float32)],
                 (0, 1),
                 dict(scale=2, sample_type="bilinear", num_filter=4,
                      num_args=2), id="bilinear-learned"),
    # test_svm_output
    pytest.param("SVMOutput",
                 lambda: [np.array([[2.0, -2.0, 0.5]], np.float32),
                          np.array([0.0], np.float32)], (0,),
                 dict(margin=1.0), id="svm-l2"),
    pytest.param("SVMOutput",
                 lambda: [np.array([[0.5, -0.5]], np.float32),
                          np.array([0.0], np.float32)], (0,),
                 dict(margin=1.0, use_linear=True,
                      regularization_coefficient=0.5), id="svm-l1"),
    pytest.param("SVMOutput",
                 lambda: [_rs(15).randn(5, 4).astype(np.float32),
                          np.array([0, 3, 1, 2, 7], np.float32)], (0, 1),
                 dict(margin=0.7, regularization_coefficient=0.3),
                 id="svm-l2-random"),
    pytest.param("SVMOutput",
                 lambda: [_rs(16).randn(4, 3, 5).astype(np.float32),
                          _rs(17).randint(0, 5, (4, 3)).astype(np.float32)],
                 (0,), dict(margin=0.5, use_linear=True),
                 id="svm-l1-3d"),
]


@pytest.mark.parametrize("op,make,grad,attrs", CASES)
def test_spatial_op_matches_the_jax_op(op, make, grad, attrs):
    arrays = make()
    want, want_g = _run(jmx, op, arrays, grad, attrs)
    with tmx.cpu():
        got, got_g = _run(tmx, op, arrays, grad, attrs)
    _close(got, want, op)
    for i, g, w in zip(grad, got_g, want_g):
        _close(g, w, "%s d input %d" % (op, i))


@pytest.mark.parametrize("op,kwargs,shapes", [
    ("GridGenerator", dict(transform_type="affine", target_shape=(5, 7)),
     dict(data=(2, 6))),
    ("GridGenerator", dict(transform_type="warp"), dict(data=(2, 2, 4, 5))),
    ("BilinearSampler", {}, dict(data=(2, 3, 6, 6), grid=(2, 2, 4, 5))),
    ("SpatialTransformer", dict(target_shape=(4, 4), transform_type="affine",
                                sampler_type="bilinear"),
     dict(data=(2, 3, 6, 6))),
    ("UpSampling", dict(scale=2, sample_type="bilinear", num_filter=3),
     dict(data=(1, 3, 4, 4))),
    ("SVMOutput", {}, dict(data=(5, 4))),
])
def test_spatial_shape_inference_matches(op, kwargs, shapes):
    res = []
    for mx in (jmx, tmx):
        inputs = [mx.sym.Variable(n) for n in shapes] \
            if op == "BilinearSampler" else [mx.sym.Variable("data")]
        sym = getattr(mx.sym, op)(*inputs, **kwargs)
        res.append((sym.list_arguments(), sym.infer_shape(**shapes)))
    assert res[0] == res[1]


def test_spatial_transformer_rejects_nothing_but_affine():
    for mx in (jmx, tmx):
        with pytest.raises(mx.MXNetError):
            mx.sym.SpatialTransformer(mx.sym.Variable("data"),
                                      mx.sym.Variable("loc"),
                                      target_shape=(4, 4),
                                      transform_type="warp")
