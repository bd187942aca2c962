"""Port parity for the detection ops and SSD: every op of
``mxnet_tpu_torch/ops/detection.py`` against the JAX package's op on the
same seeded numpy inputs, forward and gradient, on the CPU.

Each case runs the op in both packages (``mx.nd.contrib`` / ``mx.nd``)
under ``autograd.record()`` with the float inputs attached, then backward
with the same seeded head gradients. Exact equality: the anchors, the
targets' ``cls_target`` and ``loc_target_mask``, the detections' ids and
their row order, Proposal's scores (input values copied into the rows, so
equal scores are the same rows in the same order) and batch column.
Everything else (values and gradients) within 1e-5 of each tensor's max.
The cases are ``tests/test_detection.py``'s and, added: tied background
probabilities under mining, equal detection scores, ``force_suppress`` and
``nms_topk``, a ROIPooling bin whose maximum is tied over two columns (the
gradient split), and Proposal with more ``post`` slots than survivors.
Then SSD-300's shapes and one training step of the tiny SSD through both
packages' executors from the same parameters.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models.ssd import get_ssd as jax_get_ssd
from mxnet_tpu.models.ssd import tiny_features as jax_tiny_features
from mxnet_tpu_torch.models.ssd import get_ssd, tiny_features

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per case: the cases are small, and beside other
    test workers torch's thread pool costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what="", tol=TOL):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) \
        if want.size else 0.0
    assert err <= tol * (scale if scale > 0 else 1.0), \
        "%s: %.3g against max %.3g" % (what, err, scale)


def _equal(got, want, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _f32(want):
    """The JAX MultiBoxDetection's rows, float64 there: its invalid-row
    fill is a float64 literal under the package's jax_enable_x64, and
    promotes the rows. Every value is a float32 one."""
    assert want.dtype == np.float64
    assert np.array_equal(want.astype(np.float32).astype(np.float64), want)
    return want.astype(np.float32)


def _op(mx, name):
    fn = mx.nd
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def _run(mx, name, arrays, grad, attrs, seed=7):
    """(outputs, gradients of the inputs in ``grad``) as numpy, one
    recorded call and a backward with seeded heads. Outputs that the port
    does not record (ids, masks) take no part in its backward: their JAX
    gradients are zero."""
    ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
    ins = [mx.nd.array(a, **ctx) for a in arrays]
    for i in grad:
        ins[i].attach_grad()
    with mx.autograd.record():
        out = _op(mx, name)(*ins, **attrs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    values = [o.asnumpy() for o in outs]
    if not grad:
        return values, []
    rng = np.random.RandomState(seed)
    heads = [mx.nd.array(rng.randn(*v.shape).astype(np.float32)
                         .astype(v.dtype), **ctx) for v in values]
    live = [(o, h) for o, h in zip(outs, heads)
            if mx is jmx or o._data.requires_grad]
    if live:
        mx.autograd.backward([o for o, _ in live], [h for _, h in live])
    return values, [ins[i].grad.asnumpy() for i in grad]


def _both(name, arrays, grad=(), **attrs):
    want = _run(jmx, name, arrays, grad, attrs)
    with tmx.cpu():
        got = _run(tmx, name, arrays, grad, attrs)
    return got, want


def _check_grads(got, want, grad):
    for i, g, w in zip(grad, got[1], want[1]):
        _close(g, w, "d input %d" % i)


# --- MultiBoxPrior ----------------------------------------------------------

# the six SSD-300 feature maps with their sizes and ratios, and the cases of
# test_multibox_prior_values
PRIOR_CASES = [
    ((1, 8, 2, 3), dict(sizes=(0.5,), ratios=(1.0,))),
    ((1, 8, 2, 3), dict(sizes=(0.5, 0.3), ratios=(1.0, 2.0, 0.5))),
    ((1, 8, 2, 3), dict(sizes=(1.5,), clip=True)),
    ((2, 4, 5, 7), dict(sizes=(0.2, 0.4), ratios=(1.0, 3.0),
                        steps=(0.1, 0.2), offsets=(0.3, 0.6))),
    ((1, 512, 38, 38), dict(sizes=(0.1, 0.141), ratios=(1, 2, 0.5))),
    ((1, 1024, 19, 19), dict(sizes=(0.2, 0.272),
                             ratios=(1, 2, 0.5, 3, 1.0 / 3))),
    ((1, 512, 10, 10), dict(sizes=(0.37, 0.447),
                            ratios=(1, 2, 0.5, 3, 1.0 / 3))),
    ((1, 256, 5, 5), dict(sizes=(0.54, 0.619),
                          ratios=(1, 2, 0.5, 3, 1.0 / 3))),
    ((1, 256, 3, 3), dict(sizes=(0.71, 0.79), ratios=(1, 2, 0.5))),
    ((1, 256, 1, 1), dict(sizes=(0.88, 0.961), ratios=(1, 2, 0.5),
                          clip=True)),
]


@pytest.mark.parametrize("shape,attrs", PRIOR_CASES)
def test_multibox_prior_anchors_equal(shape, attrs):
    x = np.zeros(shape, np.float32)
    got, want = _both("contrib.MultiBoxPrior", [x], **attrs)
    _equal(got[0][0], want[0][0], "anchors")
    assert got[0][0].dtype == want[0][0].dtype


# --- MultiBoxTarget ---------------------------------------------------------

def _target_case_matching():
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]]],
                       np.float32)
    label = np.array([[[1.0, 0.1, 0.1, 0.45, 0.52]]], np.float32)
    return [anchors, label, np.zeros((1, 3, 2), np.float32)], dict(
        overlap_threshold=0.5, negative_mining_ratio=-1.0,
        variances=(0.1, 0.1, 0.2, 0.2))


def _target_case_no_gt():
    anchors = np.random.RandomState(0).rand(1, 6, 4).astype(np.float32)
    return [anchors, np.full((2, 2, 5), -1.0, np.float32),
            np.zeros((2, 4, 6), np.float32)], {}


_MINING_ANCHORS = np.array(
    [[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0], [0.0, 0.5, 0.5, 1.0],
      [0.5, 0.0, 1.0, 0.5], [0.2, 0.2, 0.4, 0.4], [0.6, 0.6, 0.8, 0.8]]],
    np.float32)


def _target_case_mining():
    lab = np.full((1, 2, 5), -1.0, np.float32)
    lab[0, 0] = [0, 0.0, 0.0, 0.5, 0.5]
    cp = np.random.RandomState(1).randn(1, 3, 6).astype(np.float32)
    return [_MINING_ANCHORS, lab, cp], dict(negative_mining_ratio=1.0,
                                            negative_mining_thresh=0.5)


def _target_case_tied_mining():
    # every background probability equal: the stable ranking takes the
    # candidates in anchor order
    lab = np.full((2, 2, 5), -1.0, np.float32)
    lab[:, 0] = [0, 0.0, 0.0, 0.5, 0.5]
    lab[1, 1] = [1, 0.5, 0.5, 1.0, 1.0]
    return [_MINING_ANCHORS, lab, np.zeros((2, 3, 6), np.float32)], dict(
        negative_mining_ratio=1.0, negative_mining_thresh=0.6)


def _random_anchors(rng, n):
    c = rng.uniform(0.1, 0.9, (n, 2))
    half = rng.uniform(0.05, 0.3, (n, 2))
    return np.concatenate([c - half, c + half], 1)[None].astype(np.float32)


def _target_case_random(ratio):
    rng = np.random.RandomState(3)
    anchors = _random_anchors(rng, 40)
    lab = np.full((3, 4, 5), -1.0, np.float32)
    for b, k in enumerate((3, 1, 2)):
        for j in range(k):
            c = rng.uniform(0.2, 0.8, 2)
            half = rng.uniform(0.05, 0.25, 2)
            lab[b, j] = [rng.randint(0, 4), *(c - half), *(c + half)]
    # a valid row after a -1 row is out of the list
    lab[2, 3] = [1, 0.1, 0.1, 0.6, 0.6]
    cp = rng.randn(3, 5, 40).astype(np.float32)
    return [anchors, lab, cp], dict(negative_mining_ratio=ratio,
                                    overlap_threshold=0.4,
                                    minimum_negative_samples=5)


TARGET_CASES = [
    pytest.param(_target_case_matching, id="matching"),
    pytest.param(_target_case_no_gt, id="no-gt"),
    pytest.param(_target_case_mining, id="mining"),
    pytest.param(_target_case_tied_mining, id="tied-mining"),
    pytest.param(lambda: _target_case_random(3.0), id="random-mining"),
    pytest.param(lambda: _target_case_random(-1.0), id="random-no-mining"),
]


@pytest.mark.parametrize("make", TARGET_CASES)
def test_multibox_target_matches(make):
    arrays, attrs = make()
    got, want = _both("contrib.MultiBoxTarget", arrays, grad=(0, 1), **attrs)
    _close(got[0][0], want[0][0], "loc_target")
    _equal(got[0][1], want[0][1], "loc_target_mask")
    _equal(got[0][2], want[0][2], "cls_target")
    _check_grads(got, want, (0, 1))


def test_multibox_target_cases_reach_every_class():
    # the cases above are not degenerate: positives, negatives and ignored
    # anchors all occur, and mining caps the negatives
    with tmx.cpu():
        arrays, attrs = _target_case_random(3.0)
        ct = _run(tmx, "contrib.MultiBoxTarget", arrays, (), attrs)[0][2]
    assert (ct > 0).any() and (ct == 0).any() and (ct == -1).any()
    arrays, attrs = _target_case_tied_mining()
    with tmx.cpu():
        ct = _run(tmx, "contrib.MultiBoxTarget", arrays, (), attrs)[0][2]
    n_pos, n_neg = (ct > 0).sum(1), (ct == 0).sum(1)
    assert (n_neg == n_pos).all() and (ct == -1).any()


# --- MultiBoxDetection ------------------------------------------------------

def _det_case_decode(loc=None, **attrs):
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.12, 0.12, 0.52, 0.52],
                         [0.6, 0.6, 0.9, 0.9]]], np.float32)
    cp = np.zeros((1, 3, 3), np.float32)
    cp[0, 1, 0] = 0.8
    cp[0, 1, 1] = 0.7
    cp[0, 2, 2] = 0.9
    if loc is None:
        loc = np.zeros((1, 12), np.float32)
    return [cp, loc, anchors], dict(dict(nms_threshold=0.5, threshold=0.01,
                                         clip=False), **attrs)


def _det_case_random(seed=4, n=2, classes=4, na=60, equal=False, **attrs):
    rng = np.random.RandomState(seed)
    anchors = _random_anchors(rng, na)
    logits = rng.randn(n, classes, na).astype(np.float32) * 2
    if equal:
        # equal scores: a few values shared by many anchors and classes
        logits = np.round(logits).astype(np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    cp = (e / e.sum(1, keepdims=True)).astype(np.float32)
    loc = (rng.randn(n, na * 4) * 0.5).astype(np.float32)
    return [cp, loc, anchors], attrs


def _loc_shift():
    loc = np.zeros((1, 12), np.float32)
    loc[0, :4] = [1.0, 0.0, 0.0, 0.0]
    return loc


DET_CASES = [
    pytest.param(_det_case_decode, id="decode-nms"),
    pytest.param(lambda: _det_case_decode(_loc_shift(), nms_threshold=-1.0),
                 id="decode-no-nms"),
    pytest.param(lambda: _det_case_random(), id="random"),
    pytest.param(lambda: _det_case_random(clip=False, threshold=0.2),
                 id="random-threshold"),
    pytest.param(lambda: _det_case_random(force_suppress=True),
                 id="force-suppress"),
    pytest.param(lambda: _det_case_random(nms_topk=17, nms_threshold=0.3),
                 id="nms-topk"),
    pytest.param(lambda: _det_case_random(nms_topk=100), id="nms-topk-wide"),
    pytest.param(lambda: _det_case_random(seed=5, equal=True, classes=3),
                 id="equal-scores"),
    pytest.param(lambda: _det_case_random(seed=6, equal=True,
                                          force_suppress=True, nms_topk=30),
                 id="equal-scores-force-topk"),
]


@pytest.mark.parametrize("make", DET_CASES)
def test_multibox_detection_matches(make):
    arrays, attrs = make()
    got, want = _both("contrib.MultiBoxDetection", arrays, grad=(0, 1, 2),
                      **attrs)
    g, w = got[0][0], _f32(want[0][0])
    _equal(g[..., 0], w[..., 0], "ids and order")
    _close(g[..., 1:], w[..., 1:], "scores and boxes")
    _check_grads(got, want, (0, 1, 2))


@pytest.mark.parametrize("op,make", [
    ("contrib.MultiBoxDetection", lambda: _det_case_random()),
    ("contrib.MultiBoxDetection",
     lambda: _det_case_random(seed=6, equal=True, force_suppress=True)),
    ("contrib.Proposal", lambda: PROPOSAL_CASES[0].values[0]()),
    ("contrib.Proposal", lambda: PROPOSAL_CASES[2].values[0]())])
def test_greedy_nms_row_by_row_matches(op, make, monkeypatch):
    """The NMS past its pairwise-matrix size (a row of overlaps per step,
    as for Proposal's default 6000 rows) against the JAX op."""
    from mxnet_tpu_torch.ops import detection

    monkeypatch.setattr(detection, "_NMS_PAIRWISE_MAX", 0)
    arrays, attrs = make()
    got, want = _both(op, arrays, **attrs)
    if op.endswith("Proposal"):
        _equal(got[0][1], want[0][1], "scores (the rows and their order)")
        _close(got[0][0], want[0][0], "rois")
    else:
        w = _f32(want[0][0])
        _equal(got[0][0][..., 0], w[..., 0], "ids and order")
        _close(got[0][0][..., 1:], w[..., 1:], "scores and boxes")


def test_multibox_detection_cases_suppress():
    # NMS, the threshold and nms_topk take rows out in these cases, and the
    # equal-score case has ties among the kept rows
    for make, kw in ((_det_case_random, {}),
                     (_det_case_random, dict(nms_topk=17,
                                             nms_threshold=0.3)),
                     (_det_case_random, dict(seed=5, equal=True,
                                             classes=3))):
        arrays, attrs = make(**kw)
        with tmx.cpu():
            out = _run(tmx, "contrib.MultiBoxDetection", arrays, (),
                       attrs)[0][0]
        kept = out[..., 0] >= 0
        assert kept.any() and (~kept).any()
        if kw.get("nms_topk"):
            assert kept.sum(1).max() <= kw["nms_topk"]
        if kw.get("equal"):
            s = out[0][kept[0], 1]
            assert len(np.unique(s)) < len(s)


def test_multibox_detection_rejects_background_id():
    arrays, _ = _det_case_decode()
    for mx in (jmx, tmx):
        ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
        with pytest.raises(mx.MXNetError):
            mx.nd.contrib.MultiBoxDetection(
                *[mx.nd.array(a, **ctx) for a in arrays], background_id=1)


# --- ROIPooling -------------------------------------------------------------

def _roi_case_ramp():
    x = np.arange(32, dtype=np.float32).reshape(1, 2, 4, 4)
    rois = np.array([[0, 0, 0, 3, 3], [0, 2, 2, 3, 3]], np.float32)
    return [x, rois], dict(pooled_size=(2, 2), spatial_scale=1.0)


def _roi_case_tied():
    # bin (0, 0) of the whole-image roi has its maximum 9 at (1, 0) and at
    # (1, 1): two columns share the gradient
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 1, 0] = x[0, 0, 1, 1] = 9.0
    x[0, 0, 3, 3] = 5.0
    x[0, 0, 2, 2] = x[0, 0, 2, 3] = x[0, 0, 3, 2] = 5.0
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)
    return [x, rois], dict(pooled_size=(2, 2), spatial_scale=1.0)


def _roi_case_random():
    rng = np.random.RandomState(2)
    x = np.round(rng.randn(2, 3, 9, 11) * 2).astype(np.float32)
    rois = np.array([[0, 1, 1, 8, 7], [1, 0, 2, 10, 8], [1, 3, 3, 3, 3],
                     [0, -4, -2, 30, 12], [1, 4.6, 2.4, 9.5, 7.5]],
                    np.float32)
    return [x, rois], dict(pooled_size=(3, 2), spatial_scale=0.9)


@pytest.mark.parametrize("make", [
    pytest.param(_roi_case_ramp, id="ramp"),
    pytest.param(_roi_case_tied, id="tied-columns"),
    pytest.param(_roi_case_random, id="random")])
def test_roi_pooling_matches(make):
    arrays, attrs = make()
    got, want = _both("ROIPooling", arrays, grad=(0,), **attrs)
    _close(got[0][0], want[0][0], "pooled")
    _check_grads(got, want, (0,))


def test_roi_pooling_tied_gradient_is_split():
    arrays, attrs = _roi_case_tied()
    with tmx.cpu():
        x = tmx.nd.array(arrays[0], ctx=tmx.cpu())
        x.attach_grad()
        with tmx.autograd.record():
            y = tmx.nd.ROIPooling(x, tmx.nd.array(arrays[1], ctx=tmx.cpu()),
                                  **attrs)
        y.backward()
        g = x.grad.asnumpy()[0, 0]
    assert g[1, 0] == 0.5 and g[1, 1] == 0.5
    assert g.sum() == 4.0


# --- Proposal ---------------------------------------------------------------

def _proposal_inputs(seed, n, A, H, W, im):
    r = np.random.RandomState(seed)
    cls_prob = r.rand(n, 2 * A, H, W).astype(np.float32)
    bbox = (r.randn(n, 4 * A, H, W) * 0.1).astype(np.float32)
    info = np.array([im] * n, np.float32)
    return [cls_prob, bbox, info]


PROPOSAL_CASES = [
    pytest.param(lambda: (_proposal_inputs(0, 2, 6, 4, 4, [64, 64, 1.0]),
                          dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=8,
                               rpn_min_size=4, scales=(2.0, 4.0),
                               ratios=(0.5, 1.0, 2.0), feature_stride=16,
                               output_score=True)), id="proposal"),
    pytest.param(lambda: (_proposal_inputs(1, 1, 3, 2, 2, [32, 32, 1.0]),
                          dict(rpn_pre_nms_top_n=-1, rpn_post_nms_top_n=50,
                               rpn_min_size=2, scales=(2.0,),
                               ratios=(0.5, 1.0, 2.0), feature_stride=16,
                               output_score=True)), id="post-beyond-kept"),
    pytest.param(lambda: (_proposal_inputs(2, 2, 3, 5, 6, [60, 80, 1.5]),
                          dict(rpn_pre_nms_top_n=60, rpn_post_nms_top_n=20,
                               rpn_min_size=8, scales=(1.0, 2.0, 4.0),
                               ratios=(1.0,), feature_stride=16,
                               threshold=0.5, output_score=True)),
                 id="padded-region"),
    pytest.param(lambda: (_proposal_inputs(3, 1, 6, 4, 4, [64, 64, 1.0]),
                          dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=10,
                               rpn_min_size=4, scales=(2.0, 4.0),
                               ratios=(0.5, 1.0, 2.0), feature_stride=16,
                               iou_loss=True, output_score=True)),
                 id="iou-loss"),
]


@pytest.mark.parametrize("op", ["contrib.Proposal", "contrib.MultiProposal"])
@pytest.mark.parametrize("make", PROPOSAL_CASES)
def test_proposal_matches(make, op):
    arrays, attrs = make()
    got, want = _both(op, arrays, grad=(0, 1), **attrs)
    rois, scores = got[0]
    _equal(scores, want[0][1], "scores (the rows and their order)")
    _equal(rois[:, 0], want[0][0][:, 0], "batch index")
    _close(rois, want[0][0], "rois")
    # no gradient, as the reference's backward
    for g, w in zip(got[1], want[1]):
        _equal(g, np.zeros_like(g), "gradient")
        _equal(w, np.zeros_like(w), "JAX gradient")


def test_proposal_post_beyond_survivors_cycles():
    arrays, attrs = PROPOSAL_CASES[1].values[0]()
    with tmx.cpu():
        rois = _run(tmx, "contrib.Proposal", arrays, (), attrs)[0][0]
    uniq = np.unique(rois[:, 1:], axis=0)
    assert rois.shape == (50, 5) and 1 <= len(uniq) < 12
    # the survivors repeat in their order
    k = len(uniq)
    np.testing.assert_array_equal(rois[:k], rois[k:2 * k])


def test_proposal_shape_inference():
    shapes = []
    for mx in (jmx, tmx):
        sym = mx.sym.contrib.Proposal(
            mx.sym.Variable("cls"), mx.sym.Variable("bbox"),
            mx.sym.Variable("im_info"), rpn_post_nms_top_n=8,
            scales=(2.0, 4.0), ratios=(0.5, 1.0, 2.0), output_score=True)
        shapes.append(sym.infer_shape(cls=(2, 12, 4, 4)))
    assert shapes[0] == shapes[1]


# --- ROIAlign_v2, PSROIPooling ----------------------------------------------

ALIGN_CASES = [
    pytest.param(lambda: ([np.arange(32, dtype=np.float32)
                           .reshape(1, 2, 4, 4),
                           np.array([[0, 0, 0, 3, 3]], np.float32)],
                          dict(pooled_size=(2, 2), spatial_scale=1.0)),
                 id="ramp"),
    pytest.param(lambda: ([np.arange(64, dtype=np.float32)
                           .reshape(2, 2, 4, 4),
                           np.array([[-1, 0, 0, 3, 3], [1, 0, 1, 2, 3]],
                                    np.float32)],
                          dict(pooled_size=(2, 2), spatial_scale=1.0)),
                 id="padded-roi"),
    pytest.param(lambda: ([np.random.RandomState(3).randn(2, 3, 8, 9)
                           .astype(np.float32),
                           np.array([[0, 0.5, 1.2, 6.3, 7.1],
                                     [1, 2.0, 0.0, 8.5, 5.5],
                                     [1, 4.0, 4.0, 4.0, 4.0],
                                     [0, -2.0, -1.0, 12.0, 11.0]],
                                    np.float32)],
                          dict(pooled_size=(3, 2), spatial_scale=0.8)),
                 id="random"),
]


@pytest.mark.parametrize("make", ALIGN_CASES)
def test_roi_align_v2_matches(make):
    arrays, attrs = make()
    got, want = _both("contrib.ROIAlign_v2", arrays, grad=(0,), **attrs)
    _close(got[0][0], want[0][0], "aligned")
    _check_grads(got, want, (0,))


PSROI_CASES = [
    pytest.param(lambda: ([np.random.RandomState(0).rand(1, 8, 6, 6)
                           .astype(np.float32),
                           np.array([[0, 0, 0, 5, 5]], np.float32)],
                          dict(spatial_scale=1.0, output_dim=2,
                               pooled_size=2)), id="test-case"),
    pytest.param(lambda: ([np.random.RandomState(1).randn(2, 18, 10, 12)
                           .astype(np.float32),
                           np.array([[0, 1, 1, 8, 9], [1, 2, 0, 11, 7],
                                     [1, 30, 30, 40, 40]], np.float32)],
                          dict(spatial_scale=0.5, output_dim=2,
                               pooled_size=3)), id="random"),
    pytest.param(lambda: ([np.random.RandomState(2).randn(1, 12, 7, 7)
                           .astype(np.float32),
                           np.array([[0, 0, 0, 6, 6], [0, 2, 1, 5, 6]],
                                    np.float32)],
                          dict(spatial_scale=1.0, output_dim=3,
                               pooled_size=4, group_size=2)),
                 id="group-size"),
]


@pytest.mark.parametrize("make", PSROI_CASES)
def test_psroi_pooling_matches(make):
    arrays, attrs = make()
    got, want = _both("contrib.PSROIPooling", arrays, grad=(0,), **attrs)
    _close(got[0][0], want[0][0], "pooled")
    _check_grads(got, want, (0,))


# --- DeformableConvolution, DeformablePSROIPooling ----------------------------

def _dc_case(seed, n, C, H, W, F, k, offset_scale, **attrs):
    r = np.random.RandomState(seed)
    kh, kw = k
    sh, sw = attrs.get("stride", (1, 1))
    dh, dw = attrs.get("dilate", (1, 1))
    ph, pw = attrs.get("pad", (0, 0))
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dg = attrs.get("num_deformable_group", 1)
    ng = attrs.get("num_group", 1)
    arrays = [r.randn(n, C, H, W).astype(np.float32),
              (r.randn(n, 2 * kh * kw * dg, Ho, Wo) * offset_scale)
              .astype(np.float32),
              r.randn(F, C // ng, kh, kw).astype(np.float32)]
    if not attrs.get("no_bias"):
        arrays.append(r.randn(F).astype(np.float32))
    return arrays, dict(attrs, kernel=k, num_filter=F)


DC_CASES = [
    pytest.param(lambda: _dc_case(0, 2, 4, 6, 6, 3, (3, 3), 0.0),
                 id="zero-offsets"),
    pytest.param(lambda: _dc_case(1, 2, 4, 6, 6, 3, (3, 3), 1.3),
                 id="offsets"),
    pytest.param(lambda: _dc_case(2, 1, 4, 7, 8, 4, (3, 2), 0.8,
                                  stride=(2, 1), pad=(1, 1), dilate=(1, 2),
                                  num_deformable_group=2, num_group=2,
                                  no_bias=True), id="groups-strided"),
]


@pytest.mark.parametrize("make", DC_CASES)
def test_deformable_convolution_matches(make):
    arrays, attrs = make()
    grad = tuple(range(len(arrays)))
    got, want = _both("contrib.DeformableConvolution", arrays, grad=grad,
                      **attrs)
    _close(got[0][0], want[0][0], "output")
    _check_grads(got, want, grad)


@pytest.mark.parametrize("kw", [dict(kernel=(3, 3), layout="NHWC"),
                                dict(kernel=(3,))])
def test_deformable_convolution_rejects_layout_and_kernel(kw):
    for mx in (jmx, tmx):
        sym = mx.sym.contrib.DeformableConvolution(
            mx.sym.Variable("data"), mx.sym.Variable("o"),
            mx.sym.Variable("w"), num_filter=2, no_bias=True, **kw)
        with pytest.raises(mx.MXNetError):
            sym.infer_shape(data=(1, 4, 8, 8))


def _dpsroi_case(no_trans, spp, tstd, ncls=1):
    r = np.random.RandomState(5)
    od, group, p = 2, 2, 3
    data = r.randn(2, od * group * group, 10, 12).astype(np.float32)
    rois = np.array([[0, 1, 1, 8, 9], [1, 2, 0, 11, 7]], np.float32)
    trans = (r.rand(2, 2 * ncls, p, p).astype(np.float32) - 0.5)
    arrays = [data, rois] + ([] if no_trans else [trans])
    return arrays, dict(spatial_scale=0.5, output_dim=od, group_size=group,
                        pooled_size=p, sample_per_part=spp, trans_std=tstd,
                        no_trans=no_trans)


@pytest.mark.parametrize("no_trans,spp,tstd,ncls", [
    (True, 2, 0.0, 1), (False, 2, 0.3, 1), (False, 3, 0.1, 1),
    (False, 2, 0.5, 2)])
def test_deformable_psroi_pooling_matches(no_trans, spp, tstd, ncls):
    arrays, attrs = _dpsroi_case(no_trans, spp, tstd, ncls)
    grad = (0,) if no_trans else (0, 2)
    got, want = _both("contrib.DeformablePSROIPooling", arrays, grad=grad,
                      **attrs)
    _close(got[0][0], want[0][0], "pooled")
    _check_grads(got, want, grad)


# --- the contrib namespaces ----------------------------------------------------

def test_contrib_functions_are_the_registry_ops():
    from mxnet_tpu_torch.ops.registry import OP_REGISTRY

    for name, opdef in OP_REGISTRY.items():
        if not name.startswith("_contrib_"):
            continue
        short = name[len("_contrib_"):]
        for ns in (tmx.nd, tmx.sym):
            assert getattr(ns.contrib, short).__name__ == short
            assert getattr(ns._internal, name).__name__ == opdef.name
    assert OP_REGISTRY["_contrib_MultiProposal"] is \
        OP_REGISTRY["_contrib_Proposal"]


# --- SSD ----------------------------------------------------------------------

def test_ssd300_shapes_match():
    for mx, build in ((jmx, jax_get_ssd), (tmx, get_ssd)):
        net = build(num_classes=20, mode="train")
        args, outs, _ = net.infer_shape(data=(1, 3, 300, 300),
                                        label=(1, 3, 5))
        assert outs[2][1] == 8732, outs
        det = build(num_classes=20, mode="inference")
        _, det_shapes, _ = det.infer_shape(data=(1, 3, 300, 300))
        assert det_shapes == [(1, 8732, 6)]
        if mx is jmx:
            want = (net.list_arguments(), args, outs)
        else:
            assert (net.list_arguments(), args, outs) == want


def _tiny_ssd(build, features):
    return build(num_classes=1, mode="train", features=features,
                 sizes=[[0.3, 0.4], [0.6, 0.8]], ratios=[[1], [1]])


def _toy_batch(rng, bs):
    """test_ssd_toy_convergence's batch: a bright square per image."""
    data = rng.rand(bs, 3, 32, 32).astype(np.float32) * 0.2
    lab = np.zeros((bs, 1, 5), np.float32)
    for i in range(bs):
        cx, cy = rng.uniform(0.3, 0.7, 2)
        x1, y1, x2, y2 = cx - 0.15, cy - 0.15, cx + 0.15, cy + 0.15
        lab[i, 0] = [0, x1, y1, x2, y2]
        data[i, :, int(y1 * 32):int(y2 * 32), int(x1 * 32):int(x2 * 32)] = 1.0
    return data, lab


def test_tiny_ssd_training_step_matches():
    bs = 8
    rng = np.random.RandomState(0)
    jnet = _tiny_ssd(jax_get_ssd, jax_tiny_features)
    jex = jnet.simple_bind(jmx.cpu(), data=(bs, 3, 32, 32), label=(bs, 1, 5),
                           grad_req="write")
    params = {k: (rng.randn(*v.shape) * 0.05).astype(np.float32)
              for k, v in jex.arg_dict.items() if k not in ("data", "label")}
    data, lab = _toy_batch(rng, bs)
    feeds = dict(params, data=data, label=lab)
    for k, v in feeds.items():
        jex.arg_dict[k][:] = v
    jex.forward(is_train=True)
    jex.backward()
    want = [o.asnumpy() for o in jex.outputs]
    want_g = {k: jex.grad_dict[k].asnumpy() for k in params}

    tnet = _tiny_ssd(get_ssd, tiny_features)
    with tmx.cpu():
        tex = tnet.simple_bind(tmx.cpu(), data=(bs, 3, 32, 32),
                               label=(bs, 1, 5), grad_req="write")
        args, _ = tmx.params_from_jax(feeds, device="cpu")
        for k, v in args.items():
            tex.arg_dict[k]._data.copy_(v)
        tex.forward(is_train=True)
        tex.backward()
        got = [o.asnumpy() for o in tex.outputs]
        got_g = {k: tex.grad_dict[k].asnumpy() for k in params}
    names = tnet.list_outputs()
    assert names == jnet.list_outputs() and len(got) == 4
    _close(got[0], want[0], names[0])          # cls_prob
    _close(got[1], want[1], names[1])          # loc_loss
    _equal(got[2], want[2], names[2])          # cls_label
    det = _f32(want[3])
    _equal(got[3][..., 0], det[..., 0], "detection ids and order")
    _close(got[3][..., 1:], det[..., 1:], "detection scores and boxes")
    assert (got[2] > 0).any() and (got[2] == 0).any()
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        _close(got_g[k], want_g[k], "d " + k)
    # the second scale's loc head has no positive anchor in this batch
    assert sum(np.abs(g).max() > 0 for g in got_g.values()) == 12


def test_ssd300_training_regions_match_and_none_takes_the_kernel(
        monkeypatch):
    """The fuse pass on SSD-300's training graph: the JAX package's regions
    (23 convolution + ReLU pairs), none of which has the kernel's form in
    NCHW; counted by a training-graph forward on ``meta`` tensors."""
    from mxnet_tpu import graph_pass as jgp
    from mxnet_tpu_torch import graph_pass as tgp
    from mxnet_tpu_torch.executor import _GraphProgram
    from mxnet_tpu_torch.parallel import fused as tfused

    shapes = {"data": (8, 3, 300, 300), "label": (8, 3, 5)}
    regions = []
    for gp, build in ((jgp, jax_get_ssd), (tgp, get_ssd)):
        opt = gp.optimize(build(num_classes=20, mode="train"),
                          for_training=True, arg_shapes=shapes)
        fuse = {r["pass"]: r for r in opt.reports}["fuse"]["detail"]
        regions.append((fuse["regions"], fuse["rejected"]))
    assert regions[0] == regions[1]
    assert len(regions[1][0]) == 23
    assert all(tuple(r["ops"]) == ("Convolution", "Activation")
               for r in regions[1][0])
    calls = []
    monkeypatch.setattr(tfused, "fused_matmul",
                        lambda *a, **k: calls.append(a))
    sym = opt.symbol
    arg_shapes, out_shapes, _ = sym.infer_shape(**shapes)
    args = {n: torch.empty(s, device="meta")
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    outs = _GraphProgram(sym).infer_fn()(args, {})
    assert [tuple(o.shape) for o in outs] == out_shapes
    assert calls == []
