"""SSD detection model symbols (reference: example/ssd/symbol/
symbol_builder.py get_symbol_train/get_symbol + common.py multibox_layer).

Counterpart of ``mxnet_tpu/models/ssd.py``. The training symbol groups
[cls_prob, loc_loss, cls_label, det] exactly like the reference; every op
in the graph is fixed-shape and reads nothing back to the host, so a
training walk enqueues the whole step before anything waits on it.
"""
from __future__ import annotations

from .. import symbol as sym


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
              stride=(1, 1), dilate=(1, 1)):
    out = sym.Convolution(data=data, kernel=kernel, pad=pad, stride=stride,
                          dilate=dilate, num_filter=num_filter, name=name)
    return sym.Activation(data=out, act_type="relu", name=name + "_relu")


def _multibox_layer(layers, num_classes, sizes, ratios, steps=None,
                    clip=False):
    """Per-scale loc/cls heads + priors, concatenated (reference:
    example/ssd/symbol/common.py:236-301 multibox_layer)."""
    loc_layers, cls_layers, anchor_layers = [], [], []
    num_classes += 1  # background
    for i, from_layer in enumerate(layers):
        s = sizes[i]
        r = ratios[i]
        num_anchors = len(s) - 1 + len(r)
        name = "multibox%d" % i

        loc = sym.Convolution(data=from_layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * 4,
                              name=name + "_loc_pred_conv")
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc = sym.Flatten(data=loc)
        loc_layers.append(loc)

        cls = sym.Convolution(data=from_layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * num_classes,
                              name=name + "_cls_pred_conv")
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls = sym.Flatten(data=cls)
        cls_layers.append(cls)

        kw = {}
        if steps:
            kw["steps"] = (steps[i], steps[i])
        anchors = sym.contrib.MultiBoxPrior(from_layer, sizes=tuple(s),
                                            ratios=tuple(r), clip=clip,
                                            name=name + "_anchors", **kw)
        anchor_layers.append(sym.Flatten(data=anchors))

    loc_preds = sym.Concat(*loc_layers, dim=1, name="multibox_loc_pred")
    cls_preds = sym.Concat(*cls_layers, dim=1)
    cls_preds = sym.Reshape(data=cls_preds, shape=(0, -1, num_classes))
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1),
                              name="multibox_cls_pred")
    anchors = sym.Concat(*anchor_layers, dim=1)
    anchors = sym.Reshape(data=anchors, shape=(0, -1, 4),
                          name="multibox_anchors")
    return loc_preds, cls_preds, anchors


def _vgg_reduced_features(data):
    """VGG16-reduced backbone + SSD extra layers → 6 feature scales
    (reference: example/ssd/symbol/vgg16_reduced.py + common.py
    multi_layer_feature)."""
    x = data
    cfg = [(2, 64), (2, 128), (3, 256), (3, 512)]
    feats = []
    for bi, (reps, nf) in enumerate(cfg):
        for ri in range(reps):
            x = _conv_act(x, "conv%d_%d" % (bi + 1, ri + 1), nf)
        if bi == 3:
            feats.append(x)   # relu4_3 scale (38x38 at 300 input)
        # ceil-mode pooling keeps the reference's 300→38 pyramid
        # (vgg16_reduced.py pooling_convention='full')
        x = sym.Pooling(data=x, pool_type="max", kernel=(2, 2),
                        stride=(2, 2), pooling_convention="full",
                        name="pool%d" % (bi + 1))
    for ri in range(3):
        x = _conv_act(x, "conv5_%d" % (ri + 1), 512)
    x = sym.Pooling(data=x, pool_type="max", kernel=(3, 3), stride=(1, 1),
                    pad=(1, 1), name="pool5")
    x = _conv_act(x, "fc6", 1024, kernel=(3, 3), pad=(6, 6),
                  dilate=(6, 6))
    x = _conv_act(x, "fc7", 1024, kernel=(1, 1), pad=(0, 0))
    feats.append(x)           # 19x19
    specs = [(256, 512, 2, (1, 1)), (128, 256, 2, (1, 1)),
             (128, 256, 1, (0, 0)), (128, 256, 1, (0, 0))]
    for i, (nf1, nf2, stride, pad) in enumerate(specs):
        x = _conv_act(x, "extra%d_1" % i, nf1, kernel=(1, 1), pad=(0, 0))
        x = _conv_act(x, "extra%d_2" % i, nf2, kernel=(3, 3), pad=pad,
                      stride=(stride, stride))
        feats.append(x)       # 10x10, 5x5, 3x3, 1x1
    return feats


SSD300_SIZES = [[0.1, 0.141], [0.2, 0.272], [0.37, 0.447], [0.54, 0.619],
                [0.71, 0.79], [0.88, 0.961]]
SSD300_RATIOS = [[1, 2, 0.5], [1, 2, 0.5, 3, 1.0 / 3], [1, 2, 0.5, 3, 1.0 / 3],
                 [1, 2, 0.5, 3, 1.0 / 3], [1, 2, 0.5], [1, 2, 0.5]]


def get_ssd(num_classes=20, mode="train", features=None, sizes=None,
            ratios=None, nms_thresh=0.5, force_suppress=False, nms_topk=400):
    """SSD-300 symbol (train or inference mode).

    ``features``: optional callable data→list-of-feature-symbols to swap
    the backbone (tests use a tiny one); defaults to VGG16-reduced.
    """
    data = sym.Variable("data")
    label = sym.Variable("label")
    feats = (features or _vgg_reduced_features)(data)
    sizes = sizes or SSD300_SIZES[:len(feats)]
    ratios = ratios or SSD300_RATIOS[:len(feats)]
    loc_preds, cls_preds, anchors = _multibox_layer(
        feats, num_classes, sizes, ratios)

    if mode != "train":
        cls_prob = sym.SoftmaxActivation(data=cls_preds, mode="channel",
                                         name="cls_prob")
        return sym.contrib.MultiBoxDetection(
            cls_prob, loc_preds, anchors, name="detection",
            nms_threshold=nms_thresh, force_suppress=force_suppress,
            variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)

    tmp = sym.contrib.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3,
        minimum_negative_samples=0, negative_mining_thresh=0.5,
        variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]

    cls_prob = sym.SoftmaxOutput(
        data=cls_preds, label=cls_target, ignore_label=-1, use_ignore=True,
        grad_scale=1.0, multi_output=True, normalization="valid",
        name="cls_prob")
    loc_loss_ = sym.smooth_l1(
        data=loc_target_mask * (loc_preds - loc_target), scalar=1.0,
        name="loc_loss_")
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1.0,
                            normalization="valid", name="loc_loss")
    cls_label = sym.MakeLoss(data=cls_target, grad_scale=0.0,
                             name="cls_label")
    det = sym.contrib.MultiBoxDetection(
        cls_prob, loc_preds, anchors, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)
    det = sym.MakeLoss(data=det, grad_scale=0.0, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


def tiny_features(data):
    """Two-scale toy backbone for fast detection tests."""
    x = _conv_act(data, "tc1", 8)
    x = sym.Pooling(data=x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    x = _conv_act(x, "tc2", 16)
    f1 = x
    x = sym.Pooling(data=x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    f2 = _conv_act(x, "tc3", 16)
    return [f1, f2]
