"""MobileNet v1 (Howard et al. 2017) for the model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py`` (the same
children in the same order, so parameter names and counts match and
``convert.gluon_params_from_jax`` carries weights across).

Same factory surface as the reference zoo. The body is a table of
depthwise-separable stages: each row is (input width, output width, stride)
before the width multiplier is applied.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....base import MXNetError

__all__ = ["MobileNet", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "get_mobilenet"]

# (depthwise width, pointwise-out width, stride) for the 13 separable stages
_STAGES = (
    (32, 64, 1),
    (64, 128, 2),
    (128, 128, 1),
    (128, 256, 2),
    (256, 256, 1),
    (256, 512, 2),
    (512, 512, 1),
    (512, 512, 1),
    (512, 512, 1),
    (512, 512, 1),
    (512, 512, 1),
    (512, 1024, 2),
    (1024, 1024, 1),
)


def _conv_bn_relu(seq, channels, **conv_kw):
    conv_kw.setdefault("kernel_size", 1)
    seq.add(nn.Conv2D(channels, use_bias=False, **conv_kw))
    seq.add(nn.BatchNorm(scale=True))
    seq.add(nn.Activation("relu"))


def _separable(seq, dw, pw, stride):
    """Depthwise 3x3 followed by pointwise 1x1, both BN+ReLU."""
    _conv_bn_relu(seq, dw, kernel_size=3, strides=stride, padding=1,
                  groups=dw)
    _conv_bn_relu(seq, pw)


class MobileNet(HybridBlock):
    """Depthwise-separable CNN with a width ``multiplier``."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        scale = lambda w: int(w * multiplier)  # noqa: E731
        with self.name_scope():
            trunk = nn.HybridSequential(prefix="")
            with trunk.name_scope():
                _conv_bn_relu(trunk, scale(32), kernel_size=3, strides=2,
                              padding=1)
                for dw, pw, stride in _STAGES:
                    _separable(trunk, scale(dw), scale(pw), stride)
                for tail in (nn.GlobalAvgPool2D(), nn.Flatten()):
                    trunk.add(tail)
            self.features = trunk
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, **kwargs):
    """Build a MobileNet at the given width multiplier."""
    if pretrained:
        raise MXNetError("pretrained weights need a download, which is not "
                         "available offline")
    return MobileNet(multiplier, **kwargs)


def _factory(multiplier, suffix):
    def make(**kwargs):
        return get_mobilenet(multiplier, **kwargs)
    make.__name__ = "mobilenet" + suffix
    make.__doc__ = "MobileNet with width multiplier %s." % multiplier
    return make


for _m, _s in ((1.0, "1_0"), (0.75, "0_75"), (0.5, "0_5"), (0.25, "0_25")):
    globals()["mobilenet" + _s] = _factory(_m, _s)
del _m, _s
