"""VGG 11/13/16/19, with and without batch norm (Simonyan & Zisserman 2014).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py`` (the same
children in the same order, so parameter names and counts match and
``convert.gluon_params_from_jax`` carries weights across).

Same factory surface as the reference zoo; the conv trunk is produced by a
stage generator over the (convs-per-stage, width) table and the classifier
head is shared.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....base import MXNetError
from ....initializer import Xavier

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]

_CONV_INIT = dict(rnd_type="gaussian", factor_type="out", magnitude=2)

# depth -> convs per stage (width schedule is fixed)
_STAGE_TABLE = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
_WIDTHS = (64, 128, 256, 512, 512)
vgg_spec = {d: (list(c), list(_WIDTHS)) for d, c in _STAGE_TABLE.items()}


class VGG(HybridBlock):
    """Stacked 3x3 conv stages with max-pool downsampling and an
    fc-4096 x2 classifier."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise ValueError("stage and width tables differ in length")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for count, width in zip(layers, filters):
                for _ in range(count):
                    self.features.add(nn.Conv2D(
                        width, kernel_size=3, padding=1,
                        weight_initializer=Xavier(**_CONV_INIT),
                        bias_initializer="zeros"))
                    if batch_norm:
                        self.features.add(nn.BatchNorm())
                    self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(strides=2))
            for _ in range(2):
                self.features.add(nn.Dense(4096, activation="relu",
                                           weight_initializer="xavier"))
                self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="xavier")

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, **kwargs):
    """Build a VGG of the requested depth (11/13/16/19)."""
    if pretrained:
        raise MXNetError("pretrained weights need a download, which is not "
                         "available offline")
    counts, widths = vgg_spec[num_layers]
    return VGG(counts, widths, **kwargs)


def _plain(depth):
    def make(**kwargs):
        return get_vgg(depth, **kwargs)
    make.__name__ = "vgg%d" % depth
    make.__doc__ = "VGG-%d without batch norm." % depth
    return make


def _batchnormed(depth):
    def make(**kwargs):
        kwargs["batch_norm"] = True
        return get_vgg(depth, **kwargs)
    make.__name__ = "vgg%d_bn" % depth
    make.__doc__ = "VGG-%d with batch norm after every conv." % depth
    return make


for _d in _STAGE_TABLE:
    globals()["vgg%d" % _d] = _plain(_d)
    globals()["vgg%d_bn" % _d] = _batchnormed(_d)
del _d
